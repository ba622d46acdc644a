"""``reduce_nway``'s launch plan and layouts, on the CPU.

The CUDA kernel (``csrc/reduce_nway.cu``) runs only on the card, so what
surrounds it is held here: :func:`reduce_plan`'s rule (the vector width
from the alignment, one block a tile, whatever n and the input's size);
a plain emulation of how the kernel's blocks and threads place their
vectors, which must write every output element exactly once; which
layouts the kernel reads in place (:func:`reads_in_place`) and which
:func:`readable` copies; and the stacked mesh's ``axis_sum`` / ``psum`` /
``pmax`` on expanded, moved and transposed inputs against the JAX bodies
(``jax.lax.psum`` / ``pmax`` under nested ``jax.vmap``), with their
gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import mesh as M
from repro_torch.kernels import reduce_nway as R
from repro_torch.kernels.reduce_nway import readable, reads_in_place, reduce_nway, reduce_plan


@pytest.mark.parametrize("itemsize,vec", [(4, 4), (2, 8)])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_vector_width_from_alignment(itemsize, vec, aligned):
    plan = reduce_plan(2, 4096, itemsize, aligned)
    assert plan.vec == (vec if aligned else 1)


@pytest.mark.parametrize("n", range(1, 21))
def test_launch_takes_one_plan_whatever_n(n):
    """The kernel walks any n in groups of 4 rows, so a launch's plan is
    the same for every n; the layout carries n and the row stride."""
    x = torch.zeros(3, n, 4104, dtype=torch.bfloat16)
    layout, plan = R._launch_args(x, 1)
    assert layout == (3, n, 4104, n * 4104, 4104 if n > 1 else 0)
    assert plan == reduce_plan(3, 4104, 2, x.data_ptr() % 16 == 0)
    assert R._launch_args(x[..., 1:], 1)[1] == reduce_plan(3, 4103, 2, False)


@pytest.mark.parametrize("outer,n,inner,itemsize", [
    (2, 4, 2 * 2048 * 1024, 2),   # 11a's backward sum
    (2, 4, 2 * 1972 * 4096, 2),   # phase 10's psum
    (1, 8, 4096 * 4096, 4),       # the FCL router's (8, 4096^2) f32
    (2, 4, 2 * 1024, 4),          # the loss's pmax
    (1, 16, 1 << 20, 4),          # the barrier
    (3, 5, 4104, 2), (70000, 3, 40, 4), (1, 2, 2 ** 30 + 64, 2), (7, 1, 1, 4)])
def test_plan_gives_one_block_a_tile(outer, n, inner, itemsize):
    plan = reduce_plan(outer, inner, itemsize, True)
    tile = R.THREADS * plan.vec
    assert plan.blocks == outer * -(-inner // tile)
    assert (plan.blocks - 1) // outer * tile < inner  # no block lies past its row


def test_plan_of_the_11a_backward_sum():
    assert reduce_plan(2, 2 * 2048 * 1024, 2, True) == R.ReducePlan(vec=8, blocks=4096)


def test_plan_serves_any_size_and_refuses_2_31_blocks():
    """Past 2^31 elements the plan is the same rule (64-bit pointers); 2^31
    blocks raise."""
    small = reduce_plan(1, 2 ** 20, 2, True)
    big = reduce_plan(1, 2 ** 30 + 64, 2, True)
    assert big.vec == small.vec
    assert big.blocks == -(-(2 ** 30 + 64) // (R.THREADS * 8))
    with pytest.raises(ValueError):
        reduce_plan(2 ** 31, 1, 4, False)


def _walk(plan, outer, inner):
    """How often each output element is written, as the kernel computes its
    places: block b takes tile t = b // outer of row o = b - t * outer (the
    rows minor); its thread j owns the vector at (t * THREADS + j) * vec
    and writes it iff that lies in the row."""
    count = np.zeros(outer * inner, dtype=np.int64)
    lanes = np.arange(R.THREADS)
    for b in range(plan.blocks):
        t = b // outer
        o = b - t * outer
        e = (t * R.THREADS + lanes) * plan.vec
        for j in range(plan.vec):
            np.add.at(count, o * inner + e[e < inner] + j, 1)
    return count


@pytest.mark.parametrize("outer,n,inner,itemsize,aligned", [
    (3, 4, 4104, 2, True), (3, 4, 1001, 2, False), (2, 1, 4096 * 3 + 8, 4, True),
    (5, 17, 40, 4, True), (700, 3, 40, 4, True), (1, 16, 20000, 4, True)])
def test_the_kernels_walk_writes_every_output_once(outer, n, inner, itemsize, aligned):
    plan = reduce_plan(outer, inner, itemsize, aligned)
    assert (_walk(plan, outer, inner) == 1).all()


def test_layouts_the_kernel_reads_in_place():
    x = torch.zeros(2, 4, 6, 8)
    assert R._layout(x, 1) == (2, 4, 48, 192, 48)
    assert R._layout(x, 0) == (1, 2, 192, 0, 192)
    assert R._layout(torch.zeros(1, 4, 6, 8).expand(2, 4, 6, 8), 1) == (2, 4, 48, 0, 48)
    assert R._layout(torch.zeros(2, 1, 6, 8).expand(2, 4, 6, 8), 1) == (2, 4, 48, 48, 0)
    assert R._layout(torch.zeros(4, 2, 6, 8).movedim(0, 1), 1) == (2, 4, 48, 48, 96)
    assert R._layout(torch.zeros(2, 6, 6, 8)[:, 1:5], 1) == (2, 4, 48, 288, 48)
    for readable_layout in (x, x.movedim(0, 1), torch.zeros(1, 4, 6, 8).expand(2, 4, 6, 8),
                            torch.zeros(6, 8).expand(2, 4, 6, 8), x[:, 1:3], x[:, :, :1]):
        assert reads_in_place(readable_layout, 1)
    for other in (x.transpose(2, 3), x[..., :4], torch.zeros(4, 2, 6, 8).movedim(0, 2),
                  torch.zeros(2, 4, 6).unsqueeze(-1).expand(2, 4, 6, 8), torch.zeros(16, 8).t()):
        assert not reads_in_place(other, 1 if other.ndim > 2 else 0)
    # the outer dims must collapse to one stride: an expand over one of
    # two outer dims does not
    y = torch.zeros(1, 3, 4, 8).expand(2, 3, 4, 8)
    assert reads_in_place(y, 2) is False and reads_in_place(y, 1)


def test_readable_copies_only_what_the_kernel_cannot_read():
    x = torch.randn(2, 4, 6, 8)
    before = dict(reduce_nway.layouts)
    for y, copied in ((x, 0), (x.movedim(0, 1), 0), (x.transpose(2, 3), 1),
                      (x[:1].expand(2, 4, 6, 8), 0)):
        got = readable(y, 1)
        assert got.is_contiguous() and torch.equal(got, y)  # the plain version's layout
        assert reduce_nway.layouts["copied"] == before["copied"] + copied
        before = dict(reduce_nway.layouts)
    assert before["copied_bytes"] > 0


def _mesh_jax(fn, x):
    """``fn`` over a (2, 4) stacked mesh of numpy rows, as nested ``vmap``s."""
    inner = jax.vmap(fn, axis_name="model")
    return np.asarray(jax.vmap(inner, axis_name="data")(jnp.asarray(x)))


def _layouts(seed):
    """(name, tensor) of one (2, 4, 6, 8) f32 value in several layouts."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((2, 4, 6, 8)).astype(np.float32))
    moved = torch.from_numpy(np.ascontiguousarray(base.numpy().transpose(1, 0, 2, 3)))
    spread = torch.from_numpy(rng.standard_normal((1, 4, 6, 8)).astype(np.float32))
    turned = torch.from_numpy(np.ascontiguousarray(base.numpy().transpose(0, 1, 3, 2)))
    return [("contiguous", base), ("movedim", moved.movedim(0, 1)),
            ("expand", spread.expand(2, 4, 6, 8)), ("transposed", turned.transpose(2, 3))]


MESH_FNS = {"axis_sum": lambda t: M.axis_sum(t, 1), "psum": lambda t: M.psum(t, "model"),
            "pmax": lambda t: M.pmax(t, "model")}


@pytest.mark.parametrize("name", ["contiguous", "movedim", "expand", "transposed"])
@pytest.mark.parametrize("fn", list(MESH_FNS))
def test_mesh_reductions_on_layouts_equal_jax(name, fn):
    x = dict(_layouts(0))[name]
    with M.Mesh((2, 4), ("data", "model"), device="cpu"):
        got, dense = MESH_FNS[fn](x), MESH_FNS[fn](x.contiguous())
    assert torch.equal(got, dense)
    data = x.contiguous().numpy()
    if fn == "axis_sum":
        want = _mesh_jax(lambda v: jax.lax.psum(v, "model"), data)[:, 0]
    else:
        body = jax.lax.psum if fn == "psum" else jax.lax.pmax
        want = _mesh_jax(lambda v: body(v, "model"), data)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["contiguous", "movedim", "expand", "transposed"])
def test_psum_gradient_on_layouts_equals_jax(name):
    """The transpose of ``psum`` sums the cotangent through ``axis_sum``
    without a copy first: an expanded cotangent (of a ``sum``) and a
    cotangent in another layout give JAX's gradient."""
    x = dict(_layouts(1))[name].clone().requires_grad_()
    rng = np.random.default_rng(2)
    w = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    with M.Mesh((2, 4), ("data", "model"), device="cpu"):
        y = M.psum(x, "model")
        loss = (y * torch.from_numpy(w).transpose(2, 3).contiguous().transpose(2, 3)).sum() \
            + y.sum()
        got, = torch.autograd.grad(loss, x)

    def jloss(v):
        y = jax.vmap(jax.vmap(lambda u: jax.lax.psum(u, "model"), axis_name="model"),
                     axis_name="data")(v)
        return (y * w).sum() + y.sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x.detach().contiguous().numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
