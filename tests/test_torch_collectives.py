"""The port's collective schedules against the JAX reference, on the CPU.

Every check of tests/progs/collectives_prog.py at its shapes (8 members,
every schedule, roots 0 and 3).  The reference bodies run in-process under
``jax.vmap(..., axis_name="x")`` over the stacked members, which is the
layout of the port's stacked mesh, so both frameworks take the same numpy
array (member i = row i).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import schedules as jsched
from repro.core.noc.params import PAPER_GEMM as J_GEMM, PAPER_MICRO as J_MICRO
from repro_torch.core import collectives as tcoll
from repro_torch.core import mesh as M
from repro_torch.core import schedules as tsched
from repro_torch.core.noc.params import PAPER_GEMM as T_GEMM, PAPER_MICRO as T_MICRO

N = 8


def _jax(fn, x):
    return np.asarray(jax.vmap(fn, axis_name="x")(jnp.asarray(x)))


def _torch(fn, x, n=N):
    with M.Mesh((n,), ("x",), device="cpu"):
        return fn(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("root", [0, 3])
@pytest.mark.parametrize("schedule", ["native", "chain", "pipelined", "tree"])
def test_broadcast(schedule, root):
    x = np.arange(N * 4 * 6, dtype=np.float32).reshape(N, 4, 6)
    out = _torch(lambda t: tsched.broadcast(t, "x", root=root, schedule=schedule, chunks=2), x)
    ref = _jax(lambda v: jsched.broadcast(v, "x", root=root, schedule=schedule, chunks=2), x)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_allclose(out, np.tile(x[root], (N, 1, 1)), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["native", "chain", "pipelined", "tree"])
def test_all_reduce(schedule):
    x = _randn(0, (N, 4, 6))
    out = _torch(lambda t: tsched.all_reduce(t, "x", schedule=schedule), x)
    ref = _jax(lambda v: jsched.all_reduce(v, "x", schedule=schedule), x)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.tile(x.sum(0), (N, 1, 1)), rtol=2e-5, atol=1e-5)


def test_all_reduce_pipelined_pads_ragged_rows():
    """The ring all-reduce pads rows that do not split into n chunks."""
    x = _randn(1, (N, 5, 3))
    out = _torch(lambda t: tsched.all_reduce(t, "x", schedule="pipelined"), x)
    ref = _jax(lambda v: jsched.all_reduce(v, "x", schedule="pipelined"), x)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["native", "chain", "pipelined", "tree"])
def test_all_gather(schedule):
    x = _randn(1, (N, 2, 5))
    out = _torch(lambda t: tsched.all_gather(t, "x", schedule=schedule), x)
    ref = _jax(lambda v: jsched.all_gather(v, "x", schedule=schedule), x)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_allclose(out, np.tile(x.reshape(N * 2, 5), (N, 1, 1)), rtol=1e-6)


@pytest.mark.parametrize("schedule", ["native", "chain"])
def test_reduce_scatter(schedule):
    x = _randn(2, (N, N * 2, 5))  # one (N*2, 5) per member
    out = _torch(lambda t: tsched.reduce_scatter(t, "x", schedule=schedule), x)
    ref = _jax(lambda v: jsched.reduce_scatter(v, "x", schedule=schedule), x)
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(out, x.sum(0).reshape(N, 2, 5), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", ["native", "tree"])
def test_barrier(schedule):
    with M.Mesh((N,), ("x",), device="cpu"):
        out = tsched.barrier("x", schedule=schedule)
    ref = _jax(lambda _: jsched.barrier("x", schedule=schedule), np.ones(N, np.float32))
    assert out.dtype == torch.int32 and out.shape == (N,)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), np.full(N, N))


def _native_input(kind, shape):
    if kind == "int32_above_2^24":  # an f32 sum would round: 8 x (2^24 + 1) is not an f32
        return np.full(shape, 2 ** 24 + 1, np.int32) + np.arange(
            np.prod(shape), dtype=np.int32).reshape(shape) % 5
    return (_randn(7, shape) * 100).astype(np.float16)  # each f16 add rounds


@pytest.mark.parametrize("kind", ["int32_above_2^24", "float16"])
@pytest.mark.parametrize("fn", ["all_reduce", "reduce_scatter"])
def test_native_sums_other_dtypes_as_jax(fn, kind):
    """psum sums int32 exactly (wrapping as int32 adds) and float16 member by
    member in float16; the native schedules follow it bit for bit."""
    x = _native_input(kind, (N, N * 2, 5))
    out = _torch(lambda t: getattr(tsched, fn)(t, "x", schedule="native"), x)
    ref = _jax(lambda v: getattr(jsched, fn)(v, "x", schedule="native"), x)
    assert out.dtype == ref.dtype == x.dtype
    np.testing.assert_array_equal(out, ref)
    if kind != "float16":
        total = x.astype(np.int64).sum(0)
        want = np.broadcast_to(total, (N,) + total.shape) if fn == "all_reduce" \
            else total.reshape(N, 2, 5)
        np.testing.assert_array_equal(out, want)


def test_native_all_reduce_of_2_24_plus_1_over_8():
    x = np.full((N, 3), 2 ** 24 + 1, np.int32)
    out = _torch(lambda t: tsched.all_reduce(t, "x"), x)
    np.testing.assert_array_equal(out, np.full((N, 3), 134217736))
    np.testing.assert_array_equal(out, _jax(lambda v: jsched.all_reduce(v, "x"), x))


@pytest.mark.parametrize("n", [2, 8, 16])
def test_native_barrier_counts_in_int32_as_jax(n):
    with M.Mesh((n,), ("x",), device="cpu"):
        out = tsched.barrier("x")
        tree = tsched.barrier("x", schedule="tree")
    ref = _jax(lambda _: jsched.barrier("x"), np.ones(n, np.float32))
    assert out.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tree.numpy(), ref)


def test_native_all_reduce_float64_adds_in_order():
    """float64 (which JAX without x64 does not hold) is added member by member
    in float64, as psum adds float16."""
    x = _randn(8, (N, 4, 3)).astype(np.float64) * 1e8 + _randn(9, (N, 4, 3))
    out = _torch(lambda t: tsched.all_reduce(t, "x"), x)
    want = x[0].copy()
    for i in range(1, N):
        want = want + x[i]
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, np.broadcast_to(want, x.shape))


def test_collectives_on_one_axis_of_a_2d_mesh():
    """An axis other than the first: each column reduces on its own."""
    x = _randn(3, (2, 4, 3, 5))
    with M.Mesh((2, 4), ("row", "col"), device="cpu"):
        out = tsched.all_reduce(torch.from_numpy(x), "row").numpy()
        bc = tsched.broadcast(torch.from_numpy(x), "col", root=1, schedule="tree").numpy()
    np.testing.assert_allclose(out, np.broadcast_to(x.sum(0), x.shape), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(bc, np.broadcast_to(x[:, 1:2], x.shape), rtol=1e-6)


@pytest.mark.parametrize("fn", ["broadcast", "all_reduce", "all_gather", "reduce_scatter"])
def test_pow2_check_raises(fn):
    x = torch.zeros(6, 6, 2)
    with M.Mesh((6,), ("x",), device="cpu"), pytest.raises(ValueError, match="power of two"):
        getattr(tsched, fn)(x, "x")


def test_unknown_schedule_raises():
    with M.Mesh((4,), ("x",), device="cpu"), pytest.raises(ValueError, match="unknown schedule"):
        tsched.all_reduce(torch.zeros(4, 2), "x", schedule="ring")


@pytest.mark.parametrize("group", [2, 4, 8, 16, 64])
@pytest.mark.parametrize("params", ["micro", "gemm"])
def test_choose_schedule_equals_jax(group, params):
    jp, tp = (J_MICRO, T_MICRO) if params == "micro" else (J_GEMM, T_GEMM)
    for nbytes in [0, 1, 64, 512, 1024, 4096, 32 * 1024, 128 * 1024, 1 << 20, 1 << 24]:
        assert tcoll.choose_schedule(nbytes, group, tp) == jcoll.choose_schedule(nbytes, group, jp)


@pytest.mark.parametrize("schedule", ["native", "chain", "pipelined", "tree"])
@pytest.mark.parametrize("hw", [True, False])
def test_collective_config_resolve_equals_jax(schedule, hw):
    tc = tcoll.CollectiveConfig(schedule=schedule, hw_collectives=hw)
    jc = jcoll.CollectiveConfig(schedule=schedule, hw_collectives=hw)
    for nbytes in [None, 512, 4096, 32 * 1024, 1 << 20]:
        for group in (4, 8, 16):
            assert tc.resolve(nbytes, group) == jc.resolve(nbytes, group)


def test_re_exports_match_the_reference():
    assert tcoll.SCHEDULES == jcoll.SCHEDULES
    for name in ("broadcast", "all_reduce", "all_gather", "reduce_scatter", "barrier"):
        assert getattr(tcoll, name) is getattr(tsched, name)


# -- the stacked mesh's primitives ------------------------------------------------


def test_axis_primitives_need_a_mesh_in_context():
    with pytest.raises(RuntimeError, match="no mesh"):
        M.axis_size("x")


def test_axis_index_broadcasts_over_its_axis():
    with M.Mesh((2, 4), ("row", "col"), device="cpu"):
        assert M.axis_index("col").shape == (1, 4)
        assert M.axis_index("row").tolist() == [[0], [1]]
        with pytest.raises(ValueError, match="unknown axis"):
            M.axis_index("z")


def test_ppermute_needs_a_full_permutation():
    with M.Mesh((4,), ("x",), device="cpu"):
        x = torch.arange(4.0)
        assert M.ppermute(x, "x", [(0, 1), (1, 2), (2, 3), (3, 0)]).tolist() == [3, 0, 1, 2]
        with pytest.raises(ValueError, match="full permutation"):
            M.ppermute(x, "x", [(0, 1), (1, 0)])


def test_psum_scatter_needs_divisible_rows():
    with M.Mesh((4,), ("x",), device="cpu"), pytest.raises(ValueError, match="divisible"):
        M.psum_scatter(torch.zeros(4, 6, 2), "x")


def test_psum_and_all_gather_untiled_equal_jax():
    x = _randn(5, (N, 3))
    with M.Mesh((N,), ("x",), device="cpu"):
        t = torch.from_numpy(x)
        s, g = M.psum(t, "x").numpy(), M.all_gather(t, "x", tiled=False).numpy()
        rs = M.psum_scatter(torch.from_numpy(_randn(6, (N, N))), "x", tiled=False).numpy()
    np.testing.assert_allclose(s, _jax(lambda v: jax.lax.psum(v, "x"), x), rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(g, _jax(lambda v: jax.lax.all_gather(v, "x"), x), rtol=1e-6)
    np.testing.assert_allclose(
        rs, _jax(lambda v: jax.lax.psum_scatter(v, "x"), _randn(6, (N, N))), rtol=2e-5, atol=1e-5)


def test_mesh_rejects_mismatched_axes():
    with pytest.raises(ValueError):
        M.Mesh((2, 2), ("x",), device="cpu")
    with pytest.raises(ValueError):
        M.Mesh((2, 2), ("x", "x"), device="cpu")
