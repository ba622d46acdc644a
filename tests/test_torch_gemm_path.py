"""The port's collective GEMM path against the JAX reference, on the CPU.

``summa``, ``fcl``, ``ag_matmul`` and ``matmul_rs`` at the shapes of
tests/progs/gemm_prog.py.  The reference bodies run in-process under nested
``jax.vmap(..., axis_name=...)`` (the outer vmap is the first mesh axis), the
port's bodies on a stacked CPU mesh, both on the same numpy blocks; the
``*_sharded`` wrappers are held against numpy ``A @ B``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fcl as jfcl
from repro.core import overlap as joverlap
from repro.core import summa as jsumma
from repro_torch.core import fcl as tfcl
from repro_torch.core import mesh as M
from repro_torch.core import overlap as toverlap
from repro_torch.core import summa as tsumma

TOL = 2e-4


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _blocks(x, rows, cols):
    """(M, K) -> (rows, cols, M/rows, K/cols): block (i, j) at [i, j]."""
    m, k = x.shape
    return np.ascontiguousarray(
        x.reshape(rows, m // rows, cols, k // cols).transpose(0, 2, 1, 3))


def _jax_stacked(fn, axes, *xs):
    for name in reversed(axes):
        fn = jax.vmap(fn, axis_name=name)
    return np.asarray(fn(*(jnp.asarray(x) for x in xs)))


def _torch_stacked(fn, shape, axes, *xs):
    with M.Mesh(shape, axes, device="cpu"):
        return fn(*(torch.from_numpy(x) for x in xs)).numpy()


A, B = _randn(0, (32, 64)), _randn(1, (64, 48))
ATTN, WO = _randn(2, (16, 64)), _randn(3, (64, 24))
X, W = _randn(4, (32, 16)), _randn(5, (16, 40))
X2, W2 = _randn(6, (32, 64)), _randn(7, (64, 24))
SUMMA_SCHEDULES = ["native", "chain", "pipelined", "tree", "ring"]
FCL_SCHEDULES = ["native", "chain", "pipelined", "tree"]


@pytest.mark.parametrize("schedule", SUMMA_SCHEDULES)
def test_summa_body_matches_jax(schedule):
    a, b = _blocks(A, 2, 2), _blocks(B, 2, 2)
    axes = ("row", "col")
    out = _torch_stacked(lambda x, y: tsumma.summa(x, y, "row", "col", schedule, chunks=2),
                         (2, 2), axes, a, b)
    ref = _jax_stacked(lambda x, y: jsumma.summa(x, y, "row", "col", schedule, chunks=2),
                       axes, a, b)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("schedule", SUMMA_SCHEDULES)
def test_summa_sharded_matches_numpy(schedule):
    mesh = M.Mesh((2, 2), ("row", "col"), device="cpu")
    C = tsumma.summa_sharded(A, B, mesh, row_axis="row", col_axis="col",
                             schedule=schedule, chunks=2)
    np.testing.assert_allclose(C.numpy(), A @ B, rtol=TOL, atol=TOL)


def test_summa_on_a_4x4_mesh():
    a, b = _randn(8, (32, 32)), _randn(9, (32, 16))
    mesh = M.Mesh((4, 4), ("data", "model"), device="cpu")
    for schedule in ("native", "ring"):
        np.testing.assert_allclose(tsumma.summa_sharded(a, b, mesh, schedule=schedule).numpy(),
                                   a @ b, rtol=TOL, atol=TOL)


def test_summa_needs_a_square_grid():
    mesh = M.Mesh((2, 4), ("row", "col"), device="cpu")
    with pytest.raises(ValueError, match="square"):
        tsumma.summa_sharded(A, B, mesh, row_axis="row", col_axis="col")


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("schedule", FCL_SCHEDULES)
def test_fcl_body_matches_jax(schedule, scatter):
    attn = np.ascontiguousarray(ATTN.reshape(16, 8, 8).transpose(1, 0, 2))  # P(None, axis)
    wo = WO.reshape(8, 8, 24)                                                # P(axis, None)
    out = _torch_stacked(lambda a, w: tfcl.fcl(a, w, "model", schedule, scatter=scatter),
                         (8,), ("model",), attn, wo)
    ref = _jax_stacked(lambda a, w: jfcl.fcl(a, w, "model", schedule, scatter=scatter),
                       ("model",), attn, wo)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("schedule", FCL_SCHEDULES)
def test_fcl_sharded_matches_numpy(schedule):
    mesh = M.Mesh((8,), ("model",), device="cpu")
    y = tfcl.fcl_sharded(ATTN, WO, mesh, axis="model", schedule=schedule)
    np.testing.assert_allclose(y.numpy(), ATTN @ WO, rtol=TOL, atol=TOL)


def test_fcl_sharded_scatter_matches_numpy():
    mesh = M.Mesh((8,), ("model",), device="cpu")
    y = tfcl.fcl_sharded(ATTN, WO, mesh, axis="model", schedule="native", scatter=True)
    np.testing.assert_allclose(y.numpy(), ATTN @ WO, rtol=TOL, atol=TOL)


def test_ag_matmul_body_matches_jax():
    xs = X.reshape(8, 4, 16)                                         # P(axis, None)
    ws = np.ascontiguousarray(W.reshape(16, 8, 5).transpose(1, 0, 2))  # P(None, axis)
    out = _torch_stacked(lambda x, w: toverlap.ag_matmul(x, w, "model"), (8,), ("model",), xs, ws)
    ref = _jax_stacked(lambda x, w: joverlap.ag_matmul(x, w, "model"), ("model",), xs, ws)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_matmul_rs_body_matches_jax():
    xs = np.ascontiguousarray(X2.reshape(32, 8, 8).transpose(1, 0, 2))  # P(None, axis)
    ws = W2.reshape(8, 8, 24)                                            # P(axis, None)
    out = _torch_stacked(lambda x, w: toverlap.matmul_rs(x, w, "model"), (8,), ("model",), xs, ws)
    ref = _jax_stacked(lambda x, w: joverlap.matmul_rs(x, w, "model"), ("model",), xs, ws)
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_overlap_sharded_matches_numpy(n):
    mesh = M.Mesh((n,), ("model",), device="cpu")
    np.testing.assert_allclose(toverlap.ag_matmul_sharded(X, W, mesh).numpy(), X @ W,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(toverlap.matmul_rs_sharded(X2, W2, mesh).numpy(), X2 @ W2,
                               rtol=TOL, atol=TOL)


def test_matmul_rs_needs_divisible_rows():
    with M.Mesh((4,), ("model",), device="cpu"), pytest.raises(ValueError, match="divisible"):
        toverlap.matmul_rs(torch.zeros(4, 6, 3), torch.zeros(4, 3, 2), "model")


def test_bf16_path_casts_like_the_reference():
    """bf16 operands: products in f32, one cast back, as ``summa`` does."""
    a = torch.from_numpy(A).to(torch.bfloat16)
    b = torch.from_numpy(B).to(torch.bfloat16)
    mesh = M.Mesh((2, 2), ("row", "col"), device="cpu")
    C = tsumma.summa_sharded(a, b, mesh, row_axis="row", col_axis="col")
    assert C.dtype == torch.bfloat16
    ref = (a.float() @ b.float()).numpy()
    np.testing.assert_allclose(C.float().numpy(), ref, rtol=2e-2, atol=2e-2 * np.abs(ref).max())


# -- shard / unshard ------------------------------------------------------------------


SPECS = [(("row", "col"), (2, 4)), (("col", "row"), (2, 4)), ((None, "col"), (2, 4)),
         (("row", None), (2, 4)), ((None, None), (2, 4)), (("row",), (2, 4)), ((), (2, 4))]


@pytest.mark.parametrize("spec,shape", SPECS)
def test_shard_unshard_round_trip(spec, shape):
    x = _randn(10, (8, 12, 3))
    mesh = M.Mesh(shape, ("row", "col"), device="cpu")
    y = M.shard(x, mesh, spec)
    assert y.shape[:2] == shape and y.is_contiguous()
    np.testing.assert_array_equal(M.unshard(y, mesh, spec).numpy(), x)


def test_shard_lays_blocks_out_as_shard_map():
    """Member (i, j) holds block (i, j) under P(row, col); copies elsewhere."""
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    mesh = M.Mesh((2, 4), ("row", "col"), device="cpu")
    y = M.shard(x, mesh, ("row", "col")).numpy()
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(y[i, j], x[4 * i:4 * i + 4, 3 * j:3 * j + 3])
    z = M.shard(x, mesh, (None, "row")).numpy()  # replicated over "col"
    for i in range(2):
        for j in range(4):
            np.testing.assert_array_equal(z[i, j], x[:, 6 * i:6 * i + 6])


@pytest.mark.parametrize("spec", [("row", "row"), ("row", "col", None, None), ("z",)])
def test_shard_rejects_bad_specs(spec):
    mesh = M.Mesh((2, 2), ("row", "col"), device="cpu")
    with pytest.raises(ValueError):
        M.shard(np.zeros((4, 4, 2), np.float32), mesh, spec)


def test_shard_rejects_indivisible_dims():
    mesh = M.Mesh((4,), ("x",), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        M.shard(np.zeros((6, 2), np.float32), mesh, ("x",))
