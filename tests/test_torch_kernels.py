"""The port's kernels (repro_torch.kernels) against the JAX reference.

On the CPU the wrappers run their plain versions; these are held against
the Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
the jnp oracles of repro.kernels.ref, on the same numpy inputs.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.reduce_nway import reduce_nway as jreduce
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.reduce_nway import reduce_nway

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2e-2}


def _rand(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


def _both(x, dt):
    """The same values in both frameworks (bf16 rounds to nearest even in both)."""
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- gemm ---------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(32, 32, 32), (64, 32, 16), (16, 48, 64)])
def test_gemm_matches_jax(shape, dt):
    M, K, N = shape
    ja, ta = _both(_rand(0, (M, K)), dt)
    jb, tb = _both(_rand(1, (K, N)), dt)
    out = gemm(ta, tb)
    assert out.dtype == TDT[dt] and out.shape == (M, N)
    tol = TOL[dt]
    np.testing.assert_allclose(_np(out), _np(jgemm(ja, jb, bm=16, bn=16, bk=16)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out), _np(jref.gemm_ref(ja, jb)), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gemm_accumulate_epilogue(dt):
    """The DCA analogue: C_out = C_in + A @ B."""
    ja, ta = _both(_rand(0, (32, 32)), dt)
    jb, tb = _both(_rand(1, (32, 32)), dt)
    jc, tc = _both(_rand(2, (32, 32)), dt)
    out = gemm(ta, tb, tc, accumulate=True)
    tol = TOL[dt]
    np.testing.assert_allclose(
        _np(out), _np(jgemm(ja, jb, jc, bm=16, bn=16, bk=16, accumulate=True)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(out), _np(jref.gemm_ref(ja, jb, jc, accumulate=True)),
                               rtol=tol, atol=tol)
    # without accumulate, c is ignored, as in the reference
    np.testing.assert_allclose(_np(gemm(ta, tb, tc)), _np(jref.gemm_ref(ja, jb)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_batched_equals_loop(accumulate):
    """Leading dims are mesh members: one call equals a loop over members."""
    a = torch.from_numpy(_rand(3, (2, 3, 16, 24)))
    b = torch.from_numpy(_rand(4, (2, 3, 24, 8)))
    c = torch.from_numpy(_rand(5, (2, 3, 16, 8)))
    out = gemm(a, b, c, accumulate=accumulate)
    for i in range(2):
        for j in range(3):
            np.testing.assert_allclose(
                out[i, j].numpy(),
                gemm(a[i, j], b[i, j], c[i, j], accumulate=accumulate).numpy(),
                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mkn", [(1, 1, 1), (17, 5, 33), (130, 129, 131)])
def test_gemm_ragged_shapes(mkn):
    """No tile has to divide M, N, K (the TPU's assert is not kept)."""
    M, K, N = mkn
    a, b, c = _rand(6, (M, K)), _rand(7, (K, N)), _rand(8, (M, N))
    out = gemm(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c), accumulate=True)
    np.testing.assert_allclose(out.numpy(), c + a @ b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "inner", "batch", "c_shape", "int"])
def test_gemm_rejects_bad_operands(bad):
    a, b, c = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3), torch.zeros(2, 4, 3)
    if bad == "dtype":
        b = b.to(torch.bfloat16)
    elif bad == "inner":
        b = torch.zeros(2, 7, 3)
    elif bad == "batch":
        b = torch.zeros(3, 8, 3)
    elif bad == "c_shape":
        c = torch.zeros(2, 4, 4)
    else:
        a, b, c = (t.to(torch.int32) for t in (a, b, c))
    with pytest.raises((TypeError, ValueError)):
        gemm(a, b, c, accumulate=True)


# -- reduce_nway ----------------------------------------------------------------


def _reduce_input(op, shape, seed=0):
    if op == "and":
        return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)
    return _rand(seed, shape)


@pytest.mark.parametrize("shape", [(5, 256), (8, 128)])
@pytest.mark.parametrize("op", ["add", "max", "and"])
def test_reduce_nway_matches_jax(op, shape):
    x = _reduce_input(op, shape)
    out = reduce_nway(torch.from_numpy(x), op=op)
    assert out.shape == (shape[1],) and out.dtype == torch.from_numpy(x).dtype
    bs = 128
    np.testing.assert_allclose(_np(out), _np(jreduce(jnp.asarray(x), op=op, bs=bs)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(out), _np(jref.reduce_nway_ref(jnp.asarray(x), op)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["add", "max"])
def test_reduce_nway_bf16_matches_jax(op):
    jx, tx = _both(_rand(1, (5, 256)), "bf16")
    out = reduce_nway(tx, op=op)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jref.reduce_nway_ref(jx, op)), rtol=2e-2, atol=2e-2)


def test_reduce_nway_int_add_sums_in_f32():
    """add over int32 rows sums in f32 and casts back, as the reference."""
    x = np.random.default_rng(2).integers(-50, 50, (6, 128)).astype(np.int32)
    out = reduce_nway(torch.from_numpy(x), op="add")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jref.reduce_nway_ref(jnp.asarray(x), "add")))


def test_reduce_nway_lsb_and_barrier_semantics():
    """LsbAnd: result is 1 iff every participant has arrived (bit set)."""
    arrived = torch.ones(8, 128, dtype=torch.int32)
    missing = arrived.clone()
    missing[3] = 0
    assert int(reduce_nway(arrived, op="and")[0]) == 1
    assert int(reduce_nway(missing, op="and")[0]) == 0


@pytest.mark.parametrize("dim", [0, 1, 2, -1])
@pytest.mark.parametrize("op", ["add", "max"])
def test_reduce_nway_any_dim(op, dim):
    """The stacked mesh's psum reduces a middle dim in place."""
    x = _rand(3, (3, 4, 5))
    out = reduce_nway(torch.from_numpy(x), op=op, dim=dim)
    expected = x.sum(dim) if op == "add" else x.max(dim)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op,dtype", [("and", torch.float32), ("max", torch.int32),
                                      ("add", torch.float64), ("mul", torch.float32)])
def test_reduce_nway_rejects_undefined_pairs(op, dtype):
    with pytest.raises((TypeError, ValueError)):
        reduce_nway(torch.zeros(4, 8, dtype=dtype), op=op)


def test_plain_oracles_match_jax_oracles():
    a, b, c = _rand(0, (8, 12)), _rand(1, (12, 4)), _rand(2, (8, 4))
    np.testing.assert_allclose(
        _np(tref.gemm_ref(*(torch.from_numpy(t) for t in (a, b, c)), accumulate=True)),
        _np(jref.gemm_ref(*(jnp.asarray(t) for t in (a, b, c)), accumulate=True)),
        rtol=1e-5, atol=1e-5)
    x = _reduce_input("and", (7, 64), seed=4)
    np.testing.assert_array_equal(tref.reduce_nway_ref(torch.from_numpy(x), "and").numpy(),
                                  np.asarray(jref.reduce_nway_ref(jnp.asarray(x), "and")))


# -- flash_attention ------------------------------------------------------------


def _qkv_np(seed, shape):
    return tuple(_rand(seed + i, shape) for i in range(3))


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("S,d", [(128, 32), (256, 16)])
def test_flash_attention_matches_jax(S, d, window):
    """The reference test's shapes and tolerance (tests/test_kernels.py)."""
    q, k, v = _qkv_np(0, (4, S, d))
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), window=window)
    assert out.shape == (4, S, d) and out.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    np.testing.assert_allclose(
        _np(out), _np(jflash(jq, jk, jv, window=window, bq=64, bkv=64)), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(jq, jk, jv, window=window)),
        rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bq,bkv", [(32, 32), (64, 32), (128, 64)])
def test_flash_attention_block_shape_invariance(bq, bkv):
    """bq / bkv are the TPU's block shape: they do not change the result."""
    q, k, v = _qkv_np(10, (2, 128, 16))
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), bq=bq, bkv=bkv)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    np.testing.assert_allclose(_np(out), _np(jflash(jq, jk, jv, bq=bq, bkv=bkv)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,window", [(1, 0), (77, 0), (100, 16), (200, 64)])
def test_flash_attention_ragged_s_matches_oracle(S, window):
    """Any S: the reference kernel asserts S % bq == 0, its oracle does not."""
    q, k, v = _qkv_np(20, (3, S, 32))
    out = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), window=window)
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_ref(*(jnp.asarray(t) for t in (q, k, v)),
                                               window=window)),
        rtol=2e-4, atol=2e-4)


def test_flash_attention_bf16_matches_jax_oracle():
    q, k, v = _qkv_np(30, (2, 64, 16))
    (jq, tq), (jk, tk), (jv, tv) = (_both(t, "bf16") for t in (q, k, v))
    out = flash_attention(tq, tk, tv, window=8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jref.flash_attention_ref(jq, jk, jv, window=8)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank", "int"])
def test_flash_attention_rejects_bad_operands(bad):
    q = k = v = torch.zeros(2, 8, 16)
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "shape":
        v = torch.zeros(2, 9, 16)
    elif bad == "rank":
        q = k = v = torch.zeros(8, 16)
    else:
        q = k = v = torch.zeros(2, 8, 16, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        flash_attention(q, k, v)


def test_flash_attention_oracle_matches_jax_oracle():
    q, k, v = _qkv_np(40, (2, 48, 16))
    for window in (0, 5):
        np.testing.assert_allclose(
            _np(tref.flash_attention_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                         window=window)),
            _np(jref.flash_attention_ref(*(jnp.asarray(t) for t in (q, k, v)), window=window)),
            rtol=2e-4, atol=2e-4)
