"""The port's kernels (repro_torch.kernels) against the JAX reference.

On the CPU the wrappers run their plain versions; these are held against
the Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
the jnp oracles of repro.kernels.ref, on the same numpy inputs.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.reduce_nway import reduce_nway as jreduce
from repro.kernels.rglru import rglru_scan as jrglru
from repro.kernels.rwkv6 import wkv as jwkv
from repro.models.rglru import _lru_scan as jlru_scan
from repro.models.rwkv6 import chunked_wkv as jchunked_wkv
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.reduce_nway import reduce_nway
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.rwkv6 import wkv

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


# Mixed float dtypes: the Pallas kernel casts every block to f32 on load and
# returns a's dtype; the port casts to f32 and casts the result back.
@pytest.mark.parametrize("dts", [("bf16", "bf16", "f32"), ("f32", "bf16", "bf16"),
                                 ("bf16", "f32", "f32"), ("f32", "bf16", "f32")])
def test_gemm_mixed_dtypes_match_pallas(dts):
    (ja, ta), (jb, tb), (jc, tc) = (_both(_rand(70 + i, s), dt) for i, (s, dt) in
                                    enumerate(zip(((32, 48), (48, 16), (32, 16)), dts)))
    out = gemm(ta, tb, tc, accumulate=True)
    pallas = jgemm(ja, jb, jc, bm=16, bn=16, bk=16, accumulate=True)
    assert out.dtype == TDT[dts[0]] and pallas.dtype == JDT[dts[0]]
    tol = TOL[dts[0]]
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("bad", ["f16", "inner", "batch", "c_shape", "int"])
def test_gemm_rejects_bad_operands(bad):
    a, b, c = torch.zeros(2, 4, 8), torch.zeros(2, 8, 3), torch.zeros(2, 4, 3)
    if bad == "f16":
        b = b.to(torch.float16)
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


@pytest.mark.parametrize("op,dtype", [("and", torch.float32), ("max", torch.int64),
                                      ("add", torch.float64), ("mul", torch.float32),
                                      ("add", torch.bool)])
def test_reduce_nway_rejects_undefined_pairs(op, dtype):
    with pytest.raises((TypeError, ValueError)):
        reduce_nway(torch.zeros(4, 8, dtype=dtype), op=op)


@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_nway_int32_max_is_exact(dim):
    """int32 max above 2^24, where an f32 running value would round: exact,
    as the Pallas kernel's jnp.max is."""
    x = np.array([[16777217, 16777219, -16777219, 7],
                  [16777219, 16777217, -16777217, 2 ** 31 - 1],
                  [3, 16777218, -2 ** 31, 5]], np.int32)
    xt = np.ascontiguousarray(x if dim == 0 else x.T)
    out = reduce_nway(torch.from_numpy(xt), op="max", dim=dim)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), [16777219, 16777219, -16777217, 2 ** 31 - 1])
    if dim == 0:
        np.testing.assert_array_equal(out.numpy(), np.asarray(jreduce(jnp.asarray(x), op="max",
                                                                      bs=4)))


def test_reduce_nway_bool_and_matches_pallas():
    x = np.random.default_rng(9).random((5, 256)) < 0.8
    out = reduce_nway(torch.from_numpy(x), op="and")
    assert out.dtype == torch.bool
    ref = np.asarray(jreduce(jnp.asarray(x), op="and", bs=128))
    assert ref.dtype == np.bool_
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), x.all(0))


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


@pytest.mark.parametrize("dts", [("f32", "bf16", "bf16"), ("bf16", "f32", "f32"),
                                 ("f32", "f32", "bf16")])
def test_flash_attention_mixed_dtypes_match_pallas(dts):
    """The Pallas kernel casts q, k, v to f32 on load and returns q's dtype."""
    (jq, tq), (jk, tk), (jv, tv) = (_both(t, dt) for t, dt in zip(_qkv_np(50, (2, 128, 32)),
                                                                   dts))
    out = flash_attention(tq, tk, tv, window=48)
    pallas = jflash(jq, jk, jv, window=48, bq=64, bkv=64)
    assert out.dtype == TDT[dts[0]] and pallas.dtype == JDT[dts[0]]
    tol = 2e-4 if dts[0] == "f32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("bad", ["f16", "shape", "rank", "int"])
def test_flash_attention_rejects_bad_operands(bad):
    q = k = v = torch.zeros(2, 8, 16)
    if bad == "f16":
        k = k.to(torch.float16)
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


# -- rglru_scan -------------------------------------------------------------------


def _decays(seed, shape):
    """a in (0, 1), as the RG-LRU's exp(-8 softplus(lambda) r) is."""
    return (1.0 / (1.0 + np.exp(-_rand(seed, shape) * 2))).astype(np.float32)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_rglru_scan_matches_jax(chunk):
    """The reference test's shapes and tolerance (tests/test_kernels.py)."""
    a, b = _decays(0, (2, 128, 16)), _rand(1, (2, 128, 16))
    out = rglru_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=chunk)
    assert out.shape == a.shape and out.dtype == torch.float32
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(_np(out), _np(jrglru(ja, jb, chunk=chunk)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(out), _np(jref.rglru_scan_ref(ja, jb)), rtol=1e-4, atol=1e-4)


def test_rglru_scan_matches_model_associative_scan():
    a, b = _decays(2, (2, 64, 8)), _rand(3, (2, 64, 8))
    np.testing.assert_allclose(
        _np(rglru_scan(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jlru_scan(jnp.asarray(a), jnp.asarray(b))), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [1, 77, 130, 300])
def test_rglru_scan_ragged_s_matches_oracle(S):
    """Any S: the reference kernel asserts S % chunk == 0, its oracle does not."""
    a, b = _decays(4, (3, S, 5)), _rand(5, (3, S, 5))
    np.testing.assert_allclose(
        _np(rglru_scan(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))), rtol=1e-4, atol=1e-4)


def test_rglru_scan_bf16_matches_jax_oracle():
    (ja, ta), (jb, tb) = _both(_decays(6, (2, 64, 16)), "bf16"), _both(_rand(7, (2, 64, 16)), "bf16")
    out = rglru_scan(ta, tb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jref.rglru_scan_ref(ja, jb)), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dts", [("f32", "bf16"), ("bf16", "f32")])
def test_rglru_scan_mixed_dtypes_match_pallas(dts):
    """The Pallas kernel casts a and b to f32 on load and returns a's dtype."""
    (ja, ta), (jb, tb) = _both(_decays(80, (2, 128, 16)), dts[0]), _both(_rand(81, (2, 128, 16)),
                                                                        dts[1])
    out = rglru_scan(ta, tb)
    pallas = jrglru(ja, jb, chunk=64)
    assert out.dtype == TDT[dts[0]] and pallas.dtype == JDT[dts[0]]
    tol = 1e-4 if dts[0] == "f32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=tol, atol=tol)


@pytest.mark.parametrize("bad", ["f16", "shape", "rank", "int"])
def test_rglru_scan_rejects_bad_operands(bad):
    a = b = torch.zeros(2, 8, 4)
    if bad == "f16":
        b = b.to(torch.float16)
    elif bad == "shape":
        b = torch.zeros(2, 9, 4)
    elif bad == "rank":
        a = b = torch.zeros(8, 4)
    else:
        a = b = torch.zeros(2, 8, 4, dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        rglru_scan(a, b)


# -- wkv ----------------------------------------------------------------------------


def _wkv_inputs(seed, B, S, H, hd, logw=None):
    """r, k, v, logw (B, S, H, hd) and u (H, hd); logw as the reference test
    draws it unless a constant is given."""
    r, k, v = (_rand(seed + i, (B, S, H, hd)) for i in range(3))
    if logw is None:
        lw = -np.exp(np.clip(_rand(seed + 3, (B, S, H, hd)) - 2.0, -8, 1)).astype(np.float32)
    else:
        lw = np.full((B, S, H, hd), logw, np.float32)
    return r, k, v, lw, _rand(seed + 4, (H, hd))


def _heads_first(x):
    """(B, S, H, hd) -> (B * H, S, hd), the Pallas kernel's layout."""
    B, S, H, hd = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))


def _wkv_port(r, k, v, lw, u, state0=None):
    return wkv(*(torch.from_numpy(t) for t in (r, k, v, lw, u)),
               None if state0 is None else torch.from_numpy(state0))


@pytest.mark.parametrize("chunk,S", [(16, 64), (32, 64), (64, 128)])
def test_wkv_matches_jax(chunk, S):
    """The reference test's shapes and tolerance, through the Pallas kernel
    (reshaped to (B * H, S, hd) as tests/test_kernels.py does) and the
    sequential oracle."""
    B, H, hd = 3, 1, 16
    r, k, v, lw, u = _wkv_inputs(0, B, S, H, hd)
    out, state = _wkv_port(r, k, v, lw, u)
    assert out.shape == (B, S, H, hd) and out.dtype == torch.float32
    assert state.shape == (B, H, hd, hd) and state.dtype == torch.float32
    j = [_heads_first(t) for t in (r, k, v, lw)]
    ju = jnp.tile(jnp.asarray(u), (B, 1))
    for ref in (jwkv(*j, ju, chunk=chunk), jref.wkv_ref(*j, ju)):
        ref = np.asarray(ref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(_np(out), ref, rtol=2e-3, atol=2e-3)


def test_wkv_matches_model_chunked_with_its_state():
    """Against ``models/rwkv6.chunked_wkv``: the output and the final state
    that prefill hands to decode, from a non-zero state0."""
    B, S, H, hd = 2, 64, 2, 16
    r, k, v, lw, u = _wkv_inputs(20, B, S, H, hd)
    s0 = _rand(25, (B, H, hd, hd))
    out, state = _wkv_port(r, k, v, lw, u, s0)
    jout, jstate = jchunked_wkv(*(jnp.asarray(t) for t in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(state), _np(jstate), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("S", [128, 200])
def test_wkv_is_finite_at_the_strongest_decay(S):
    """At logw = -e^2, the model's bound, the chunked reference overflows to
    NaN (ROADMAP.md queue 3); the port equals the sequential oracle."""
    B, H, hd = 2, 2, 16
    r, k, v, lw, u = _wkv_inputs(30, B, S, H, hd, logw=-math.e ** 2)
    out, state = _wkv_port(r, k, v, lw, u)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    j = [_heads_first(t) for t in (r, k, v, lw)]
    ref = np.asarray(jref.wkv_ref(*j, jnp.tile(jnp.asarray(u), (B, 1))))
    np.testing.assert_allclose(_np(out), ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3),
                               rtol=2e-3, atol=2e-3)
    if S % 64 == 0:
        jout, _ = jchunked_wkv(*(jnp.asarray(t) for t in (r, k, v, lw, u)),
                               jnp.zeros((B, H, hd, hd)))
        assert np.isnan(np.asarray(jout)).any()


@pytest.mark.parametrize("S", [1, 37, 100])
def test_wkv_ragged_s_matches_oracle(S):
    """Any S: the reference asserts that its chunk divides S, its oracle does not."""
    B, H, hd = 2, 3, 16
    r, k, v, lw, u = _wkv_inputs(40, B, S, H, hd)
    out, _ = _wkv_port(r, k, v, lw, u)
    j = [_heads_first(t) for t in (r, k, v, lw)]
    ref = np.asarray(jref.wkv_ref(*j, jnp.tile(jnp.asarray(u), (B, 1))))
    np.testing.assert_allclose(_np(out), ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3),
                               rtol=2e-3, atol=2e-3)


def test_wkv_bf16_matches_jax_oracle():
    B, S, H, hd = 1, 32, 2, 16
    r, k, v, lw, u = _wkv_inputs(50, B, S, H, hd)
    (jr, tr), (jk, tk), (jv, tv) = (_both(t, "bf16") for t in (r, k, v))
    out, _ = wkv(tr, tk, tv, torch.from_numpy(lw), torch.from_numpy(u))
    assert out.dtype == torch.bfloat16
    ref = jref.wkv_ref(*(_heads_first(np.asarray(t, np.float32)) for t in (jr, jk, jv, lw)),
                       jnp.tile(jnp.asarray(u), (B, 1)))
    ref = np.asarray(ref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(_np(out) - ref).max() <= 2e-2 * scale


@pytest.mark.parametrize("bad", ["dtype", "shape", "logw_dtype", "u", "state0"])
def test_wkv_rejects_bad_operands(bad):
    r = k = v = lw = torch.zeros(2, 8, 3, 16)
    u, s0 = torch.zeros(3, 16), None
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "shape":
        v = torch.zeros(2, 9, 3, 16)
    elif bad == "logw_dtype":
        lw = lw.to(torch.bfloat16)
    elif bad == "u":
        u = torch.zeros(2, 16)
    else:
        s0 = torch.zeros(2, 3, 16, 8)
    with pytest.raises((TypeError, ValueError)):
        wkv(r, k, v, lw, u, s0)


def test_recurrence_oracles_match_jax_oracles():
    a, b = _decays(60, (2, 40, 6)), _rand(61, (2, 40, 6))
    np.testing.assert_allclose(
        _np(tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    B, S, H, hd = 2, 24, 2, 8
    r, k, v, lw, u = _wkv_inputs(62, B, S, H, hd)
    out, _ = tref.wkv_ref(*(torch.from_numpy(t) for t in (r, k, v, lw, u)))
    j = [_heads_first(t) for t in (r, k, v, lw)]
    ref = np.asarray(jref.wkv_ref(*j, jnp.tile(jnp.asarray(u), (B, 1))))
    np.testing.assert_allclose(_np(out), ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3),
                               rtol=1e-5, atol=1e-5)
