"""The f32 gemm's launch plan and the wkv kernel's arithmetic, on the CPU.

``gemm_plan`` chooses the CUDA-core gemm's output tile (128 when the grid
of 128x128 tiles gives each SM a block, else 64) and its loads (16-byte
vectors for aligned f32 with K % 4 == N % 4 == 0, else scalars); it is
held here to its stated rule at the collective path's shapes.

``csrc/wkv.cu`` cannot run here, so its arithmetic is emulated in plain
PyTorch (``wkv_emulated``): chunks of 64 with a zero-padded ragged tail,
cumulative log-decays in base 2, sub-chunks of 16 whose start is the
reference point for the off-diagonal blocks of P (r decayed to it, k
decayed from it), pairwise exponentials only on the diagonal blocks, every
exponent clamped to <= 0, and the value columns computed in independent
groups of 16 (the cluster's blocks) and joined.  The emulation is held
against the sequential oracle (``repro.kernels.ref.wkv_ref``), the Pallas
kernel in interpret mode and the model's ``chunked_wkv`` (with a state) at
the reference's 2e-3, and at the model's strongest decay, where the Pallas
kernel is NaN, against the sequential oracle; every exponent it forms is
<= 0 before the clamp.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv as jwkv
from repro.models.rwkv6 import chunked_wkv as jchunked_wkv
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gemm import gemm_plan

H100_SMS = 132
F32, BF16 = torch.float32, torch.bfloat16


# -- gemm_plan ----------------------------------------------------------------------

@pytest.mark.parametrize("batch,M,N,K,tile", [
    (16, 1024, 2752, 1024, 128),   # the SUMMA step on a 4x4 mesh: 2816 tiles of 128
    (8, 4096, 4096, 512, 128),     # FCL partials over 8 members: 8192 tiles
    (1, 4096, 4096, 4096, 128),    # 1024 tiles
    (1, 1000, 777, 333, 64),       # 56 tiles of 128: spread over 208 of 64
    (1, 1000, 776, 333, 64),
    (1, 1408, 1536, 64, 128),      # 11 x 12 = 132 tiles: one a SM
    (1, 1408, 1408, 64, 64),       # 121 tiles
    (2, 128, 128, 128, 64),
])
def test_gemm_plan_tile_fills_the_card(batch, M, N, K, tile):
    assert gemm_plan(batch, M, N, K, H100_SMS)[0] == tile


def test_gemm_plan_tile_follows_the_sm_count():
    assert gemm_plan(1, 1000, 777, 64, 56)[0] == 128
    assert gemm_plan(1, 1000, 777, 64, 57)[0] == 64


@pytest.mark.parametrize("K,N,ptrs,dtype,vector", [
    (1024, 2752, (0, 4096, 8192, 16), F32, True),    # the SUMMA step
    (512, 4096, (256, 512, 1024), F32, True),        # FCL partials
    (333, 777, (0, 16, 32, 48), F32, False),         # K % 4 != 0 (and N)
    (332, 777, (0, 16, 32, 48), F32, False),         # N % 4 != 0
    (333, 776, (0, 16, 32, 48), F32, False),         # K % 4 != 0
    (332, 776, (0, 16, 32, 48), F32, True),
    (64, 64, (0, 8, 32), F32, False),                # an 8-byte aligned operand
    (64, 64, (4, 0, 0), F32, False),
    (64, 64, (), F32, True),
    (1024, 2752, (0, 16, 32), BF16, False),          # bf16 on this route loads scalars
    (333, 776, (0, 16), BF16, False),
])
def test_gemm_plan_vector_loads_need_alignment(K, N, ptrs, dtype, vector):
    assert gemm_plan(1, 256, N, K, H100_SMS, ptrs, dtype)[1] is vector


# -- the wkv arithmetic, emulated ------------------------------------------------------

CHUNK, SUB, COLS = 64, 16, 16
def wkv_emulated(r, k, v, logw, u, state0=None, exponents=None):
    """The arithmetic of ``csrc/wkv.cu`` in plain PyTorch, in f32.

    Chunks of 64 tokens (a ragged last one zero-padded, logw 0), cumulative
    log-decays in base 2, each query sub-chunk's start as the reference
    point for its off-diagonal blocks of P, pairwise exponentials on the
    diagonal blocks, every exponent clamped to <= 0, and the value columns
    in independent groups of 16 (one cluster block each) joined at the end.
    When ``exponents`` is a list, the largest exponent formed (before the
    clamp) is appended to it per chunk.  Same signature and results as the
    port's ``wkv``.
    """
    B, S, H, hd = r.shape
    f = lambda t: t.float().permute(0, 2, 1, 3)  # (B, H, S, hd)
    r32, k32, v32, lw = f(r), f(k), f(v), f(logw)
    u32 = u.float()[None, :, None, :]  # (1, H, 1, hd)
    state = (torch.zeros((B, H, hd, hd)) if state0 is None else state0.float().clone())
    state = state.to(r32.device)
    out = torch.zeros((B, H, S, hd), dtype=torch.float32, device=r32.device)
    log2e = 1.4426950408889634

    def ex2(x, live=None):  # ``live``: the entries the kernel forms
        if exponents is not None and x.numel():
            exponents.append(float((x if live is None else x[..., live, :]).max()))
        return torch.exp2(torch.clamp(x, max=0.0))

    below = torch.ones(SUB, SUB, dtype=torch.bool).tril(-1)  # keys s < t

    for t0 in range(0, S, CHUNK):
        n = min(CHUNK, S - t0)
        pad = lambda x: torch.nn.functional.pad(x[:, :, t0:t0 + n], (0, 0, 0, CHUNK - n))
        rc, kc, vc, wc = pad(r32), pad(k32), pad(v32), pad(lw)
        cum = torch.cumsum(wc * log2e, dim=2)                   # c_t, through t
        x = torch.nn.functional.pad(cum[:, :, :-1], (0, 0, 1, 0))  # x_t, before t
        P = torch.zeros((B, H, CHUNK, CHUNK))
        for q in range(CHUNK // SUB):
            tq = q * SUB
            rows = slice(tq, tq + SUB)
            xref = x[:, :, tq:tq + 1]  # the reference point: the sub-chunk's start
            if tq:  # off-diagonal keys s < tq: rq . kq
                rq = rc[:, :, rows] * ex2(x[:, :, rows] - xref)
                kq = kc[:, :, :tq] * ex2(xref - cum[:, :, :tq])
                P[:, :, rows, :tq] = rq @ kq.transpose(-1, -2)
            # the diagonal sub-block: pairwise exponentials, s < t
            e = ex2(x[:, :, rows, None, :] - cum[:, :, None, rows, :], below)
            d = (rc[:, :, rows, None, :] * kc[:, :, None, rows, :] * e).sum(-1)
            P[:, :, rows, rows] = torch.tril(d, diagonal=-1)
            bonus = (rc[:, :, rows] * u32 * kc[:, :, rows]).sum(-1)
            P[:, :, rows, rows] += torch.diag_embed(bonus)
        rd = rc * ex2(x)                                   # r'
        kd = kc * ex2(cum[:, :, -1:] - cum)                # k'
        dec = ex2(cum[:, :, -1])                           # (B, H, hd)
        groups_out, groups_state = [], []
        for j0 in range(0, hd, COLS):  # one cluster block per group of 16 columns
            cols = slice(j0, j0 + COLS)
            st = state[..., cols]
            groups_out.append(rd @ st + P @ vc[..., cols])
            groups_state.append(dec[..., None] * st + kd.transpose(-1, -2) @ vc[..., cols])
        out[:, :, t0:t0 + n] = torch.cat(groups_out, -1)[:, :, :n]
        state = torch.cat(groups_state, -1)
    return out.permute(0, 2, 1, 3).to(r.dtype), state


def _inputs(seed, B, S, H, hd, logw=None):
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32) for _ in range(3))
    if logw is None:  # as the reference test draws it
        lw = -np.exp(np.clip(rng.standard_normal((B, S, H, hd)) * 0.5 - 2.0, -8, 1))
    else:
        lw = np.full((B, S, H, hd), logw)
    u = (rng.standard_normal((H, hd)) * 0.5).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u


def _heads_first(x):
    B, S, H, hd = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, hd))


def _sequential(r, k, v, lw, u):
    """The JAX sequential oracle, back in (B, S, H, hd)."""
    B, S, H, hd = r.shape
    ref = jref.wkv_ref(*(_heads_first(t) for t in (r, k, v, lw)), jnp.tile(jnp.asarray(u), (B, 1)))
    return np.asarray(ref).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


def _emulate(*arrays, state0=None, exponents=None):
    out, state = wkv_emulated(*(torch.from_numpy(t) for t in arrays),
                              None if state0 is None else torch.from_numpy(state0),
                              exponents=exponents)
    return out.numpy(), state.numpy()


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("S", [64, 128])
def test_wkv_emulation_matches_pallas_and_oracle(hd, S):
    B, H = 2, 2
    r, k, v, lw, u = _inputs(hd + S, B, S, H, hd)
    out, _ = _emulate(r, k, v, lw, u)
    pallas = jwkv(*(_heads_first(t) for t in (r, k, v, lw)), jnp.tile(jnp.asarray(u), (B, 1)),
                  chunk=64)
    pallas = np.asarray(pallas).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    for ref in (pallas, _sequential(r, k, v, lw, u)):
        np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("S", [1, 37, 100, 128, 150])
def test_wkv_emulation_ragged_s_with_state_matches_the_model(hd, S):
    """Ragged S and a state0: against the sequential torch oracle (any S) and,
    where the chunk divides S, the model's chunked_wkv with its state."""
    B, H = 2, 3
    r, k, v, lw, u = _inputs(7 * hd + S, B, S, H, hd)
    s0 = (np.random.default_rng(S).standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32)
    out, state = _emulate(r, k, v, lw, u, state0=s0)
    ref, ref_state = tref.wkv_ref(*(torch.from_numpy(t) for t in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(out, ref.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state, ref_state.numpy(), rtol=2e-3, atol=2e-3)
    if S > 64 and S % 64:
        return  # the model's chunked form asserts that its chunk divides S
    jout, jstate = jchunked_wkv(*(jnp.asarray(t) for t in (r, k, v, lw, u, s0)))
    np.testing.assert_allclose(out, np.asarray(jout), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(state, np.asarray(jstate), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("S", [128, 200])
def test_wkv_emulation_is_finite_at_the_strongest_decay(hd, S):
    """logw = -e^2, the model's bound: the Pallas kernel (and the model's
    chunked form) overflow to NaN; the emulation equals the sequential
    oracle, and no exponent it forms is above 0 beyond the scan's rounding."""
    B, H = 2, 2
    r, k, v, lw, u = _inputs(3 * S + hd, B, S, H, hd, logw=-math.e ** 2)
    exps = []
    out, state = _emulate(r, k, v, lw, u, exponents=exps)
    assert np.isfinite(out).all() and np.isfinite(state).all()
    np.testing.assert_allclose(out, _sequential(r, k, v, lw, u), rtol=2e-3, atol=2e-3)
    assert max(exps) <= 0.0
    if S % 64 == 0:
        pallas = jwkv(*(_heads_first(t) for t in (r, k, v, lw)),
                      jnp.tile(jnp.asarray(u), (B, 1)), chunk=64)
        assert np.isnan(np.asarray(pallas)).any()


def test_wkv_emulation_exponents_are_never_positive():
    """Every exponent, across the decay range the model draws, is <= 0 as
    formed: the cumulative sums are monotone, so the clamp never acts on a
    difference that is positive by more than nothing."""
    B, S, H, hd = 2, 150, 2, 32
    r, k, v, lw, u = _inputs(77, B, S, H, hd)
    lw = -np.exp(np.random.default_rng(78).uniform(-20.0, 2.0, lw.shape)).astype(np.float32)
    exps = []
    out, _ = _emulate(r, k, v, lw, u, exponents=exps)
    assert len(exps) > 0 and max(exps) <= 0.0
    np.testing.assert_allclose(out, _sequential(r, k, v, lw, u), rtol=2e-3, atol=2e-3)


def test_wkv_emulation_column_groups_are_independent():
    """The cluster's split: out[..., j] and the state's column j depend only
    on v[..., j], so changing one group's v leaves the other groups exact."""
    B, S, H, hd = 1, 96, 2, 64
    r, k, v, lw, u = _inputs(91, B, S, H, hd)
    out, state = _emulate(r, k, v, lw, u)
    v2 = v.copy()
    v2[..., 16:32] = -v2[..., 16:32]
    out2, state2 = _emulate(r, k, v2, lw, u)
    keep = np.r_[0:16, 32:64]
    np.testing.assert_array_equal(out[..., keep], out2[..., keep])
    np.testing.assert_array_equal(state[..., keep], state2[..., keep])
    np.testing.assert_allclose(out2[..., 16:32], -out[..., 16:32], rtol=1e-6, atol=1e-6)
