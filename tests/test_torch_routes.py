"""The kernel routes of the port's GEMM and flash attention, on the CPU.

``gemm_route`` and ``flash_route`` are pure functions of dtype, shape and
alignment that choose between the tensor-core kernels (``csrc/*_wgmma.cu``,
``csrc/gemm_tf32x3.cu``) and the others (the CUDA-core ``gemm.cu``, the
``mma.sync`` flash kernel); they are held here to their stated rules.

The f32 tensor-core GEMM (``tf32x3``) cannot run here either, so its
arithmetic is emulated (``tf32x3_gemm``: each operand split into a TF32 hi
and lo, three TF32 products summed in f32) and held within the card
tests' f32 tolerance of an f64 product at the SUMMA step's and the FCL
partials' depths; one TF32 product alone breaks it.

The tensor-core flash kernel cannot run here, so its arithmetic is emulated
in plain PyTorch (``wgmma_flash``): exact bf16 products summed in f32, the
scale applied to the f32 logits, an online softmax over 64-key tiles, and
P split into ``bf16(P) + bf16(P - bf16(P))`` for P V.  The emulation is held
against the Pallas kernel (interpret mode) and the plain version at the
bf16 limit of ``chip_smoke.py`` (one bf16 ulp: 2^-7 of |ref| plus 1e-5 per
element).  Beside it, the two cheaper variants that the kernel does not use
(a single bf16 P, and Q pre-scaled in bf16 at d = 128) are shown to break
that limit: they are why the kernel splits P and scales in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_route
from repro_torch.kernels.gemm import gemm_route

BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-5
NEG_INF = -2.0e38


# -- route rules ------------------------------------------------------------

@pytest.mark.parametrize("dtype,K,N,ptrs,route", [
    (torch.bfloat16, 64, 128, (0, 256, 4096), "tensor_core"),
    (torch.bfloat16, 8, 8, (16, 32), "tensor_core"),          # K = 8: one partial tile
    (torch.bfloat16, 1024, 2752, (), "tensor_core"),         # the SUMMA step
    (torch.bfloat16, 328, 776, (0, 16), "tensor_core"),      # ragged M / N / K tiles
    (torch.bfloat16, 333, 776, (0, 16), "cuda_core"),        # K % 8 != 0
    (torch.bfloat16, 4096, 777, (0, 16), "cuda_core"),       # N % 8 != 0
    (torch.bfloat16, 0, 8, (), "cuda_core"),                 # no product
    (torch.bfloat16, 64, 64, (0, 8), "cuda_core"),           # an 8-byte aligned operand
    (torch.bfloat16, 64, 64, (2, 0), "cuda_core"),
    (torch.float32, 64, 128, (0, 256), "tf32x3"),            # f32 on the tensor cores, 3xTF32
    (torch.float32, 4096, 4096, (), "tf32x3"),
    (torch.float32, 1024, 2752, (0, 256, 512), "tf32x3"),    # the SUMMA step (+C)
    (torch.float32, 512, 4096, (0, 256, 512), "tf32x3"),     # the FCL partials
    (torch.float32, 4, 4, (16, 32), "tf32x3"),               # K = 4: one partial k step
    (torch.float32, 333, 776, (0, 16), "cuda_core"),         # K % 4 != 0
    (torch.float32, 1024, 777, (0, 16), "cuda_core"),        # N % 4 != 0
    (torch.float32, 0, 4, (), "cuda_core"),                  # no product
    (torch.float32, 64, 64, (0, 8), "cuda_core"),            # an 8-byte aligned operand
])
def test_gemm_route(dtype, K, N, ptrs, route):
    assert gemm_route(dtype, K, N, ptrs) == route


# -- the tf32x3 gemm arithmetic, emulated -------------------------------------

def tf32(x):
    """x with its low 13 mantissa bits cleared: exact in TF32, as the
    tensor core reads an f32 word."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def tf32x3_gemm(a, b, *, products=3):
    """``csrc/gemm_tf32x3.cu``'s arithmetic on f32 a (M, K) and b (K, N):
    hi = tf32(x), lo = x - hi (read as TF32), lo*hi + hi*lo + hi*hi, each
    TF32 product exact in f32 and summed in f32.  ``products=1`` is one
    TF32 product, hi*hi, which the kernel does not use."""
    a_hi, b_hi = tf32(a), tf32(b)
    if products == 1:
        return a_hi @ b_hi
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


@pytest.mark.parametrize("K", [1024, 512])  # the SUMMA step's and the FCL partials' depth
@pytest.mark.parametrize("products,holds", [(3, True), (1, False)])
def test_tf32x3_emulation_keeps_f32_accuracy(K, products, holds):
    rng = np.random.default_rng(K)
    a, b, c = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((64, K), (K, 128), (64, 128)))
    ref = a.double() @ b.double() + c.double()
    out = tf32x3_gemm(a, b, products=products) + c
    # the card tests' f32 limit: 1e-4 of max(1, max|ref|)
    err = (out.double() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert (err <= 1e-4) == holds, err


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_route_by_dtype_and_head_dim(dtype, d):
    want = "tensor_core" if dtype == torch.bfloat16 and d in (64, 128, 256) else "mma_sync"
    assert flash_route(dtype, d, (0, 16, 4096)) == want


@pytest.mark.parametrize("ptrs", [(8, 0, 0, 0), (0, 0, 2, 0), (0, 0, 0, 24)])
def test_flash_route_needs_16_byte_alignment(ptrs):
    assert flash_route(torch.bfloat16, 128, ptrs) == "mma_sync"
    assert flash_route(torch.bfloat16, 128, tuple(p * 16 for p in ptrs)) == "tensor_core"


# -- the tensor-core flash arithmetic, emulated -------------------------------

def wgmma_flash(q, k, v, window=0, *, split_p=True, prescale_q=False, bkv=64):
    """The kernel's arithmetic on bf16 (BH, S, d) q, k, v, in plain PyTorch.

    ``split_p=False`` rounds P once to bf16 (as FlashAttention-2 does);
    ``prescale_q=True`` rounds ``q * scale`` to bf16 before Q K^T.  Neither
    is what the kernel does.
    """
    BH, S, d = q.shape
    scale = 1.0 / (d ** 0.5)
    q32, k32, v32 = q.float(), k.float(), v.float()  # bf16 products are exact in f32
    if prescale_q:
        q32 = (q32 * scale).to(torch.bfloat16).float()
    m = torch.full((BH, S, 1), NEG_INF)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, d))
    qi = torch.arange(S)[:, None]
    for k0 in range(0, S, bkv):
        kj = torch.arange(k0, min(k0 + bkv, S))[None, :]
        s = q32 @ k32[:, k0:k0 + bkv].transpose(1, 2)
        if not prescale_q:
            s = s * scale                          # on the f32 logits
        live = kj <= qi
        if window > 0:
            live &= kj > qi - window
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ v32[:, k0:k0 + bkv]
        if split_p:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ v32[:, k0:k0 + bkv]
        acc = acc * alpha + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def _inputs(seed, BH, S, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, d)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(3)]


def _limit_ratio(out, ref) -> float:
    """The worst element's share of the bf16 limit; above 1 fails."""
    diff = (out.float() - ref.float()).abs()
    return (diff / (BF16_RTOL * ref.float().abs() + BF16_ATOL)).max().item()


@pytest.mark.parametrize("BH,S,d,window", [
    (4, 256, 64, 0), (4, 256, 128, 0), (2, 256, 256, 0),
    (4, 192, 128, 48), (2, 256, 256, 128),
])
def test_emulated_wgmma_flash_matches_pallas_and_plain(BH, S, d, window):
    q, k, v = _inputs(BH * S + d + window, BH, S, d)
    out = wgmma_flash(q, k, v, window)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    assert _limit_ratio(out, tref.flash_attention_ref(q, k, v, window=window)) <= 1.0
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    pallas = torch.from_numpy(np.array(
        jflash(jq, jk, jv, window=window, bq=64, bkv=64).astype(jnp.float32)))
    oracle = torch.from_numpy(np.array(
        jref.flash_attention_ref(jq, jk, jv, window=window).astype(jnp.float32)))
    assert _limit_ratio(out, pallas) <= 1.0
    assert _limit_ratio(out, oracle) <= 1.0


@pytest.mark.parametrize("S,window", [(200, 0), (77, 16), (130, 64)])
def test_emulated_wgmma_flash_ragged_tiles(S, window):
    q, k, v = _inputs(S + window, 3, S, 128)
    out = wgmma_flash(q, k, v, window)
    assert _limit_ratio(out, tref.flash_attention_ref(q, k, v, window=window)) <= 1.0


@pytest.mark.parametrize("variant", ["single_bf16_p", "bf16_prescaled_q"])
def test_cheaper_flash_arithmetic_breaks_the_bf16_limit(variant):
    """What the kernel's design avoids: each cheaper variant exceeds the
    one-ulp limit at d = 128 (where 1/sqrt(d) is not a power of two)."""
    q, k, v = _inputs(7, 4, 512, 128)
    ref = tref.flash_attention_ref(q, k, v)
    assert _limit_ratio(wgmma_flash(q, k, v), ref) <= 1.0
    kw = {"split_p": False} if variant == "single_bf16_p" else {"prescale_q": True}
    assert _limit_ratio(wgmma_flash(q, k, v, **kw), ref) > 4.0
