"""The ``mma_sync`` flash route's arithmetic (``csrc/flash_attention.cu``), on the CPU.

The kernel cannot run here, so its arithmetic is emulated in plain PyTorch
(``mma_flash``): each f32 operand split into ``hi`` (x with its low 13 bits
cleared, exact in TF32) and ``lo = x - hi``, of which the mma reads the
TF32 part (its low 13 bits ignored); each product taken as hi*hi + hi*lo +
lo*hi, products of TF32 values being exact in f32; Q pre-scaled in f32 (bf16:
the scale on the f32 logits, Q K^T one product and P V two); the online
softmax in base 2 over the kernel's key tiles (64 keys, 32 at d = 256).
The emulation is held against the Pallas kernel (interpret mode) at the
reference test's 2e-4 and against the plain version at the chip limit of
``chip_smoke.py``, 1e-4 of max(1, max|ref|), for causal, windowed and
ragged S at d 16 to 256, and the same with the split rounding to nearest
(``cvt.rna.tf32.f32``, ties away from zero).  Beside it, plain TF32 (one
product, operands rounded once to nearest) is shown to break that limit:
it is why the kernel splits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ref as tref

NEG_INF = -2.0e38
LOG2E = 1.4426950408889634
CHIP_RTOL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as cvt.rna rounds it: to nearest, ties away, low 13 bits 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 by clearing the low 13 bits, as the mma reads an operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x, rounding="trunc"):
    """(hi, lo) as the mma reads them: hi exact in TF32, lo = x - hi truncated."""
    hi = trunc(x) if rounding == "trunc" else tf32(x)
    return hi, trunc(x - hi)


def product(a, b, terms: int, rounding="trunc"):
    """a @ b with TF32 operands: 3 = hi*hi + hi*lo + lo*hi, 2 = b exact (a
    split), 1 = both rounded once to nearest."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    (ah, al), (bh, bl) = split(a, rounding), split(b, rounding)
    if terms == 2:
        return al @ b + ah @ b
    return al @ bh + ah @ bl + ah @ bh


def mma_flash(q, k, v, window=0, *, terms=None, rounding="trunc"):
    """The kernel's arithmetic on (BH, S, d) q, k, v of one dtype.

    ``terms`` forces the products' form (1 for plain TF32); by default f32
    takes 3 and bf16 takes 1 for Q K^T and 2 for P V, as the kernel does.
    ``rounding="rna"`` takes hi to nearest (cvt.rna) in place of truncation.
    """
    BH, S, d = q.shape
    exact = q.dtype == torch.bfloat16
    bkv = 32 if d == 256 else 64
    scale = torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32)
    q32, k32, v32 = q.float(), k.float(), v.float()
    if not exact:
        q32 = q32 * scale                          # as the reference scales it
    mult = scale * LOG2E if exact else torch.tensor(LOG2E, dtype=torch.float32)
    qk_terms = terms or (1 if exact else 3)
    pv_terms = terms or (2 if exact else 3)
    m = torch.full((BH, S, 1), NEG_INF)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, d))
    qi = torch.arange(S)[:, None]
    for k0 in range(0, S, bkv):
        kj = torch.arange(k0, min(k0 + bkv, S))[None, :]
        s = product(q32, k32[:, k0:k0 + bkv].transpose(1, 2), qk_terms, rounding) * mult
        live = kj <= qi
        if window > 0:
            live &= kj > qi - window
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, v32[:, k0:k0 + bkv], pv_terms, rounding)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _inputs(seed, BH, S, d, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((BH, S, d)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _rel(out, ref) -> float:
    ref = ref.float()
    return (out.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def _pallas(q, k, v, window, block):
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for t in (q, k, v))
    out = jflash(jq, jk, jv, window=window, bq=block, bkv=block)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    assert torch.equal(trunc(x), torch.tensor([one, -one, one, one + ulp, 3.0, 0.0]))
    for rounding in ("trunc", "rna"):
        hi, lo = split(torch.tensor([1.0 / 3.0]), rounding)
        assert abs((hi + lo).item() - 1.0 / 3.0) <= 2.0 ** -20 / 3


@pytest.mark.parametrize("rounding", ["trunc", "rna"])
@pytest.mark.parametrize("BH,S,d,window", [
    (2, 128, 16, 0), (2, 128, 32, 48), (2, 192, 64, 0), (2, 128, 128, 0),
    (2, 192, 128, 64), (1, 128, 256, 0), (1, 192, 256, 40),
])
def test_emulated_mma_flash_matches_pallas_and_plain(BH, S, d, window, rounding):
    q, k, v = _inputs(BH * S + d + window, BH, S, d)
    out = mma_flash(q, k, v, window, rounding=rounding)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    assert _rel(out, tref.flash_attention_ref(q, k, v, window=window)) <= CHIP_RTOL
    pallas = _pallas(q, k, v, window, 64)
    np.testing.assert_allclose(out.numpy(), pallas.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,d,window", [(1, 16, 0), (77, 32, 16), (200, 128, 0),
                                        (130, 256, 64), (100, 64, 33)])
def test_emulated_mma_flash_ragged_s(S, d, window):
    """Ragged S (the Pallas kernel asserts S % bq == 0; its oracle does not)."""
    q, k, v = _inputs(S + d, 2, S, d)
    out = mma_flash(q, k, v, window)
    assert _rel(out, tref.flash_attention_ref(q, k, v, window=window)) <= CHIP_RTOL
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, window=window))
    np.testing.assert_allclose(out.numpy(), oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d,window", [(16, 0), (32, 24)])
def test_emulated_mma_flash_bf16(d, window):
    """bf16 at d 16 / 32 (this route's bf16 shapes): one Q K^T product, P
    split against exact V, within one bf16 ulp of the plain version."""
    q, k, v = _inputs(d + window, 2, 128, d, torch.bfloat16)
    out = mma_flash(q, k, v, window)
    ref = tref.flash_attention_ref(q, k, v, window=window).float()
    assert out.dtype == torch.bfloat16
    assert bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-5).all())
    pallas = _pallas(q, k, v, window, 64)
    assert bool(((out.float() - pallas).abs() <= 2.0 ** -7 * pallas.abs() + 1e-5).all())


@pytest.mark.parametrize("d", [64, 128])
def test_plain_tf32_breaks_the_f32_limit(d):
    """What the split buys: with operands rounded once to TF32, row 0 (which
    is V's row 0) alone is off by up to 2^-11 relative, several times the
    1e-4 limit; 3xTF32 on the same inputs stays within it."""
    q, k, v = _inputs(3, 2, 256, d)
    ref = tref.flash_attention_ref(q, k, v)
    assert _rel(mma_flash(q, k, v), ref) <= CHIP_RTOL
    assert _rel(mma_flash(q, k, v, terms=1), ref) > 2 * CHIP_RTOL
