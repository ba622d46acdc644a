"""The ``rglru_scan`` kernel's arithmetic (``csrc/rglru_scan.cu``), on the CPU.

The kernel cannot run here, so its arithmetic is emulated in plain PyTorch
(``lookback_scan``): segments of 128 steps, each split into 4 warps of 4
runs of 8 steps; each run scanned from h = 0 into (prod a, h); the runs'
pairs scanned across each warp as the shuffles do (Hillis-Steele) and the
warps' totals composed in order into the segment's aggregate; the
look-back composing the earlier segments' aggregates until it meets one
that has published its inclusive state (which segments have published,
when a successor looks, is drawn at random: any mix must give the same
numbers); then each run's recurrence from its incoming state, carried
through the warps and the runs before it.  The emulation is held against the Pallas kernel
(interpret mode) and the sequential oracle at the reference's 1e-4, and
against the model's ``_lru_scan``, at segment counts that do not divide S
and on long-memory decays (a tenth above 0.99, as ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru import rglru_scan as jrglru
from repro.models.rglru import _lru_scan as jlru_scan

STEPS, RUNS, WARPS = 8, 4, 4  # steps a run, runs a warp, warps a segment
SEG = STEPS * RUNS * WARPS


def _compose(later, earlier):
    (a2, h2), (a1, h1) = later, earlier
    return a2 * a1, a2 * h1 + h2


def _pair(a, b):
    """(prod a, h from 0) over dim 1 of (B, n, W), sequentially, in f32."""
    pa = torch.ones_like(a[:, 0])
    ph = torch.zeros_like(a[:, 0])
    for j in range(a.shape[1]):
        ph = a[:, j] * ph + b[:, j]
        pa = pa * a[:, j]
    return pa, ph


def lookback_scan(a, b, *, inclusive_p=0.5, seed=0):
    """The kernel's arithmetic on (B, S, W) a, b; h in a's dtype.

    ``inclusive_p`` is the chance that a predecessor has already published
    its inclusive state when the look-back reads it (segment 0 always has);
    returns (h, the deepest walk taken).
    """
    rng = np.random.default_rng(seed)
    B, S, W = a.shape
    n_seg = -(-S // SEG)
    pad = n_seg * SEG - S  # steps past S read a = 1, b = 0
    a32 = torch.cat([a.float(), torch.ones(B, pad, W)], 1)
    b32 = torch.cat([b.float(), torch.zeros(B, pad, W)], 1)
    ident = (torch.ones(B, W), torch.zeros(B, W))
    aggs, incls, out, deepest = [], [], torch.empty(B, n_seg * SEG, W), 0
    for s in range(n_seg):
        excl, totals = [], []
        for w in range(WARPS):  # each warp's inclusive scan over its runs
            t = s * SEG + w * RUNS * STEPS
            inc = [_pair(a32[:, t + g * STEPS:t + (g + 1) * STEPS],
                         b32[:, t + g * STEPS:t + (g + 1) * STEPS]) for g in range(RUNS)]
            d = 1
            while d < RUNS:
                inc = [_compose(inc[g], inc[g - d]) if g >= d else inc[g] for g in range(RUNS)]
                d *= 2
            excl.append([ident] + inc[:-1])
            totals.append(inc[-1])
        sa, sh = ident
        for wa, wh in totals:  # compose the warps in order
            sh = wa * sh + wh
            sa = sa * wa
        aggs.append((sa, sh))
        h_in, ta, th, p = torch.zeros(B, W), torch.ones(B, W), torch.zeros(B, W), s - 1
        while p >= 0:
            if p == 0 or rng.random() < inclusive_p:
                h_in = ta * incls[p] + th
                break
            th = ta * aggs[p][1] + th
            ta = ta * aggs[p][0]
            p -= 1
        deepest = max(deepest, s - 1 - max(p, 0))
        incls.append(sa * h_in + sh)
        for w in range(WARPS):  # each run from its incoming state
            h_w = h_in
            for wa, wh in totals[:w]:
                h_w = wa * h_w + wh
            for g in range(RUNS):
                ea, eh = excl[w][g]
                carry = ea * h_w + eh
                t0 = s * SEG + (w * RUNS + g) * STEPS
                for j in range(STEPS):
                    carry = a32[:, t0 + j] * carry + b32[:, t0 + j]
                    out[:, t0 + j] = carry
    return out[:, :S].to(a.dtype), deepest


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) ** 0.1).astype(np.float32)  # a tenth above 0.99
    return a, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(300, 100), (200, 40), (128, 64), (520, 104), (1, 1),
                                     (1000, 200)])
@pytest.mark.parametrize("inclusive_p", [0.0, 0.5, 1.0])
def test_lookback_matches_pallas_and_oracle(S, chunk, inclusive_p):
    a, b = _inputs(S, (2, S, 12))
    out, deepest = lookback_scan(torch.from_numpy(a), torch.from_numpy(b),
                                 inclusive_p=inclusive_p, seed=S)
    n_seg = -(-S // SEG)
    if inclusive_p == 0.0:  # every walk reaches segment 0
        assert deepest == max(0, n_seg - 2)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pallas = np.asarray(jrglru(ja, jb, chunk=chunk))
    np.testing.assert_allclose(out.numpy(), pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.rglru_scan_ref(ja, jb)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S", [130, 256])
def test_lookback_matches_model_lru_scan(S):
    a, b = _inputs(7 + S, (3, S, 8))
    out, _ = lookback_scan(torch.from_numpy(a), torch.from_numpy(b), seed=S)
    np.testing.assert_allclose(out.numpy(), np.asarray(jlru_scan(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-4, atol=1e-4)


def test_lookback_bf16_within_one_ulp():
    a, b = _inputs(11, (2, 200, 16))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    out, _ = lookback_scan(ta, tb, seed=3)
    ref = torch.from_numpy(np.array(jref.rglru_scan_ref(
        jnp.asarray(ta.float().numpy()), jnp.asarray(tb.float().numpy()))))
    assert out.dtype == torch.bfloat16
    assert bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-4).all())
