"""The RWKV-6 WKV: linear attention with a data-dependent decay.

Replaces ``src/repro/kernels/rwkv6.py:wkv`` (``_wkv_kernel``).  The kernel
is ``csrc/wkv.cu``.  The value columns are independent, so a block of 128
threads owns (batch row, head, 16 value columns) and its (hd x 16) slice of
the f32 state; the hd / 16 blocks of one (batch row, head) run as a
thread-block cluster.  They loop over chunks of 64 tokens (in place of the
TPU's sequential chunk axis and its VMEM state), staging each chunk with
``cp.async`` while the previous one computes.  Per chunk each block forms
the rows of the masked (64 x 64) intra-chunk matrix P for the 16-token
sub-chunks it owns, and reads the others' rows through distributed shared
memory, so P's flops are those of one P per (batch row, head); the
off-diagonal sub-blocks of P are plain products of r and k decayed to a
sub-chunk's start, and only the diagonal ones take one exponential per
(query, key, channel).  It is bound by operations on the f32 CUDA cores
(the decays are f32): per chunk of n tokens, 4 * hd flops per live
(query, key) pair and 4 * hd^2 per token.

It reads the model's (B, S, H, hd) layout in place: no transpose around
it.  Numbers: every product in f32, out cast to r's dtype, the final state
f32.  Where the reference forms ``k * exp(-cum)``, which overflows f32
inside the model's decay range (``logw`` down to ``-e^2``; ROADMAP.md queue
3), the kernel takes every decay as ``exp`` of a difference of cumulative
log-decays clamped to <= 0, so it stays finite and equal to the sequential
recurrence there.  The last chunk may be ragged: the reference's
``S % chunk == 0`` assert is not kept.

Gradient: :class:`Wkv` runs the kernel forward and differentiates a
chunked plain form that stays finite over the whole decay range.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import wkv_chunked_ref, wkv_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)


def wkv(r, k, v, logw, u, state0=None):
    """r, k, v: (B, S, H, hd) of one dtype; logw: (B, S, H, hd) f32, <= 0;
    u: (H, hd); state0: (B, H, hd, hd) f32 or None for zeros.

    Returns (out (B, S, H, hd) in r's dtype, final state (B, H, hd, hd)
    f32).  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel or raises.  Both outputs carry gradients (:class:`Wkv`).
    """
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"logw {tuple(logw.shape)}; need four equal (B, S, H, hd)")
    B, S, H, hd = r.shape
    if u.shape != (H, hd):
        raise ValueError(f"wkv: u {tuple(u.shape)}, need ({H}, {hd})")
    if state0 is not None and state0.shape != (B, H, hd, hd):
        raise ValueError(f"wkv: state0 {tuple(state0.shape)}, need ({B}, {H}, {hd}, {hd})")
    operands = (k, v, logw, u) + (() if state0 is None else (state0,))
    if any(t.device != r.device for t in operands):
        raise ValueError("wkv: operands lie on different devices")
    if k.dtype != r.dtype or v.dtype != r.dtype or r.dtype not in DTYPES:
        raise TypeError(f"wkv: r, k, v dtypes {r.dtype}, {k.dtype}, {v.dtype}; "
                        "need one of float32, bfloat16 for all three")
    if logw.dtype != torch.float32 or (state0 is not None and state0.dtype != torch.float32):
        raise TypeError("wkv: logw and state0 must be float32")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv: unsupported device {r.device}")
    if r.device.type == "cuda":
        if hd not in HEAD_DIMS:
            raise ValueError(f"wkv: head dim {hd} not in {HEAD_DIMS}")
        if not all(t.is_contiguous() for t in (r,) + operands):
            raise ValueError("wkv: operands must be contiguous")
    return Wkv.apply(r, k, v, logw, u, state0)


def _wkv(r, k, v, logw, u, state0):
    """The plain version on the CPU; on the card, the kernel."""
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, logw, u, state0)
    B, S, H, hd = r.shape
    # The kernel stages its operands by 16-byte copies: an operand that is a
    # view at an unaligned offset is copied to a fresh (aligned) tensor.
    r, k, v, logw = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, logw))
    u32 = u.float().contiguous()
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        rc = _build.library().repro_wkv(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u32.data_ptr(),
            None if state0 is None else state0.data_ptr(), out.data_ptr(), state.data_ptr(),
            DTYPES[r.dtype], B, S, H, hd, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "wkv")
    wkv.launches += 1
    return out, state


class Wkv(torch.autograd.Function):
    """The kernel forward with the gradient of a chunked plain form.

    The JAX package has no backward kernel; it trains through
    ``chunked_wkv``, whose ``k * exp(-cum)`` overflows inside the model's
    decay range.  The backward recomputes the recurrence by
    ``ref.wkv_chunked_ref`` (``WKV_CHUNK`` = 16-token chunks, every decay the ``exp`` of a
    difference of cumulative log-decays <= 0) and differentiates it
    (:func:`wkv_grad`).  It saves the inputs; the final state's gradient
    may be absent.
    """

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        ctx.set_materialize_grads(False)
        return _wkv(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, g_out, g_state):
        return wkv_grad(*ctx.saved_tensors, g_out, g_state)


def wkv_grad(r, k, v, logw, u, state0, g_out, g_state):
    """Gradients of (out, final state) = wkv(r, k, v, logw, u, state0) for
    r, k, v, logw, u and state0 (None where ``state0`` is None), against
    ``g_out`` and ``g_state`` (either may be None), by autograd through
    ``wkv_chunked_ref``."""
    inputs = (r, k, v, logw, u, state0)
    if g_out is None and g_state is None:
        return (None,) * len(inputs)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_() for t in inputs]
        out, state = wkv_chunked_ref(*leaves)
        pairs = [(o, g) for o, g in ((out, g_out), (state, g_state)) if g is not None]
        wrt = [t for t in leaves if t is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                         allow_unused=True))
    return tuple(None if t is None else next(grads) for t in leaves)


wkv.launches = 0


def wkv_launch_info(dtype, hd: int) -> dict:
    """The kernel's launch at (dtype, hd) on the current card: blocks per
    cluster, dynamic shared memory per block, and the clusters the card can
    hold at once (``cudaOccupancyMaxActiveClusters``)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    rc = _build.library().repro_wkv_info(DTYPES[dtype], hd,
                                         *(ctypes.addressof(x) for x in vals))
    _build.check(rc, "wkv launch info")
    return dict(zip(("cluster", "smem_bytes", "max_active_clusters"), (x.value for x in vals)))
