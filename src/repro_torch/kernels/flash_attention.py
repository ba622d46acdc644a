"""Causal (optionally sliding-window) flash attention, forward.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention``
(``_flash_kernel``) with two hand-written kernels; :func:`flash_route`
chooses between them by dtype and head dim:

- ``tensor_core``, ``csrc/flash_attention_wgmma.cu``: bf16 at d in {64,
  128, 256}.  Q, K and V reach shared memory by TMA (K and V through a
  two-slot mbarrier ring fed by a producer warp); S = Q K^T and O += P V
  are ``wgmma`` products with f32 accumulators, one consumer warpgroup per
  64 queries (two per block at d <= 128, one at d = 256).  ``scale``
  multiplies the f32 logits (Q is not pre-scaled in bf16), and P enters
  P V as ``bf16(P) + bf16(P - bf16(P))``, two products that keep it at
  f32 accuracy.  Bound: 4 * d flops per live (query, key) pair at the
  bf16 tensor-core rate.
- ``mma_sync``, ``csrc/flash_attention.cu``: f32, and bf16 at d in {16,
  32}, on warp-level tensor cores at f32 accuracy.  A block of 8 warps (4
  at d = 256) owns 16 queries a warp and loops over 64-key tiles (32 at
  d = 256) inside the block, in place of the TPU's sequential kv grid axis
  and its VMEM scratch; K and V tiles arrive in their own buffers of a
  two-stage ``cp.async`` ring.  S = Q K^T and O += P V are
  ``mma.sync.m16n8k8`` TF32 products in f32 accumulators, each f32 operand
  split into ``hi`` (x with its low 13 bits cleared) and ``lo = x - hi``
  and each product taken as hi*hi + hi*lo + lo*hi (3xTF32); bf16 operands
  are exact in TF32, so Q K^T is one product and P V two.  Bound: 4 * d
  flops per live pair, the least of that at the f32 CUDA-core rate and
  three times it at the TF32 tensor-core rate.

Both visit only the kv tiles that hold a live key for some query of the
block, so a sliding-window layer costs O(S * window).  The numbers are the
reference kernel's: logits ``(q * scale) @ k^T`` in f32 with ``scale = 1 /
sqrt(d)``, masked logits at -2e38, the output ``acc / max(l, 1e-30)`` cast
to q's dtype; ``p`` stays at f32 accuracy through ``P @ V``.  The ragged
last tiles are masked, so S need not divide by any tile: the reference's
``S % bq == 0`` assert is not kept, and ``bq`` / ``bkv`` are accepted for
its signature without changing the result.

Gradient: :class:`FlashAttention` runs the kernel forward and
differentiates the plain version in the backward (the JAX package has no
backward kernel either).

Binding: the kernel is also the opaque op ``torch.ops.repro_torch.flash_attention``
(``torch.library.custom_op``), whose CUDA implementation is the launch
(the route picked) that a run calls directly (``_build.traced``); a trace
goes through the op, whose fake implementation gives the output's
shape, so a trace under ``FakeTensorMode`` or on meta tensors (the dry
run, ``launch/dryrun.py``) never reaches ``data_ptr()`` or the library,
and its FLOP formula (``torch.utils.flop_counter``) is the bound's
convention: 4 * d per live (query, key) pair of the causal, windowed mask
(:func:`causal_pairs`), per head.  ``flash_attention.launches`` and
``.route_launches`` count real launches only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_DIMS = (64, 128, 256)
ROUTES = ("mma_sync", "tensor_core")


def flash_route(dtype, d: int, ptrs=()) -> str:
    """The kernel a call on the card takes.

    ``tensor_core`` for bfloat16 at d in (64, 128, 256) when every address
    in ``ptrs`` (the operands' ``data_ptr()``) is a multiple of 16, as TMA
    needs; ``mma_sync`` for float32 and for bfloat16 at d in (16, 32).
    """
    if dtype == torch.bfloat16 and d in TENSOR_CORE_DIMS and all(p % 16 == 0 for p in ptrs):
        return "tensor_core"
    return "mma_sync"


def flash_attention(q, k, v, *, window: int = 0, bq: int = 128, bkv: int = 128,
                    _route: str | None = None):
    """Causal self-attention over (BH, S, d) q, k, v; the output in q's dtype.

    ``window > 0`` keeps, for query i, only keys j with i - window < j <= i.
    Operands of mixed float dtypes are cast to float32 (exact from
    bfloat16) and take the float32 route, as the reference casts each block
    to f32 on load.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel that :func:`flash_route` names, or raises (a fake or
    meta tensor of a trace gets the output's shape from the op, and nothing
    launches).
    ``_route`` forces one route, for timing the two against each other on
    the card; a call outside the forced route's rule raises.  The output
    carries a gradient (:class:`FlashAttention`).
    """
    del bq, bkv  # the TPU's block shape; the CUDA kernel tiles itself
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; need three equal (BH, S, d)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands lie on different devices")
    if any(t.dtype not in DTYPES for t in (q, k, v)):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        "need float32 or bfloat16 for all three")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        return flash_attention(q.float(), k.float(), v.float(), window=window,
                               _route=_route).to(q.dtype)
    if _route is not None and (_route not in ROUTES or (
            _route == "tensor_core" and flash_route(q.dtype, q.shape[2]) != _route)):
        raise ValueError(f"flash_attention: route {_route!r} does not take {q.dtype} "
                         f"d={q.shape[2]}")
    if q.device.type != "cpu":
        if q.shape[2] not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {q.shape[2]} not in {HEAD_DIMS}")
        if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
            raise ValueError("flash_attention: operands must be contiguous")
    return FlashAttention.apply(q, k, v, int(window), _route)


def _forward(q, k, v, window: int, _route):
    """The plain version on the CPU; on the card, the kernel (its op under a
    trace)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    launch = torch.ops.repro_torch.flash_attention if _build.traced(q, k, v) else _launch
    return launch(q, k, v, window, _route)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
            route: Optional[str]) -> torch.Tensor:
    """The launch on the card: the kernel that :func:`flash_route` names, or
    the forced ``route``."""
    BH, S, d = q.shape
    # Both kernels copy by 16 bytes: an operand that is a view at an
    # unaligned offset is copied to a fresh (aligned) tensor.
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    out = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    chosen = flash_route(q.dtype, d, ptrs)
    if route is not None:
        if route == "tensor_core" and chosen != route:
            raise ValueError(f"flash_attention: route {route!r} does not take {q.dtype} "
                             f"d={d} at these addresses")
        chosen = route
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if chosen == "tensor_core":
            rc = _build.library().repro_flash_attention_wgmma(*ptrs, BH, S, d, window, stream)
        else:
            rc = _build.library().repro_flash_attention(*ptrs, DTYPES[q.dtype], BH, S, d,
                                                        window, stream)
    _build.check(rc, f"flash_attention ({chosen})")
    flash_attention.launches += 1
    flash_attention.route_launches[chosen] += 1
    return out


_flash_op = torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                                    device_types="cuda")(_launch)


@_flash_op.register_fake
def _(q, k, v, window, route):
    return torch.empty_like(q)


def causal_pairs(S: int, window: int) -> int:
    """Live (query, key) pairs of a causal mask over S, within ``window``
    when > 0."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flops(q_shape, k_shape=None, v_shape=None, window=0, route=None, *,
                          out_shape=None, **_) -> int:
    """4 * d per live (query, key) pair, per head: Q K^T and P V."""
    BH, S, d = q_shape
    return 4 * d * BH * causal_pairs(S, window)


# The backward's plain attention holds (slice, S, S) f32 scores and as many
# probabilities: slices of BH are cut so that one holds at most 2^28 scores
# (1 GiB in f32; 64 heads at S = 2048).
GRAD_SCORES = 1 << 28


class FlashAttention(torch.autograd.Function):
    """The kernel forward (:func:`_forward`) with the plain version's gradient.

    The JAX package has no backward kernel (it trains through ``jnp``), so
    the backward recomputes attention by the plain version and
    differentiates it (:func:`flash_attention_grad`); it saves q, k and v.
    """

    @staticmethod
    def forward(ctx, q, k, v, window: int, route):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return _forward(q, k, v, window, route)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_grad(q, k, v, g, window=ctx.window), None, None)


def flash_attention_grad(q, k, v, g, *, window: int = 0):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v, window)`` against the
    output's gradient ``g``, by autograd through the plain version, over
    the slices of BH that :func:`grad_parts` plans."""
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    for part in grad_parts(*q.shape[:2]):
        grad_part(q, k, v, g, window, part, grads)
    return grads


def grad_parts(BH: int, S: int) -> list[slice]:
    """The backward's slices of BH, of at most ``GRAD_SCORES`` scores each:
    equal ones, then a ragged last one where BH does not divide."""
    step = max(1, GRAD_SCORES // (S * S))
    return [slice(i, min(i + step, BH)) for i in range(0, BH, step)]


def grad_part(q, k, v, g, window: int, part: slice, grads):
    """Write the gradients of slice ``part`` of BH into ``grads``."""
    with torch.enable_grad():
        qs, ks, vs = (t[part].detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qs, ks, vs, window=window)
        for whole, d in zip(grads, torch.autograd.grad(out, (qs, ks, vs), g[part])):
            whole[part] = d


flash_attention.launches = 0  # every launch
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
