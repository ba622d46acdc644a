"""Batched GEMM with an accumulate-into-output epilogue (the DCA analogue).

Replaces ``src/repro/kernels/gemm.py:gemm`` (``_gemm_kernel``) with two
hand-written kernels; :func:`gemm_route` chooses between them by dtype,
shape and alignment:

- ``tensor_core``, ``csrc/gemm_wgmma.cu``: bf16 on the tensor cores.  One
  block per 128x128 output tile; a producer warpgroup keeps TMA loads of A
  and B tiles in flight through a four-slot mbarrier ring, two consumer
  warpgroups issue ``wgmma`` (A K-major, B MN-major through the transpose-B
  bit).  A bf16 product is exact in f32 and wgmma sums in f32, so the
  numbers are the reference's.  Bound: 2*M*N*K / 989 TFLOP/s per member on
  an H100 SXM.
- ``cuda_core``, ``csrc/gemm.cu``: f32, and the bf16 shapes TMA cannot
  address.  One 256-thread block per output tile (128x128 or 64x64, by
  :func:`gemm_plan`), a K loop inside the block (in place of the TPU's
  sequential K grid axis and VMEM accumulator) through two shared-memory
  buffers with a register-staged prefetch of the next 16-deep tile, one
  barrier per K step, and an 8x8 (or 4x4) f32 register tile per thread.
  It is bound by FP32 FMAs on the CUDA cores, since the reference
  multiplies in f32 (TF32 would round the operands): 2*M*N*K / 67 TFLOP/s
  per member.

Both add ``C_in`` in f32 in the epilogue and mask ragged M, N, K, so the
TPU's divisibility assert is not kept; ``bm/bn/bk`` are accepted for the
reference's signature and do not change the result.  Leading batch
dimensions are the mesh members of a stacked mesh: one launch covers them
all (the counterpart of ``vmap(gemm)``).

Binding: the kernel is also the opaque op ``torch.ops.repro_torch.gemm``
(``torch.library.custom_op``), whose CUDA implementation is the launch
that a run calls directly (``_build.traced``); a trace goes through the
op, whose fake implementation gives the output's shape, so a trace
under ``FakeTensorMode`` or on meta tensors (the dry run,
``launch/dryrun.py``) never reaches ``data_ptr()`` or the library, and
its FLOP formula (``torch.utils.flop_counter``) is 2 * batch * M * N * K.
``gemm.launches`` counts real launches only.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("cuda_core", "tensor_core")


def gemm_route(dtype, K: int, N: int, ptrs=()) -> str:
    """The kernel a call on the card takes.

    ``tensor_core`` for bfloat16 when TMA can address every operand: K > 0,
    K % 8 == 0 and N % 8 == 0 (every row stride a multiple of 16 bytes),
    and every address in ``ptrs`` (the operands' ``data_ptr()``) a multiple
    of 16.  ``cuda_core`` for every other call: float32, and the other
    bf16 shapes.
    """
    if (dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
            and all(p % 16 == 0 for p in ptrs)):
        return "tensor_core"
    return "cuda_core"


def gemm_plan(batch: int, M: int, N: int, K: int, sm_count: int, ptrs=(),
              dtype=torch.float32) -> tuple[int, bool]:
    """The CUDA-core kernel's launch plan: (tile, vector).

    ``tile`` is 128 (128x128 output tiles) when ``batch * ceil(M/128) *
    ceil(N/128)`` gives at least one block per SM (``sm_count``), else 64,
    so that a small or ragged call (1000x777: 56 blocks of 128) spreads
    over more SMs.  ``vector`` (16-byte loads of A and B, float4 stores) is
    taken for float32 when K % 4 == 0, N % 4 == 0 and every address in
    ``ptrs`` (the operands' and the output's ``data_ptr()``) is a multiple
    of 16; otherwise the same kernel template loads scalars (K = 333,
    N = 777, and bf16 on this route).  Both choose among instantiations
    of one kernel: neither is a fallback.
    """
    tiles128 = batch * math.ceil(M / 128) * math.ceil(N / 128)
    tile = 128 if tiles128 >= sm_count else 64
    vector = (dtype == torch.float32 and K % 4 == 0 and N % 4 == 0
              and all(p % 16 == 0 for p in ptrs))
    return tile, vector


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm(a, b, c=None, *, bm: int = 128, bn: int = 128, bk: int = 128,
         accumulate: bool = False, _route: str | None = None):
    """C = A @ B (+ C_in if accumulate), over any equal leading batch dims.

    a: (..., M, K), b: (..., K, N), c: (..., M, N), each float32 or
    bfloat16.  Products and sums are f32; the result has a's dtype.  Operands of mixed float dtypes are cast to float32 (exact
    from bfloat16) and take the float32 route, as the reference casts each
    block to f32 on load; the result is cast to a's dtype.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel that
    :func:`gemm_route` names, or raises (a fake or meta tensor of a trace
    gets the output's shape from the op, and nothing launches).
    ``_route`` forces one route, for timing the two against each other on
    the card; a shape outside the forced route's rule raises.
    """
    del bm, bn, bk  # the TPU's block shape; the CUDA kernel tiles itself
    if a.ndim < 2 or b.ndim != a.ndim:
        raise ValueError(f"gemm: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         "need equal ranks >= 2")
    batch, (M, K), (K2, N) = a.shape[:-2], a.shape[-2:], b.shape[-2:]
    if K != K2 or b.shape[:-2] != batch:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not match")
    if not accumulate:
        c = None
    if c is not None and tuple(c.shape) != (*batch, M, N):
        raise ValueError(f"gemm: c {tuple(c.shape)} is not {(*batch, M, N)}")
    tensors = (a, b) if c is None else (a, b, c)
    if any(t.device != a.device for t in tensors):
        raise ValueError("gemm: operands lie on different devices")
    if any(t.dtype not in DTYPES for t in tensors):
        raise TypeError(f"gemm: dtypes {[t.dtype for t in tensors]}; "
                        "need float32 or bfloat16 for every operand")
    if any(t.dtype != a.dtype for t in tensors):
        return gemm(*(t.float() for t in tensors), accumulate=c is not None,
                    _route=_route).to(a.dtype)
    if a.device.type == "cpu":
        return gemm_ref(a, b, c, accumulate=c is not None)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gemm: operands must be contiguous")
    if _route is not None and (_route not in ROUTES or (
            _route == "tensor_core" and gemm_route(a.dtype, K, N) != _route)):
        raise ValueError(f"gemm: route {_route!r} does not take {a.dtype} K={K} N={N}")
    return (torch.ops.repro_torch.gemm if _build.traced(*tensors) else _launch)(a, b, c, _route)


def _launch(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor],
            route: Optional[str]) -> torch.Tensor:
    """The launch on the card: the kernel that :func:`gemm_route` names, or
    the forced ``route``."""
    batch, (M, K), N = a.shape[:-2], a.shape[-2:], b.shape[-1]
    out = torch.empty((*batch, M, N), dtype=a.dtype, device=a.device)
    nb = math.prod(batch)
    tensors = (a, b) if c is None else (a, b, c)
    ptrs = [t.data_ptr() for t in (*tensors, out)]
    chosen = gemm_route(a.dtype, K, N, ptrs)
    if route is not None:
        if route == "tensor_core" and chosen != route:
            raise ValueError(f"gemm: route {route!r} does not take {a.dtype} "
                             f"K={K} N={N} at these addresses")
        chosen = route
    c_ptr = None if c is None else c.data_ptr()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        if chosen == "tensor_core":
            rc = _build.library().repro_gemm_wgmma(
                a.data_ptr(), b.data_ptr(), c_ptr, out.data_ptr(), nb, M, N, K, stream)
        else:
            tile, vector = gemm_plan(nb, M, N, K, sm_count(a.device.index), ptrs, a.dtype)
            rc = _build.library().repro_gemm(
                a.data_ptr(), b.data_ptr(), c_ptr, out.data_ptr(), DTYPES[a.dtype], nb, M, N, K,
                M * K, K * N, M * N, M * N, tile, int(vector), stream)
    _build.check(rc, f"gemm ({chosen})")
    gemm.launches += 1
    gemm.route_launches[chosen] += 1
    return out


_gemm_op = torch.library.custom_op("repro_torch::gemm", mutates_args=(),
                                   device_types="cuda")(_launch)


@_gemm_op.register_fake
def _(a, b, c, route):
    return a.new_empty(a.shape[:-1] + b.shape[-1:])


@register_flop_formula(torch.ops.repro_torch.gemm)
def gemm_flops(a_shape, b_shape, c_shape=None, route=None, *, out_shape=None, **_) -> int:
    """2 * batch * M * N * K: the products' multiply-adds."""
    return 2 * math.prod(a_shape[:-1]) * a_shape[-1] * b_shape[-1]


gemm.launches = 0  # every launch
gemm.route_launches = dict.fromkeys(ROUTES, 0)
