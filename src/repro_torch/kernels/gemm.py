"""Batched GEMM with an accumulate-into-output epilogue (the DCA analogue).

Replaces ``src/repro/kernels/gemm.py:gemm`` (``_gemm_kernel``).  The kernel
is ``csrc/gemm.cu``: one thread block per 128x128 output tile, a K loop
inside the block through shared memory (in place of the TPU's sequential K
grid axis and VMEM accumulator), an 8x8 f32 register tile per thread, and
``C_in`` added in f32 in the epilogue.  It is bound by FP32 FMAs on the CUDA
cores, since the reference multiplies in f32; on an H100 SXM that bound is
2*M*N*K / 67 TFLOP/s per member.  Ragged M, N, K are masked by the kernel,
so the TPU's divisibility assert is not kept; ``bm/bn/bk`` are accepted for
the reference's signature and do not change the result.

Leading batch dimensions are the mesh members of a stacked mesh: one launch
covers them all (the counterpart of ``vmap(gemm)``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gemm_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gemm(a, b, c=None, *, bm: int = 128, bn: int = 128, bk: int = 128,
         accumulate: bool = False):
    """C = A @ B (+ C_in if accumulate), over any equal leading batch dims.

    a: (..., M, K), b: (..., K, N), c: (..., M, N), all of one dtype
    (float32 or bfloat16).  Products and sums are f32; the result has
    a's dtype.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel or raises.
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
    if any(t.dtype != a.dtype for t in tensors) or a.dtype not in DTYPES:
        raise TypeError(f"gemm: dtypes {[t.dtype for t in tensors]}; "
                        "need one of float32, bfloat16 for all operands")
    if a.device.type == "cpu":
        return gemm_ref(a, b, c, accumulate=c is not None)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: unsupported device {a.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gemm: operands must be contiguous")
    out = torch.empty((*batch, M, N), dtype=a.dtype, device=a.device)
    nb = math.prod(batch)
    with torch.cuda.device(a.device):
        rc = _build.library().repro_gemm(
            a.data_ptr(), b.data_ptr(), None if c is None else c.data_ptr(),
            out.data_ptr(), DTYPES[a.dtype], nb, M, N, K,
            M * K, K * N, M * N, M * N, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "gemm")
    gemm.launches += 1
    return out


gemm.launches = 0
