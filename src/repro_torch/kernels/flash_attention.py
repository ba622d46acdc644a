"""Causal (optionally sliding-window) flash attention, forward.

Replaces ``src/repro/kernels/flash_attention.py:flash_attention``
(``_flash_kernel``).  The kernel is ``csrc/flash_attention.cu``: one block
of 256 threads per tile of 64 queries loops over the 64-key tiles inside
the block (in place of the TPU's sequential kv grid axis and its VMEM
scratch), with K and V tiles in shared memory and the online softmax's f32
m / l / accumulator in registers.  Tiles that hold no live key for any query
of the block are not visited, so a sliding-window layer costs O(S * window).
It is bound by operations: 4 * d f32 multiply-adds per live (query, key)
pair on the CUDA cores, since the reference multiplies in f32 (on an H100
SXM, 2 * d * BH * S * (S + 1) / 67 TFLOP/s for a causal call).

The numbers are the reference kernel's: logits ``(q * scale) @ k^T`` in f32
with ``scale = 1 / sqrt(d)``, masked logits at -2e38, the output
``acc / max(l, 1e-30)`` cast to q's dtype; ``p`` stays f32 through ``P @ V``.
The ragged last tiles are masked, so S need not divide by any tile: the
reference's ``S % bq == 0`` assert is not kept, and ``bq`` / ``bkv`` are
accepted for its signature without changing the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q, k, v, *, window: int = 0, bq: int = 128, bkv: int = 128):
    """Causal self-attention over (BH, S, d) q, k, v of one dtype.

    ``window > 0`` keeps, for query i, only keys j with i - window < j <= i.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    del bq, bkv  # the TPU's block shape; the CUDA kernel tiles itself
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; need three equal (BH, S, d)")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands lie on different devices")
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        "need one of float32, bfloat16 for all three")
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    BH, S, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _build.library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            BH, S, d, window, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
