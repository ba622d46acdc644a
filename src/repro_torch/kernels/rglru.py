"""The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t``.

Replaces ``src/repro/kernels/rglru.py:rglru_scan`` (``_rglru_kernel``).  The
kernel is ``csrc/rglru_scan.cu``: a block of 32 x 16 threads owns 32
neighbouring channels of one batch row and loops over chunks of 128 steps
(in place of the TPU's sequential chunk axis and its VMEM carry); each of
its 16 rows scans 8 steps from registers, the rows' (prod a, h) pairs are
combined in shared memory, and the chunk's end state is carried to the next
chunk in f32.  It is bound by device-memory bytes: a and b read once and h
written once (on an H100 SXM, 3 * B * S * W * itemsize over 3.35 TB/s).

The numbers are the reference kernel's: the recurrence in f32 from
``h_{-1} = 0``, the output cast to ``a``'s dtype.  Steps past S are masked,
so S need not divide by any chunk: the reference's ``S % chunk == 0``
assert is not kept (serving pads each wave to its longest prompt), and
``chunk`` is accepted for its signature without changing the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan(a, b, *, chunk: int = 128):
    """(B, S, W) a and b of one dtype -> h (B, S, W) in that dtype.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    del chunk  # the TPU's chunk; the CUDA kernel tiles itself
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b {tuple(b.shape)}; "
                         "need two equal (B, S, W)")
    if b.device != a.device:
        raise ValueError("rglru_scan: operands lie on different devices")
    if b.dtype != a.dtype or a.dtype not in DTYPES:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; "
                        "need one of float32, bfloat16 for both")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: operands must be contiguous")
    B, S, W = a.shape
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = _build.library().repro_rglru_scan(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), DTYPES[a.dtype], B, S, W,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
