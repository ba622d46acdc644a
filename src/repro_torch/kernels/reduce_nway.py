"""N-way elementwise reduction (the parallel-reduction-router analogue).

Replaces ``src/repro/kernels/reduce_nway.py:reduce_nway`` (``_reduce_kernel``).
The kernel is ``csrc/reduce_nway.cu``.  It is bound by device-memory bytes,
(N + 1) * M * itemsize (each input row read once, the output written once),
which on an H100 SXM is that many bytes over 3.35 TB/s.  Each thread keeps
16 bytes of the output in registers and streams the N inputs through them
with coalesced 16-byte loads, so no byte is read twice.

Ops follow the reference: ``add`` sums in f32 and casts back, ``max`` is
elementwise, ``and`` is a bitwise AND over int32 rows (the LsbAnd barrier).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import reduce_nway_ref

OPS = ("add", "max", "and")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
SUPPORTED = {"add": (torch.float32, torch.bfloat16, torch.int32),
             "max": (torch.float32, torch.bfloat16),
             "and": (torch.int32,)}


def reduce_nway(x, *, op: str = "add", bs: int = 512, dim: int = 0):
    """Reduce ``x`` over ``dim`` with ``op``: (N, M) -> (M,) by default.

    Any shape is taken; the reduced dim may sit anywhere (the stacked
    mesh's ``psum`` reduces a middle dim in place, with no transpose).
    ``bs`` is the TPU's column tile and does not change the result.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises.
    """
    del bs
    if op not in OPS:
        raise ValueError(f"reduce_nway: unknown op {op!r}")
    if x.dtype not in SUPPORTED[op]:
        raise TypeError(f"reduce_nway: op {op!r} takes {SUPPORTED[op]}, got {x.dtype}")
    if x.ndim == 0 or x.shape[dim] == 0:
        raise ValueError(f"reduce_nway: nothing to reduce over dim {dim} of {tuple(x.shape)}")
    dim = dim % x.ndim
    if x.device.type == "cpu":
        return reduce_nway_ref(x, op, dim)
    if x.device.type != "cuda":
        raise ValueError(f"reduce_nway: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("reduce_nway: input must be contiguous")
    shape = x.shape
    out = torch.empty(shape[:dim] + shape[dim + 1:], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().repro_reduce_nway(
            x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], OPS.index(op),
            math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:]),
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "reduce_nway")
    reduce_nway.launches += 1
    return out


reduce_nway.launches = 0
