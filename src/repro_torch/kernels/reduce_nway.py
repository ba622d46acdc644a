"""N-way elementwise reduction (the parallel-reduction-router analogue).

Replaces ``src/repro/kernels/reduce_nway.py:reduce_nway`` (``_reduce_kernel``).
The kernel is ``csrc/reduce_nway.cu``.  It is bound by device-memory bytes,
(N + 1) * M * itemsize (each input row read once, the output written once),
which on an H100 SXM is that many bytes over 3.35 TB/s.  Each thread keeps
16 bytes of the output in registers and streams the N inputs through them
with coalesced 16-byte loads, so no byte is read twice.

Ops follow the reference: ``add`` sums in f32 and casts back (int32 too,
as the Pallas kernel does), ``max`` is elementwise (exact on int32: the
kernel keeps an int32 running value, not an f32 one), ``and`` is a bitwise
AND over int32 rows (the LsbAnd barrier); bool rows are cast to int32,
which is exact, and the result back to bool.

Gradient: ``add`` on float32 and bfloat16 is a ``torch.autograd.Function``
(:class:`ReduceAdd`) whose forward is the kernel (the plain version on the
CPU) and whose backward broadcasts the cotangent along the reduced dim:
the sum's transpose, which launches nothing.  ``max`` and ``and`` carry
no gradient: an input that requires one raises (a caller that needs a
max inside a differentiated function, as the loss's log-sum-exp shift,
detaches it first, as ``jax.nn.logsumexp`` stops the gradient of its
max).  ``reduce_nway.backward_launches`` counts, apart from the forward's,
the launches made by a backward pass: the transposes of the mesh's
collectives that end in a sum (``core/mesh.py``) add them there.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import reduce_nway_ref

OPS = ("add", "max", "and")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
SUPPORTED = {"add": (torch.float32, torch.bfloat16, torch.int32),
             "max": (torch.float32, torch.bfloat16, torch.int32),
             "and": (torch.int32, torch.bool)}


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
    if x.requires_grad and torch.is_grad_enabled():
        if op != "add":
            raise ValueError(f"reduce_nway: op {op!r} carries no gradient; detach its input")
        return ReduceAdd.apply(x, dim)
    return _reduce(x, op, dim)


def _reduce(x, op: str, dim: int):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if x.dtype == torch.bool:
        return _reduce(x.to(torch.int32), op, dim).to(torch.bool)
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


class ReduceAdd(torch.autograd.Function):
    """The N-way sum with its transpose: the cotangent broadcast along the
    reduced dim."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        return _reduce(x, "add", dim)

    @staticmethod
    def backward(ctx, g):
        g = g.unsqueeze(ctx.dim)
        return g.expand(g.shape[:ctx.dim] + (ctx.n,) + g.shape[ctx.dim + 1:]), None


reduce_nway.launches = 0           # every launch
reduce_nway.backward_launches = 0  # those made by a backward pass (``core/mesh.py``)
