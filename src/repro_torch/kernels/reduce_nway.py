"""N-way elementwise reduction (the parallel-reduction-router analogue).

Replaces ``src/repro/kernels/reduce_nway.py:reduce_nway`` (``_reduce_kernel``).
The kernel is ``csrc/reduce_nway.cu``.  It is bound by device-memory bytes,
(N + 1) * M * itemsize (each input row read once, the output written once),
which on an H100 SXM is that many bytes over 3.35 TB/s.  Its launch plan
is :func:`reduce_plan`: a 16-byte vector a thread where the layout is
aligned, and one block a tile; a thread loads its rows 4 at a time, each
group's loads issued before its first combine (n = 1 and 2 written out).

The kernel reads x in place when its layout is (outer, N, inner) through
two strides, the collapsed dims before ``dim`` (0 for an ``expand``) and
``dim``, with the dims after ``dim`` one contiguous run
(:func:`reads_in_place`); :func:`readable` copies any other layout first,
and counts the copy in ``reduce_nway.layouts``.

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

Binding: the kernel is also the opaque op ``torch.ops.repro_torch.reduce_nway``
(``torch.library.custom_op``), whose CUDA implementation is the launch
that a run calls directly (``_build.traced``); a trace goes through the
op, whose fake implementation gives the output's shape, so a trace
under ``FakeTensorMode`` or on meta tensors (the dry run,
``launch/dryrun.py``) never reaches ``data_ptr()`` or the library, and
its FLOP formula (``torch.utils.flop_counter``) is (N - 1) * M for N rows
of M.  ``reduce_nway.launches`` counts real launches only.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import reduce_nway_ref

OPS = ("add", "max", "and")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
SUPPORTED = {"add": (torch.float32, torch.bfloat16, torch.int32),
             "max": (torch.float32, torch.bfloat16, torch.int32),
             "and": (torch.int32, torch.bool)}
# csrc/reduce_nway.cu: threads (vectors) a block.
THREADS = 256


class ReducePlan(NamedTuple):
    vec: int     # elements a vector (one a thread): 16 bytes, or 1
    blocks: int  # the grid: one block a tile of THREADS vectors of a row


@functools.lru_cache(maxsize=4096)
def reduce_plan(outer: int, inner: int, itemsize: int, aligned: bool) -> ReducePlan:
    """The kernel's launch plan for x viewed as (outer, n, inner), whatever n.

    ``vec`` is a 16-byte vector (16 / itemsize elements) when ``aligned``
    (the input's pointer 16-byte aligned, ``inner`` and both strides
    multiples of the vector), else one element.  A thread takes one
    vector and a block one tile of ``THREADS`` vectors of a row, so the
    grid is ``outer`` times the tiles of a row, and the card's block
    scheduler balances the SMs: on the card this measured faster than a
    grid of one resident wave that walks the tiles, and 2 or 4 vectors a
    thread no faster (``PERF.md`` §6).  Pointers are 64-bit, so one
    plan serves inputs of any size; 2^31 blocks or more raise.
    """
    vec = 16 // itemsize if aligned else 1
    blocks = outer * -(-inner // (THREADS * vec))
    if blocks >= 2 ** 31:
        raise ValueError(f"reduce_nway: {blocks} tiles of (outer {outer}, inner {inner}) "
                         "exceed the kernel's 2^31 blocks")
    return ReducePlan(vec, blocks)


@functools.lru_cache(maxsize=4096)
def _layout_of(shape, stride, dim: int):
    """(outer, n, inner, so, sn) of a tensor of ``shape`` and ``stride``
    viewed as (outer, n, inner) over ``dim``, element (o, i, e) at o * so +
    i * sn + e, or None when the dims after ``dim`` are not one contiguous
    run or those before it do not collapse to one stride.  Size-1 dims are
    skipped; so = 0 when outer is 1, sn = 0 when n is 1."""
    n, inner = shape[dim], 1
    for k in range(len(shape) - 1, dim, -1):
        if shape[k] != 1 and stride[k] != inner:
            return None
        inner *= shape[k]
    outer, so = 1, 0
    for k in range(dim - 1, -1, -1):
        if shape[k] == 1:
            continue
        if outer == 1:
            so = stride[k]
        elif stride[k] != so * outer:
            return None
        outer *= shape[k]
    return outer, n, inner, so, stride[dim] if n > 1 else 0


def _layout(x, dim: int):
    return _layout_of(x.shape, x.stride(), dim)


def reads_in_place(x, dim: int = 0) -> bool:
    """Whether the kernel reads ``x`` as it lies: the dims after ``dim`` one
    contiguous run, those before it collapsed to one stride (which may be
    0, an ``expand``).  A contiguous tensor always qualifies."""
    return _layout(x, dim % x.ndim) is not None


def readable(x, dim: int = 0):
    """``x`` itself when the kernel reads it in place (:func:`reads_in_place`),
    else a contiguous copy, counted in ``reduce_nway.layouts`` (``copied``,
    ``copied_bytes``).  On the CPU always the contiguous tensor: the plain
    version sums in ``torch.sum``'s order, which follows the layout, so its
    callers keep the bits they had when every input was copied."""
    if reads_in_place(x, dim):
        return x.contiguous() if x.device.type == "cpu" else x
    reduce_nway.layouts["copied"] += 1
    reduce_nway.layouts["copied_bytes"] += x.numel() * x.element_size()
    return x.contiguous()


def reduce_nway(x, *, op: str = "add", bs: int = 512, dim: int = 0):
    """Reduce ``x`` over ``dim`` with ``op``: (N, M) -> (M,) by default.

    Any shape is taken; the reduced dim may sit anywhere (the stacked
    mesh's ``psum`` reduces a middle dim in place, with no transpose).  On
    the card the layout must be one the kernel reads in place
    (:func:`reads_in_place`; :func:`readable` copies any other), or the
    call raises.
    ``bs`` is the TPU's column tile and does not change the result.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises (a fake or meta tensor of a trace gets the output's shape from
    the op, and nothing launches).
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
    """The kernel on a CUDA tensor (its op under a trace), the plain version on
    a CPU one."""
    if x.dtype == torch.bool:
        return _reduce(x.to(torch.int32), op, dim).to(torch.bool)
    if x.device.type == "cpu":
        return reduce_nway_ref(x, op, dim)
    return (torch.ops.repro_torch.reduce_nway if _build.traced(x) else _launch)(x, op, dim)


def _unreadable(x, dim: int) -> ValueError:
    return ValueError(f"reduce_nway: the kernel cannot read strides {x.stride()} of "
                      f"{tuple(x.shape)} over dim {dim}; pass readable(x, dim)")


def _launch_args(x, dim: int):
    """(layout, plan) of a launch on ``x``: :func:`_layout_of` and
    :func:`reduce_plan`; None for a layout the kernel does not read."""
    layout = _layout(x, dim)
    if layout is None:
        return None
    outer, _, inner, so, sn = layout
    itemsize = x.element_size()
    vec = 16 // itemsize
    aligned = x.data_ptr() % 16 == 0 and inner % vec == 0 and so % vec == 0 and sn % vec == 0
    return layout, reduce_plan(outer, inner, itemsize, aligned)


def _launch(x: torch.Tensor, op: str, dim: int) -> torch.Tensor:
    """The launch on the card; a layout the kernel does not read raises."""
    args = _launch_args(x, dim)
    if args is None:
        raise _unreadable(x, dim)
    layout, plan = args
    out = torch.empty(x.shape[:dim] + x.shape[dim + 1:], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _build.library().repro_reduce_nway(
            x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], OPS.index(op), *layout, plan.vec,
            plan.blocks, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "reduce_nway")
    reduce_nway.launches += 1
    if not x.is_contiguous():
        reduce_nway.layouts["in_place"] += 1
        reduce_nway.layouts["in_place_bytes"] += x.numel() * x.element_size()
    return out


def _plan(x, dim: int) -> ReducePlan:
    """The :func:`reduce_plan` that a launch on ``x`` (in a layout the
    kernel reads) takes."""
    return _launch_args(x, dim)[1]


_reduce_op = torch.library.custom_op("repro_torch::reduce_nway", mutates_args=(),
                                     device_types="cuda")(_launch)


@_reduce_op.register_fake
def _(x, op, dim):
    if _layout(x, dim) is None:
        raise _unreadable(x, dim)
    return x.new_empty(x.shape[:dim] + x.shape[dim + 1:])


@register_flop_formula(torch.ops.repro_torch.reduce_nway)
def reduce_nway_flops(x_shape, op=None, dim=0, *, out_shape=None, **_) -> int:
    """(N - 1) * M: one add (max, and) per element of each row but the first."""
    n = x_shape[dim]
    return (n - 1) * (math.prod(x_shape) // n)


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
# Inputs that were not contiguous: launches that read one in place and the
# bytes a copy would have moved; copies that ``readable`` made of layouts
# the kernel does not read, and their bytes.
reduce_nway.layouts = dict.fromkeys(("in_place", "in_place_bytes", "copied", "copied_bytes"), 0)
