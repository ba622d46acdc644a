"""Spans at the port's layer boundaries, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` window records: the switch
is the profiler's own module global,
``torch.autograd.profiler._is_profiler_enabled``, which autograd's threads
see as the caller does.  Nothing else turns it on, so any profiler trace of
the program holds its spans, laid on the same clock as the device's
operations.  Every span is named ``rt:<name>``:

* :func:`span` (and the decorator :func:`spanned`) is a user-scope
  record function, as ``torch.profiler.record_function`` makes, around a
  piece of host code;
* :func:`region` covers a differentiable piece of the model: its forward is
  the span ``rt:<name>``, its backward the span ``rt:<name>.backward``, which
  opens as the first output gradient arrives and closes as the last input
  gradient leaves.  A remat recompute runs the forward again inside the
  backward, so its operations fall inside the backward span.  The backward
  span needs an input that requires a gradient; without one the region has
  only its forward span.

A span is PyTorch's ``_RecordFunctionFast``: the event that
``record_function`` makes, without its call through the dispatcher, at
about a tenth of its host time while a profiler records.  With no
profiler recording, ``span`` and ``spanned`` cost one test of the flag and
create nothing, and ``region`` calls its function and adds no autograd
node: an untraced call launches exactly what it launches without them.

The spans (``portbench/program_spans.py`` reads them):

* ``rt:summa`` (``core/summa.py:summa_sharded``) and ``rt:fcl``
  (``core/fcl.py:fcl_sharded``): a collective GEMM's whole call;
* ``rt:collective.<fn>``: the schedules' ``broadcast``, ``all_reduce``,
  ``reduce_scatter`` and ``all_gather`` (``core/schedules.py``), the mesh's
  ``psum``, ``pmax``, ``psum_scatter``, ``all_gather``, ``ppermute``,
  ``all_to_all`` and ``sum_copies`` (``core/mesh.py``), and the ring's skew
  (``rotate_by``, ``core/summa.py``); they nest;
* the regions ``blocks`` (``models/transformer.py``: the layers and the
  final norm) and ``loss_head`` (``models/common.py:chunked_cross_entropy``,
  every slab with its recompute);
* ``rt:optimizer`` (``runtime/trainer.py:Trainer._step_fn``: the learning
  rate, AdamW and the parameters' copy, and the routers' selection biases);
* the regions ``mla`` (``models/mla.py``: latent attention, its projections
  included) and ``moe`` (``models/mlp.py:moe``: routing, dispatch, the
  expert-parallel exchange, the experts, combine and the shared experts).

Counters (:func:`count`) are kept on the card, each a 0-d int64 tensor,
and count only while a profiler records and outside a backward pass (where
a remat recompute runs the forward again), so that an untraced step
launches nothing for them; :func:`counters` reads them (one wait for the
card), after a window, and :func:`reset_counters` drops them.  The
counters:

* ``moe.routed_pairs`` and ``moe.dropped_pairs``: the (token, choice) pairs
  that the MoE's routers chose, over every member, and those of them that
  capacity dropped (``models/mlp.py:_count_pairs``).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import profiler as _profiler

PREFIX = "rt:"
_OFF = contextlib.nullcontext()
_Span = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager: the span ``rt:<name>`` while a profiler records,
    else a shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(PREFIX + name)


def spanned(name: str):
    """A decorator: each call of the function is the span ``rt:<name>``."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(PREFIX + name):
                return fn(*args, **kwargs)

        return traced

    return wrap


class _Backward:
    """A region's backward span: opened by one autograd node, closed by
    another."""

    def __init__(self, name: str):
        self.name, self.handle = name, None

    def open(self):
        if self.handle is None and _profiler._is_profiler_enabled:
            self.handle = _Span(self.name)
            self.handle.__enter__()

    def close(self):
        if self.handle is not None:
            self.handle.__exit__(None, None, None)
            self.handle = None


class _Mark(torch.autograd.Function):
    """The identity on a region's inputs or outputs; its backward calls
    ``then``: the outputs' node opens the backward span (the region
    backward's first step), the inputs' closes it (its last)."""

    @staticmethod
    def forward(ctx, then, *xs):
        ctx.then = then
        return xs

    @staticmethod
    def backward(ctx, *gs):
        ctx.then()
        return (None, *gs)


def _mark(values: list, then) -> bool:
    """``values``' tensors that require a gradient replaced, in place, by
    ``_Mark``'s identity outputs; whether there were any."""
    at = [i for i, v in enumerate(values) if isinstance(v, torch.Tensor) and v.requires_grad]
    if at:
        for i, v in zip(at, _Mark.apply(then, *(values[i] for i in at))):
            values[i] = v
    return bool(at)


def region(name: str, fn, *args):
    """``fn(*args)`` as the region ``name``: the span ``rt:<name>``, and
    ``rt:<name>.backward`` over its backward pass.  ``fn`` returns a tensor
    or a tuple of them."""
    if not _profiler._is_profiler_enabled:
        return fn(*args)
    with _Span(PREFIX + name):
        if not torch.is_grad_enabled():
            return fn(*args)
        box = _Backward(PREFIX + name + ".backward")
        args = list(args)
        if not _mark(args, box.close):
            return fn(*args)
        out = fn(*args)
        outs = list(out) if isinstance(out, tuple) else [out]
        _mark(outs, box.open)
        return tuple(outs) if isinstance(out, tuple) else outs[0]


# the counters by name: 0-d int64 tensors on the device that counted first
_COUNTS: dict = {}
_graph_task = getattr(torch._C, "_current_graph_task_id", lambda: -1)


def in_backward() -> bool:
    """Whether a backward pass runs on this thread (a remat recompute's
    forward among it)."""
    return _graph_task() != -1


def counting() -> bool:
    """Whether counters count now: a profiler records and no backward pass
    runs on this thread."""
    return bool(_profiler._is_profiler_enabled) and not in_backward()


def count(name: str, n, device=None):
    """Add ``n`` (an int, or an integer tensor on the device) to the counter
    ``name``, kept on ``n``'s device or ``device``; call it only where
    :func:`counting` holds."""
    device = n.device if isinstance(n, torch.Tensor) else device
    if name not in _COUNTS:
        _COUNTS[name] = torch.zeros((), dtype=torch.int64, device=device)
    _COUNTS[name].add_(n)


def counters() -> dict:
    """Every counter's value, by name (waits for the card)."""
    return {name: int(t) for name, t in _COUNTS.items()}


def reset_counters():
    _COUNTS.clear()
