"""The program's own spans (``rt:<name>``, written by
``repro_torch/tracing.py``) in a traced window, and the readings of them
that per-layer metrics would share.

``collect`` reads a stopped ``torch.profiler`` window into a ``Program``:
the spans, with the thread of each, and every device operation's interval
and launch (the host time and thread of the runtime call with its
correlation id).  The benchmark's trace reduction (``trace.reduce_profile``)
does not call it yet, so no metric of ``BENCHMARK.json`` reads these; the
per-run readings at the end take the ``Program`` from ``run.trace.program``
and give None without one.

An operation belongs to a span when the runtime call that launched it was
made inside the span, on the span's thread: the backward pass runs on
autograd's own thread, and its spans hold its launches.  Spans are chosen
by ``fnmatch`` patterns on their names (``collective.*``); the chosen spans
are merged on each thread first, so that nested or repeated spans count an
operation, or a stretch of host time, once.  A reading is None where the
trace holds no span that the patterns choose, as a program without these
spans gives.
"""

from __future__ import annotations

import bisect
import dataclasses
import fnmatch
import heapq

from portbench.trace import union_length

PREFIX = "rt:"
OUTSIDE = "outside the program's spans"


@dataclasses.dataclass
class Program:
    """``spans``: the program's spans as (name without ``rt:``, start, end,
    thread); ``ops``: every device operation as (start, end, launched at,
    launching thread), the launch None where no runtime call has its
    correlation id.  Seconds on the trace's clock; a thread is its system
    id (the profiler's resource id), which the runtime's calls and the
    host's spans share."""

    spans: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)


def collect(prof) -> Program:
    """The ``Program`` of a stopped ``torch.profiler`` window, read from its
    raw events as ``trace.reduce_profile`` reads them.  User annotations,
    which the profiler also lays on the device's timeline, are spans, not
    device operations."""
    from torch.autograd import DeviceType

    spans, device, launch_of = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((a, b, e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], a, b, e.device_resource_id()))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():  # the runtime's calls
            launch_of[e.correlation_id()] = (a, e.device_resource_id())
    return Program(spans, [(a, b) + launch_of.get(cid, (None, None)) for a, b, cid in device])


def _cover(program, patterns) -> dict | None:
    """{thread: (starts, ends)} of the chosen spans merged on each thread;
    None where no span is chosen."""
    by_thread = {}
    for name, a, b, thread in program.spans:
        if any(fnmatch.fnmatchcase(name, p) for p in patterns):
            by_thread.setdefault(thread, []).append((a, b))
    if not by_thread:
        return None
    out = {}
    for thread, intervals in by_thread.items():
        merged = union_length(intervals)[1]
        out[thread] = ([a for a, _ in merged], [b for _, b in merged])
    return out


def _inside(cover: dict, t, thread) -> bool:
    if t is None or thread not in cover:
        return False
    starts, ends = cover[thread]
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def _launched(program, patterns) -> list | None:
    """The (start, end) of every device operation launched inside the
    chosen spans."""
    cover = _cover(program, patterns)
    if cover is None:
        return None
    return [(a, b) for a, b, t, thread in program.ops if _inside(cover, t, thread)]


def device_s(program, patterns) -> float | None:
    """Device seconds of the operations launched inside the chosen spans."""
    ops = _launched(program, patterns)
    return None if ops is None else sum(b - a for a, b in ops)


def launches(program, patterns) -> int | None:
    """How many device operations (kernels, copies, sets) were launched
    inside the chosen spans."""
    ops = _launched(program, patterns)
    return None if ops is None else len(ops)


def host_s(program, patterns) -> float | None:
    """Host seconds inside the chosen spans, summed over threads."""
    cover = _cover(program, patterns)
    if cover is None:
        return None
    return sum(b - a for starts, ends in cover.values() for a, b in zip(starts, ends))


def idle_by_span(program) -> dict:
    """The device's idle seconds between its first and last operation, by
    the innermost program span (the latest opened of those open, on any
    thread) at each moment, or ``OUTSIDE``: where the idle time of a window
    falls in the program.  For PERF.md; no metric reads it."""
    busy = union_length([(a, b) for a, b, _, _ in program.ops])[1]
    if not busy:
        return {}
    # idle seconds before time t: bisect into the busy intervals' prefix sums
    starts = [a for a, _ in busy]
    done = [0.0]  # idle seconds before busy interval i starts
    for (_, b), (a, _) in zip(busy, busy[1:]):
        done.append(done[-1] + a - b)

    def idle_before(t: float) -> float:
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        return done[i] + max(0.0, t - busy[i][1])

    marks = sorted([(a, 0, i) for i, (_, a, _, _) in enumerate(program.spans)]
                   + [(b, 1, i) for i, (_, _, b, _) in enumerate(program.spans)])
    out, open_, heap = {}, set(), []
    t = busy[0][0]
    for when, end, i in marks + [(busy[-1][1], 1, None)]:
        when = min(max(when, busy[0][0]), busy[-1][1])
        while heap and heap[0][1] not in open_:
            heapq.heappop(heap)
        name = program.spans[heap[0][1]][0] if heap else OUTSIDE
        idle = idle_before(when) - idle_before(t)
        if idle > 0:
            out[name] = out.get(name, 0.0) + idle
        t = when
        if i is None:
            break
        if end:
            open_.discard(i)
        else:
            open_.add(i)
            heapq.heappush(heap, (-program.spans[i][1], i))
    return out


def _per_unit(run, reading, scale: float):
    """``reading`` of the run's ``Program`` a call or step, times ``scale``."""
    program = getattr(run.trace, "program", None)
    if program is None or run.units <= 0:
        return None
    value = reading(program)
    return None if value is None else value / run.units * scale


def host_call_ms(run, entry: str):
    """Host ms a call inside the entry point's span (``rt:summa``, ``rt:fcl``)."""
    return _per_unit(run, lambda p: host_s(p, (entry,)), 1e3)


def launches_per_call(run, entry: str):
    """Device operations a call launched inside the entry point's span."""
    return _per_unit(run, lambda p: launches(p, (entry,)), 1.0)


def comm_ms(run):
    """Device ms a call of the operations launched inside the collectives'
    spans (``rt:collective.*``)."""
    return _per_unit(run, lambda p: device_s(p, ("collective.*",)), 1e3)


def region_ms(run, name: str):
    """Device ms a step of the operations launched inside ``rt:<name>`` and
    its backward span ``rt:<name>.backward``."""
    return _per_unit(run, lambda p: device_s(p, (name, name + ".backward")), 1e3)
