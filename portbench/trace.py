"""Host spans and the reduction of a profiler window to device numbers.

The benchmark records its spans around its own calls into the program
(``Spans.span``): with tracing on, each is a ``torch.profiler``
``record_function`` named ``pb:<name>``, so that it lies in the same trace,
on the same clock, as the device's kernels.  ``reduce_profile`` turns the
trace into the time of each kernel, the device's busy time (the union of
its operations' intervals), and the idle gaps between them, each named by
the innermost span the host was in at the gap's middle.  The operations
launched inside a ``check`` span are the benchmark's own (its checksums of
the program's outputs): they are kept apart from the program's kernels.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

SPAN_PREFIX = "pb:"
CHECK_SPAN = "check"  # spans whose launches are the benchmark's, not the program's
TOP = 10


class Spans:
    """The benchmark's host spans; they cost nothing with tracing off."""

    def __init__(self, tracing: bool):
        self.tracing = tracing

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)


def start_profiler():
    """A started ``torch.profiler`` over CPU and CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def kernel_name(key: str) -> str:
    """A kernel's symbol without its signature, ``void`` and the anonymous
    namespace that the program's kernels live in.  PyTorch's own keep
    ``at::native::``, so that ``at::native::reduce_kernel`` is never taken
    for the program's ``reduce_kernel``."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    return key.replace("std::", "")[:64]


def base_name(short: str) -> str:
    """A short kernel name without its template arguments: what the
    metrics' kernel lists name."""
    return short.split("<")[0]


@dataclasses.dataclass
class Trace:
    """What a traced window showed: ``kernels`` maps a kernel's short name to
    (device seconds, launches), the program's; ``checks`` the same for the
    benchmark's own checksums; ``busy_s`` is the union of the device's
    operation intervals, both kinds; ``window_s`` the traced span of the
    host's clock; ``gaps`` the idle gaps as (span name, seconds), longest
    first."""

    kernels: dict
    busy_s: float
    window_s: float
    gaps: list
    checks: dict = dataclasses.field(default_factory=dict)

    def seconds_in(self, names) -> float:
        """Device seconds of the kernels whose base name is in ``names``."""
        return sum(s for k, (s, _) in self.kernels.items() if base_name(k) in names)

    def launches_of(self, names) -> int:
        return sum(n for k, (_, n) in self.kernels.items() if base_name(k) in names)

    def breakdown(self) -> dict:
        ops = list(self.kernels.items())
        ops += [(SPAN_PREFIX + CHECK_SPAN + " " + k, v) for k, v in self.checks.items()]
        top = sorted(ops, key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[k, s] for k, (s, _) in top],
                "idle_gaps": [[name, s] for name, s in self.gaps[:TOP]]}


def union_length(intervals) -> tuple[float, list]:
    """(total length, merged intervals) of (start, end) pairs."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def name_gaps(merged, spans, lo: float, hi: float, top: int = TOP) -> list:
    """The ``top`` longest idle stretches of [lo, hi] outside ``merged``
    (sorted, disjoint busy intervals), longest first, each named by the
    innermost of ``spans`` ((name, start, end)) that holds its middle."""
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s[1] <= mid <= s[2]]
        name = max(inside, key=lambda s: s[1])[0] if inside else "outside the benchmark's spans"
        out.append((name, b - a))
    return out


def reduce_events(device_events, cpu_events, checked=()) -> Trace:
    """``device_events`` and ``cpu_events`` (the host spans): (name, start,
    end) in seconds on one clock; ``checked`` the indices of the device
    events that the benchmark's checks launched.  The window is the span of
    every event."""
    kernels, checks, checked = {}, {}, set(checked)
    for i, (name, a, b) in enumerate(device_events):
        short = kernel_name(name)
        into = checks if i in checked else kernels
        s, n = into.get(short, (0.0, 0))
        into[short] = (s + (b - a), n + 1)
    busy, merged = union_length([(a, b) for _, a, b in device_events])
    times = [t for _, a, b in list(device_events) + list(cpu_events) for t in (a, b)]
    lo, hi = (min(times), max(times)) if times else (0.0, 0.0)
    spans = [(n[len(SPAN_PREFIX):], a, b) for n, a, b in cpu_events if n.startswith(SPAN_PREFIX)]
    return Trace(kernels, busy, hi - lo, name_gaps(merged, spans, lo, hi), checks)


def launched_in(spans, launches) -> set:
    """The correlation ids of the ``launches`` ((id, host time)) that lie
    inside one of ``spans`` ((start, end))."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    out = set()
    for cid, t in launches:
        if not cid:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            out.add(cid)
    return out


def reduce_profile(prof) -> Trace:
    """``reduce_events`` of a stopped ``torch.profiler`` window, read from its
    raw events (building the profiler's event tree would take longer than
    the window).  User annotations, which the profiler also lays on the
    device's timeline, are spans, not device operations.  A device operation
    is the benchmark's check where the runtime call that launched it (the
    same correlation id) was made inside a ``check`` span."""
    from torch.autograd import DeviceType

    device, device_ids, cpu, launches = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(row)
                device_ids.append(e.correlation_id())
        elif row[0].startswith(SPAN_PREFIX):
            cpu.append(row)
        elif row[0].startswith(("cuda", "cu")):  # the runtime's launches and copies
            launches.append((e.correlation_id(), row[1]))
    in_check = launched_in([(a, b) for n, a, b in cpu if n == SPAN_PREFIX + CHECK_SPAN],
                           launches)
    checked = [i for i, cid in enumerate(device_ids) if cid in in_check]
    return reduce_events(device, cpu, checked)
