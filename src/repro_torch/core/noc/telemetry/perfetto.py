"""Chrome/Perfetto ``trace_event`` export of collector state.

Emits the legacy JSON trace format (``{"traceEvents": [...]}``) that
``ui.perfetto.dev`` and ``chrome://tracing`` both load: program ops as
complete-event spans in comm/compute lanes, stream lifecycles as spans
in a streams lane, fault annotations as instants, and the windowed
timeseries as counter tracks.  Cycles map 1:1 onto trace microseconds —
the viewer's time axis reads directly in cycles.

Events are ordered metadata-first, then strictly by non-decreasing
timestamp; the CI smoke gate asserts that ordering after a
``json.loads`` round-trip.
"""

from __future__ import annotations

import json

_PID = 1
_LANES = (("comm", 1), ("compute", 2), ("streams", 3), ("faults", 4))
_TID = dict(_LANES)


def trace_events(collector) -> list[dict]:
    """Flat ``trace_event`` list for ``collector`` (a
    :class:`~repro_torch.core.noc.telemetry.collector.Collector`)."""
    meta = [
        {"ph": "M", "pid": _PID, "tid": tid, "ts": 0,
         "name": "thread_name", "args": {"name": name}}
        for name, tid in _LANES
    ]
    events: list[dict] = []
    for label, lane, start, end in collector.ops:
        events.append({
            "ph": "X", "pid": _PID, "tid": _TID.get(lane, _TID["comm"]),
            "name": label, "cat": lane,
            "ts": float(start), "dur": float(max(end - start, 0.0)),
        })
    for span in collector.stream_spans():
        t0 = span["created"] if span["created"] is not None else span["first_beat"]
        t1 = span["done"] if span["done"] is not None else span["last_arrival"]
        if t0 is None or t1 is None:
            continue
        events.append({
            "ph": "X", "pid": _PID, "tid": _TID["streams"],
            "name": f"{span['kind']}[{span['index']}]/vc{span['vc']}",
            "cat": "stream",
            "ts": float(t0), "dur": float(max(t1 - t0, 0)),
            "args": {"first_beat": span["first_beat"],
                     "last_arrival": span["last_arrival"]},
        })
    for cycle, kind, detail in collector.annotations:
        events.append({
            "ph": "i", "pid": _PID, "tid": _TID["faults"],
            "name": kind, "cat": "fault", "s": "g",
            "ts": float(cycle), "args": {"detail": detail},
        })
    for sample in collector.timeseries():
        ts = float(sample["t0"])
        for counter in ("live_streams", "offered_beats", "delivered_beats"):
            events.append({
                "ph": "C", "pid": _PID, "tid": 0, "name": counter,
                "ts": ts, "args": {counter: sample[counter]},
            })
    # Service-level gauges (queue depth, slot occupancy, cache hit rate)
    # sampled by the simulation service scheduler; getattr so collectors
    # restored from pre-service checkpoints export unchanged.
    for name, t, value in getattr(collector, "counter_samples", ()):
        events.append({
            "ph": "C", "pid": _PID, "tid": 0, "name": name,
            "ts": float(t), "args": {name: value},
        })
    events.sort(key=lambda e: e["ts"])
    return meta + events


def perfetto_json(collector) -> str:
    """Serialized trace ready to write to a ``.json`` file and open in
    ``ui.perfetto.dev``."""
    return json.dumps(
        {"traceEvents": trace_events(collector), "displayTimeUnit": "ns"}
    )
