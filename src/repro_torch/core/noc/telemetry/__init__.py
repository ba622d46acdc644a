"""Opt-in fabric observability: counters, spans, timelines.

- ``collector`` — :class:`Collector` / :class:`TelemetryConfig`: attach
  via ``NoCSim.run(telemetry=Collector())``; accumulates per-(link, VC)
  busy-beat and retry counters, per-tile inject/eject totals, fault
  annotations and program-op spans across all four engines (identical
  totals by construction), survives checkpoints bit-exactly.
- ``stats`` — :class:`FabricStats` read-out: heatmap grids, top-k
  hot-link tables, ASCII rendering (:func:`render_heatmap`).
- ``perfetto`` — Chrome/Perfetto ``trace_event`` export
  (:func:`trace_events`, :func:`perfetto_json`) for ``ui.perfetto.dev``.

Telemetry never feeds back into simulation: ``run(telemetry=None)``
(the default) is the exact code path every committed fingerprint and
``BENCH_*.json`` baseline was produced with.
"""

from repro_torch.core.noc.telemetry.collector import Collector, TelemetryConfig
from repro_torch.core.noc.telemetry.perfetto import perfetto_json, trace_events
from repro_torch.core.noc.telemetry.stats import (
    FabricStats,
    link_label,
    render_heatmap,
)

__all__ = [
    "Collector",
    "TelemetryConfig",
    "FabricStats",
    "link_label",
    "render_heatmap",
    "trace_events",
    "perfetto_json",
]
