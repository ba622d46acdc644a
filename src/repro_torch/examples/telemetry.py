"""Fabric telemetry walkthrough: where do the beats actually go?

The port's counterpart of ``examples/telemetry.py``, on the port's copy
of ``core/noc``; it prints the same lines.  Core-only (no torch needed).
Attach a ``Collector`` to a 16x16 collective storm, render the per-link
busy-beat heatmap as ASCII, list the top hot links, then re-run the same
storm on a degraded mesh and watch the detour traffic shift the hot
spots.  Finally export the whole run as a
Chrome/Perfetto trace — open the emitted file at https://ui.perfetto.dev
to scrub through op spans, stream lifetimes, fault annotations and the
live-stream / bandwidth counter tracks.

Telemetry is strictly opt-in: ``run(telemetry=None)`` is the exact code
path every committed baseline fingerprint was produced with, and the
counters are identical across all four engines.

  PYTHONPATH=src python -m repro_torch.examples.telemetry
"""

import dataclasses
import pathlib
import tempfile


def main():
    from repro_torch.core.noc.faults import FaultSet
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.telemetry import (
        Collector, perfetto_json, render_heatmap,
    )
    from repro_torch.core.noc.traffic import collective_storm, replay
    from repro_torch.core.topology import Mesh2D

    mesh = Mesh2D(16, 16)
    trace = collective_storm(mesh, tile_bytes=2048, phases=2)

    print("healthy 16x16 collective storm, counters on:")
    col = Collector()
    res = replay(trace, params=PAPER_MICRO, telemetry=col)
    stats = col.stats()
    print(f"  makespan {res.makespan}, {stats.total_busy_beats()} busy "
          f"beats over {len(stats.link_busy)} (link, VC) pairs")
    print(render_heatmap(stats, "link"))
    print("  hottest links:")
    for row in stats.link_table(5):
        print(f"    {row['link']:>22}  {row['busy_beats']:>5} beats  "
              f"util {row['utilization']:.3f}")

    print("\nsame storm, 2 dead links (seed=1) — detours move the heat:")
    faults = FaultSet.sample(mesh, dead_links=2, seed=1)
    fcol = Collector()
    fres = replay(trace,
                  params=dataclasses.replace(PAPER_MICRO, faults=faults),
                  telemetry=fcol)
    fstats = fcol.stats()
    print(f"  makespan {res.makespan} -> {fres.makespan}, peak link "
          f"utilization {stats.link_table(1)[0]['utilization']:.3f} -> "
          f"{fstats.link_table(1)[0]['utilization']:.3f}")
    print(render_heatmap(fstats, "link"))

    out = pathlib.Path(tempfile.mkdtemp(prefix="repro_tel_")) / "storm16.json"
    out.write_text(perfetto_json(col))
    n_events = perfetto_json(col).count('"ph"')
    print(f"\nPerfetto trace: {n_events} events -> {out}")
    print("  (open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
