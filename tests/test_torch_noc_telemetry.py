"""The port's fabric telemetry against the reference's.

``repro_torch.core.noc.telemetry`` is the port's copy of the reference's
Collector, FabricStats and Perfetto export.  The same run goes through both
packages with a Collector attached, and the collector's state document, its
FabricStats, its stream spans and time series, the Perfetto JSON and the
rendered heatmap are compared exactly: between the packages, and across the
cycle, event, heap and shard engines.
"""

import dataclasses
import json

import pytest

from test_torch_noc_program import _both, _doc, _m
from test_torch_noc_shard import build_sim, sim_doc

ENGINES = ("cycle", "event", "heap", "shard:2x2:1")


def _tel(pkg):
    return _m(pkg, "core.noc.telemetry")


def _stats_doc(stats) -> str:
    """FabricStats as text: its sizes and makespan, and each counter table
    as sorted (key, count) pairs (keys hold Coords, so by their repr)."""
    doc = {}
    for f in dataclasses.fields(stats):
        v = getattr(stats, f.name)
        doc[f.name] = sorted((repr(k), n) for k, n in v.items()) if isinstance(v, dict) else v
    return _doc(doc)


def _transpose_run(pkg, engine):
    """bench_telemetry.py's engine-parity case: an 8x8 transpose at rate
    0.1, 4 packets of 256 B per node, replayed with a Collector."""
    traffic = _m(pkg, "core.noc.traffic")
    trace = traffic.synthetic_trace(_m(pkg, "core.topology").Mesh2D(8, 8),
                                    traffic.SyntheticConfig(pattern="transpose", rate=0.1,
                                                            nbytes=256, packets_per_node=4,
                                                            seed=0))
    col = _tel(pkg).Collector()
    res = traffic.replay(trace, params=_m(pkg, "core.noc.params").PAPER_MICRO, engine=engine,
                         telemetry=col)
    return res.makespan, col


def _collector_doc(col) -> str:
    return json.dumps(col.state_dict(), sort_keys=True, default=repr)


@pytest.mark.parametrize("engine", ENGINES)
def test_transpose_collector_parity(engine):
    def run(pkg):
        makespan, col = _transpose_run(pkg, engine)
        st = col.stats()
        return [makespan, _collector_doc(col), _stats_doc(st), st.total_busy_beats(),
                sum(st.tile_inject.values()), sum(st.tile_eject.values())]

    ref, port = _both(run)
    assert port == ref
    assert port[3] > 0 and port[4] == port[5] > 0


def test_transpose_stats_equal_across_engines():
    docs = {e: _stats_doc(_transpose_run("repro_torch", e)[1].stats()) for e in ENGINES}
    assert len(set(docs.values())) == 1, docs.keys()


@pytest.mark.parametrize("name", ("plain", "multivc", "faulted", "flaky"))
def test_mixed_workload_stats_parity(name):
    """The 6x6 mixed workload (flaky links charge retries) on the fork
    workers: the reference's stats, and the port's heap stats."""
    def run(pkg, engine):
        sim = build_sim(pkg, name)
        col = _tel(pkg).Collector()
        makespan = sim.run(engine=engine, telemetry=col)
        return [makespan, sim_doc(sim), _stats_doc(col.stats()),
                col.stats().total_retries()]

    ref, port = _both(run, "shard:2x2:2")
    assert port == ref
    assert port == run("repro_torch", "heap")
    assert (port[3] > 0) == (name == "flaky")


def test_perfetto_and_heatmap_parity():
    def export(pkg):
        tel = _tel(pkg)
        _, col = _transpose_run(pkg, "heap")
        col.annotate(3, "fault_event", "synthetic")
        st = col.stats()
        return [tel.perfetto_json(col), _doc(tel.trace_events(col)),
                tel.render_heatmap(st, "link"), tel.render_heatmap(st, "inject"),
                _doc(st.link_table(4)), _doc(col.stream_spans()), _doc(col.timeseries())]

    ref, port = _both(export)
    assert port == ref
    assert json.loads(port[0])["traceEvents"]


@pytest.mark.parametrize("mode", ("op", "barrier", "window"))
def test_program_spans_parity(mode):
    """``run_program(..., telemetry=Collector())`` records the same op spans."""
    def run(pkg):
        topo = _m(pkg, "core.topology")
        Coord = topo.Coord
        b = _m(pkg, "core.noc.program").ProgramBuilder(topo.Mesh2D(4, 4))
        a = b.unicast(Coord(0, 0), Coord(3, 3), 512)
        b.compute(Coord(1, 1), 40, deps=[a])
        b.reduction([(0, 0), (3, 0), (0, 3)], (3, 3), 1024, deps=[a])
        b.unicast(Coord(3, 3), Coord(0, 0), 256, phase=1)
        col = _tel(pkg).Collector()
        res = _m(pkg, "core.noc.program").run_program(b.build(), mode=mode, telemetry=col)
        return [res.makespan, _doc(col.ops), _collector_doc(col), _tel(pkg).perfetto_json(col)]

    ref, port = _both(run)
    assert port == ref
    assert {lane for _, lane, _, _ in json.loads(port[1])} == {"comm", "compute"}


@pytest.mark.parametrize("engine", ENGINES)
def test_checkpoint_with_collector_parity(engine):
    """A snapshot with a Collector attached carries its state: the same
    bytes in both packages, and the restored run's stats are the
    uninterrupted run's."""
    def run(pkg):
        res = _m(pkg, "core.noc.resilience")
        full = build_sim(pkg)
        full_col = _tel(pkg).Collector()
        mk = full.run(engine=engine, telemetry=full_col)
        sim = build_sim(pkg)
        sim.run(engine=engine, telemetry=_tel(pkg).Collector(), stop_at=mk // 2)
        snap = res.checkpoint(sim, mk // 2)
        resumed = res.restore(res.Snapshot.from_json(snap.to_json()))
        assert resumed.run(engine=engine, start_cycle=mk // 2) == mk
        return [snap.to_json(), snap.fingerprint, _stats_doc(resumed.telemetry.stats()),
                _stats_doc(full_col.stats())]

    ref, port = _both(run)
    assert port == ref
    assert port[2] == port[3] and "telemetry" in json.loads(port[0])


def test_collector_state_loads_in_the_other_package():
    """A reference collector's state, through JSON, loads in the port and
    gives back the same state."""
    _, col = _transpose_run("repro", "heap")
    state = json.loads(json.dumps(col.state_dict()))
    back = _tel("repro_torch").Collector.from_state(state)
    assert _collector_doc(back) == _collector_doc(col)
