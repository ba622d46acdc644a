"""The port's checkpoints, resumes and mid-run faults against the reference's.

``repro_torch.core.noc.resilience`` is the port's copy of the reference's
checkpoint/restart, supervision and fault-timeline modules, and keeps the
reference's format tag (``repro-noc-checkpoint``), so a snapshot written by
either package loads in the other.  Each case runs the same workload through
both packages and compares the snapshot's canonical JSON and sha256
fingerprint, or a finished run's document (``test_torch_noc_shard.sim_doc``),
exactly.
"""

import dataclasses
import json

import pytest

from test_torch_noc_program import PKGS, _both, _m
from test_torch_noc_shard import build_sim, sim_doc, storm_sim

ENGINES = ("cycle", "event", "heap", "shard:2x2:1")


def _res(pkg):
    return _m(pkg, "core.noc.resilience")


def _makespan(name: str = "plain") -> int:
    return build_sim("repro", name).run(engine="heap")


def _snapshots(pkg, engine, name, cuts):
    out = []
    for cut in cuts:
        sim = build_sim(pkg, name)
        assert sim.run(engine=engine, stop_at=cut) == cut
        snap = _res(pkg).checkpoint(sim, cut)
        out.append((snap.to_json(), snap.fingerprint))
    return out


@pytest.mark.parametrize("name", ("plain", "multivc", "faulted"))
@pytest.mark.parametrize("engine", ENGINES)
def test_snapshots_are_byte_identical(engine, name):
    """Snapshots at cycles 0, 1, mid-run and makespan - 1."""
    mk = _makespan(name)
    ref, port = _both(_snapshots, engine, name, (0, 1, mk // 2, mk - 1))
    assert port == ref
    assert json.loads(port[2][0])["format"] == "repro-noc-checkpoint"


@pytest.mark.parametrize("writer,reader", (PKGS, PKGS[::-1]), ids=("ref-to-port", "port-to-ref"))
@pytest.mark.parametrize("engine", ("heap", "shard:2x2:1"))
def test_snapshot_file_resumes_in_the_other_package(tmp_path, writer, reader, engine):
    """A snapshot file written by one package, restored by the other and
    resumed, ends in the writer's uninterrupted run."""
    ref = build_sim(writer, "faulted")
    mk = ref.run(engine="heap")
    cut = mk // 2
    sim = build_sim(writer, "faulted")
    sim.run(engine="event", stop_at=cut)
    path = tmp_path / "ck.json"
    _res(writer).checkpoint(sim, cut).save(path)
    resumed = _res(reader).restore(_res(reader).Snapshot.load(path))
    assert resumed.run(engine=engine, start_cycle=cut) == mk
    assert sim_doc(resumed) == sim_doc(ref)


def test_run_with_autocheckpoint_parity(tmp_path):
    def run(pkg):
        sim = build_sim(pkg)
        mk = sim.run(engine="heap")
        path = tmp_path / f"{pkg}.ckpt.json"
        done, makespan = _res(pkg).run_with_autocheckpoint(build_sim(pkg), str(path),
                                                           interval=max(1, mk // 4),
                                                           engine="shard:2x2:1")
        assert not path.exists()
        return [makespan, sim_doc(done), sim_doc(sim)]

    ref, port = _both(run)
    assert port == ref
    assert port[1] == port[2]


def test_autocheckpoint_resumes_a_reference_snapshot(tmp_path):
    """An interrupted reference run's snapshot is resumed by the port's
    ``run_with_autocheckpoint`` to the reference's uninterrupted run."""
    ref = build_sim("repro")
    mk = ref.run(engine="heap")
    interval = max(1, mk // 3)
    first = build_sim("repro")
    assert first.run(engine="heap", stop_at=interval) == interval
    path = tmp_path / "auto.ckpt.json"
    _res("repro").checkpoint(first, interval).save(path)
    sim, makespan = _res("repro_torch").run_with_autocheckpoint(
        build_sim("repro_torch"), str(path), interval=interval)
    assert makespan == mk
    assert sim_doc(sim) == sim_doc(ref)
    assert not path.exists()


@pytest.mark.parametrize("corrupt,match", (
    (lambda d: d["sim"].update(rr=d["sim"]["rr"] + 1), "fingerprint mismatch"),
    (lambda d: d.update(format="something-else"), "not a repro-noc-checkpoint"),
    (lambda d: d.update(version=99), "unsupported checkpoint version"),
), ids=("payload", "format", "version"))
def test_corrupted_snapshot_refused_by_both(corrupt, match):
    sim = build_sim("repro_torch")
    sim.run(engine="heap", stop_at=25)
    doc = json.loads(_res("repro_torch").checkpoint(sim, 25).to_json())
    corrupt(doc)
    for pkg in PKGS:
        with pytest.raises(ValueError, match=match):
            _res(pkg).Snapshot.from_json(json.dumps(doc))


# ---------------------------------------------------------------------------
# Fault timelines
# ---------------------------------------------------------------------------


def test_timeline_documents_parity():
    def docs(pkg):
        res = _res(pkg)
        mesh = _m(pkg, "core.topology").Mesh2D(8, 8)
        tl = res.FaultTimeline.sample(mesh, events=3, seed=42, dead_links=1, dead_routers=1)
        assert res.FaultTimeline.from_dict(tl.to_dict()) == tl
        return json.dumps(tl.to_dict(), sort_keys=True)

    ref, port = _both(docs)
    assert port == ref


def _midrun(pkg, engine):
    """bench_resilience.py's mid-run case: the 16x16 storm, the link
    (7,8)->(8,8) dead from the start (static) or from a third of the
    pristine makespan (mid-run)."""
    res = _res(pkg)
    Coord = _m(pkg, "core.topology").Coord
    FaultSet = _m(pkg, "core.noc.faults.model").FaultSet
    params = _m(pkg, "core.noc.params").PAPER_MICRO
    dead = FaultSet(dead_links=frozenset({(Coord(7, 8), Coord(8, 8))}))
    pristine = storm_sim(pkg, 16).run(engine="heap")
    static = storm_sim(pkg, 16, nparams=dataclasses.replace(params, faults=dead)).run(
        engine="heap")
    sim = storm_sim(pkg, 16)
    prof = res.run_with_timeline(sim, res.FaultTimeline([res.FaultEvent(pristine // 3, dead)]),
                                 engine=engine, profile=True)
    return [pristine, static, prof.makespan, prof.fault_events, prof.relowered_streams,
            prof.dropped_streams, sim_doc(sim)]


@pytest.mark.parametrize("engine", ("heap", "shard:2x2:1"))
def test_midrun_fault_parity(engine):
    ref, port = _both(_midrun, engine)
    assert port == ref
    assert port[3] == 1 and port[4] >= 1
    assert port == _midrun("repro_torch", "heap")


def _timeline_doc(pkg, engine):
    res = _res(pkg)
    Coord = _m(pkg, "core.topology").Coord
    FaultSet = _m(pkg, "core.noc.faults.model").FaultSet
    sim = build_sim(pkg)
    victim = sim.add_unicast(Coord(0, 0), Coord(4, 4), 1 << 14)
    tl = res.FaultTimeline([
        res.FaultEvent(30, FaultSet(dead_links=frozenset({(Coord(2, 2), Coord(3, 2))}))),
        res.FaultEvent(60, FaultSet(dead_routers=frozenset({Coord(4, 4)}))),
    ])
    makespan, snaps = res.run_with_timeline(sim, tl, engine=engine, checkpoint_events=True)
    return [makespan, victim.done_cycle, dict(sim._fault_counts), sim_doc(sim),
            [(s.cycle, s.fingerprint) for s in snaps]]


@pytest.mark.parametrize("engine", ENGINES)
def test_timeline_with_dead_router_parity(engine):
    """Two events, a dead link then a dead router that drops a victim, with a
    snapshot at each event: the same runs, counters and snapshots."""
    ref, port = _both(_timeline_doc, engine)
    assert port == ref
    assert [c for c, _ in port[4]] == [30, 60]
    assert port[2]["dropped_streams"] >= 1 and port[1] == 60


def test_supervise_config_parity():
    def doc(pkg):
        sup = _m(pkg, "core.noc.resilience.supervise")
        return dataclasses.asdict(sup.SuperviseConfig())

    ref, port = _both(doc)
    assert port == ref
