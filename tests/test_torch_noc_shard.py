"""The port's region-sharded engine against the reference's, byte for byte.

``repro_torch.core.noc.shard`` is the port's own copy of the reference's
shard engine (its in-process and fork backends, the supervisor and
``set_chaos``).  Each case feeds the same arguments through both packages
and compares plain documents, never objects (the two packages' classes
differ): the configuration a spec parses to, the engine's profile counters
and a finished run's document (every stream's done cycle, VC and arrivals,
and the arbitration counter ``_rr``).  The simulator is integer and
``Fraction`` arithmetic, so every comparison is exact.  A fork run asks for
at most 2 workers.
"""

import contextlib
import dataclasses
import hashlib
import json
import random

import pytest

from test_torch_noc_program import PKGS, _both, _doc, _m, _run_doc

SHARD_ENGINES = ("shard:2x2:1", "shard:1x2:1", "shard::2")


# ---------------------------------------------------------------------------
# Workloads and documents shared by the runtime-half parity tests
# ---------------------------------------------------------------------------


def params(pkg: str, name: str = "plain"):
    """The parameter sets of the reference's resilience and telemetry tests."""
    P = _m(pkg, "core.noc.params").NoCParams
    Coord = _m(pkg, "core.topology").Coord
    faults = _m(pkg, "core.noc.faults.model")
    if name == "plain":
        return P()
    if name == "multivc":
        return P(routing="o1turn", num_vcs=3, vc_select="packet")
    if name == "faulted":
        return P(routing="oddeven", num_vcs=2, faults=faults.FaultSet(
            dead_links=frozenset({(Coord(2, 2), Coord(3, 2))}),
            dead_routers=frozenset({Coord(4, 4)})))
    assert name == "flaky"
    return P(routing="oddeven", num_vcs=2, faults=faults.FaultSet(
        dead_links=frozenset({(Coord(2, 2), Coord(3, 2))}),
        flaky_links=(faults.FlakyLink(Coord(1, 3), Coord(2, 3), duty=0.5),), seed=5))


def build_sim(pkg: str, name: str = "plain", seed: int = 7, n_unicasts: int = 10):
    """The mixed 6x6 workload of the reference's ``test_resilience.py``:
    unicasts, a multicast, a reduction and a gated stream, with endpoints
    clear of the faulted set's dead router."""
    topo = _m(pkg, "core.topology")
    Coord = topo.Coord
    sim = _m(pkg, "core.noc.netsim").NoCSim(topo.Mesh2D(6, 6), params(pkg, name))
    rng = random.Random(seed)
    tiles = [Coord(x, y) for x in range(6) for y in range(6) if (x, y) != (4, 4)]
    for _ in range(n_unicasts):
        a, b = rng.sample(tiles, 2)
        sim.add_unicast(a, b, 4096)
    mc = sim.add_multicast(Coord(0, 0), topo.MultiAddress(Coord(2, 2), 0b1, 0b1), 2048)
    red = sim.add_reduction([Coord(5, 0), Coord(0, 5), Coord(5, 5)], Coord(3, 3), 2048)
    gated = sim.add_unicast(Coord(1, 1), Coord(3, 5), 8192)
    gated.gates.extend([mc, red])
    return sim


def storm_sim(pkg: str, side: int, tile_bytes: int = 2048, nparams=None):
    """One phase of the collective storm lowered onto one sim, as the
    reference's benchmarks lower it (barriers and compute are no traffic)."""
    from_trace = _m(pkg, "core.noc.program").from_trace
    lower = _m(pkg, "core.noc.program.lower")
    ops = _m(pkg, "core.noc.program.ops")
    prog = from_trace(_m(pkg, "core.noc.traffic").collective_storm(
        _m(pkg, "core.topology").Mesh2D(side, side), tile_bytes=tile_bytes, phases=1))
    p = lower.effective_params(prog, nparams or _m(pkg, "core.noc.params").PAPER_MICRO,
                               None, None)
    sim = _m(pkg, "core.noc.netsim").NoCSim(prog.mesh, p)
    for op in prog.ops:
        if not isinstance(op, (ops.BarrierOp, ops.ComputeOp)):
            lower.add_op(sim, op, op.start, p)
    return sim


def sim_doc(sim) -> str:
    """sha256 of a run: each stream's done cycle, VC and arrivals on every
    edge, and the arbitration counter."""
    doc = [[[st.done_cycle, st.vc, sorted([a.x, a.y, b.x, b.y, list(arr)]
                                           for (a, b), arr in st.arrivals.items())]
            for st in sim.streams], sim._rr]
    return hashlib.sha256(json.dumps(doc, default=repr).encode()).hexdigest()


# ---------------------------------------------------------------------------
# Engine specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ("shard", "shard:3x2", "shard:2x2:4", "shard::8",
                                  "shard:2x2:1", "shard:1x2:1"))
def test_parse_shard_engine_parity(spec):
    ref, port = _both(lambda pkg: dataclasses.asdict(
        _m(pkg, "core.noc.shard").parse_shard_engine(spec)))
    assert port == ref


@pytest.mark.parametrize("spec", ("shard:2y2", "shard:axb", "shard:2x2:many", "shard:1:2:3"))
def test_bad_shard_spec_refused_alike(spec):
    def refuse(pkg):
        with pytest.raises(ValueError) as exc:
            _m(pkg, "core.noc.shard").parse_shard_engine(spec)
        return str(exc.value)

    ref, port = _both(refuse)
    assert port == ref


def test_auto_grid_and_resolve_parity():
    def grids(pkg):
        shard = _m(pkg, "core.noc.shard")
        Mesh2D = _m(pkg, "core.topology").Mesh2D
        meshes = [Mesh2D(c, r) for c, r in ((64, 64), (128, 128), (4, 4), (16, 8), (8, 16),
                                            (3, 5), (1, 7))]
        return ([shard.auto_grid(m, t) for m in meshes for t in range(1, 9)],
                [shard.ShardConfig(grid=g, workers=w).resolve(m) for m in meshes
                 for g in ((16, 16), (2, 2), None) for w in (1, 2, None)])

    ref, port = _both(grids)
    assert port == ref
    assert ref[0][0] == (1, 1) and ref[0][3] == (2, 2)  # 64x64: 1 and 4 regions


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", SHARD_ENGINES)
@pytest.mark.parametrize("mode", ("op", "barrier"))
def test_run_program_on_shard_parity(mode, engine):
    """The three programs of ``test_torch_noc_program._run_doc``: the port's
    shard run equals the reference's and the port's own heap run."""
    ref, port = _both(_run_doc, mode, engine)
    assert port == ref
    assert port == _run_doc("repro_torch", mode, "heap")


def _profiled_storm(pkg, engine):
    sim = storm_sim(pkg, 8, tile_bytes=512)
    prof = sim.run(engine=engine, profile=True)
    return _doc([prof.engine, prof.makespan, prof.counters(), sim_doc(sim)])


@pytest.mark.parametrize("engine", ("heap",) + SHARD_ENGINES)
def test_engine_profile_counters_parity(engine):
    ref, port = _both(_profiled_storm, engine)
    assert port == ref
    counters = json.loads(port)[2]
    if engine != "heap":
        assert counters["epochs"] > 0 and counters["boundary_reconciliations"] > 0
        assert counters["regions"] == (4 if engine == "shard:2x2:1" else 2)
        assert counters["heap_pops"] > 0
        assert counters["workers"] == (2 if engine == "shard::2" else 0)


def _faulted_doc(pkg, engine, name):
    sim = build_sim(pkg, name)
    prof = sim.run(engine=engine, profile=True)
    return _doc([prof.makespan, prof.retries_paid, prof.detoured_routes, sim_doc(sim)])


@pytest.mark.parametrize("engine", ("heap", "shard:2x2:1", "shard:2x2:2"))
@pytest.mark.parametrize("name", ("faulted", "flaky"))
def test_faulted_shard_run_parity(name, engine):
    """A dead link (and a dead router or a flaky link) on the shard engine:
    the reference's run, and the port's heap run."""
    ref, port = _both(_faulted_doc, engine, name)
    assert port == ref
    _, retries, detoured, _ = json.loads(port)
    assert detoured > 0 and (retries > 0) == (name == "flaky")
    assert json.loads(port)[3] == json.loads(_faulted_doc("repro_torch", "heap", name))[3]


def test_storm32_shard_parity():
    def run(pkg, engine):
        sim = storm_sim(pkg, 32)
        return [sim.run(engine=engine), sim_doc(sim)]

    port = run("repro_torch", "shard:2x2:2")
    assert port == run("repro", "shard:2x2:2") == run("repro_torch", "heap")


def test_sigkilled_worker_recovers_as_in_the_reference():
    """``set_chaos`` SIGKILLs fork worker 1 at its third op: the run is the
    undisturbed one, with the reference's respawn and retry counts."""
    def run(pkg, chaos):
        shard = _m(pkg, "core.noc.shard")
        cfg = shard.ShardConfig(grid=(2, 2), workers=2)
        prof = _m(pkg, "core.noc.engine").EngineProfile(engine="shard")
        sim = build_sim(pkg)
        if chaos:
            shard.set_chaos("kill", worker=1, at_op=3)
        try:
            with (pytest.warns(RuntimeWarning, match="respawning and replaying") if chaos
                  else contextlib.nullcontext()):
                prof.makespan = shard.run_shard(sim, 2_000_000, cfg, prof)
        finally:
            shard.set_chaos(None)
        return [prof.makespan, prof.worker_respawns, prof.worker_retries, sim_doc(sim)]

    ref, port = [run(pkg, True) for pkg in PKGS]
    assert port == ref
    assert port[1] == 1 and port[2] >= 1
    undisturbed = run("repro_torch", False)
    assert undisturbed[1:3] == [0, 0]
    assert [port[0], port[3]] == [undisturbed[0], undisturbed[3]]
