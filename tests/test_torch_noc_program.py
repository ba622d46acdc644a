"""The port's fabric half against the reference's, byte for byte.

``repro_torch`` keeps its own copy of the framework-free NoC substrate
(topology, routing, faults, engines, ``NoCSim``, traffic, the program IR,
fingerprints, energy and the paper's claims) and of the fabric-program
emitters of ``core/schedules.py``, ``core/summa.py`` and
``core/overlap.py``.  Every case here feeds the same arguments through
both packages and compares plain values: the objects of the two packages
are different classes, so programs compare through ``to_json()`` and
results through a JSON document of their numbers.  The port alone must
also reproduce the golden sha256 prefixes that ``tests/test_program.py``
pins (computed by ``chip_smoke.fabric_fingerprints``, the code that
phase 8 of ``chip_smoke.py`` runs on the card machine, where there is no
JAX).
"""

import ast
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("repro", "repro_torch")
SCHEDULES = ("native", "chain", "pipelined", "tree")
ENGINES = ("cycle", "event", "heap")
MODES = ("op", "barrier", "window")
STORMS = {
    "summa_storm": dict(tile_bytes=2048, iters=2, interval=3.0),
    "fcl_storm": dict(tile_bytes=1024, phases=2),
    "mixed_storm": dict(phases=2),
    "collective_storm": dict(tile_bytes=2048, phases=2),
}
N_CLAIMS = 27


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _both(fn, *args, **kw):
    """``fn(pkg, ...)`` for the reference and the port."""
    return [fn(pkg, *args, **kw) for pkg in PKGS]


def _doc(value) -> str:
    """Exact JSON of plain values (floats by repr; Fractions as text)."""
    return json.dumps(value, sort_keys=True, default=repr)


def _result_doc(res) -> str:
    """Makespan, per-op (id, kind, inject, done), phase ends and stats."""
    return _doc([res.makespan,
                 [(r.op.id, r.op.kind, r.inject_cycle, r.done_cycle) for r in res.runs],
                 res.phase_end, dataclasses.asdict(res.stats())])


def _replay_doc(res) -> str:
    return _doc([res.makespan, [(s.inject_cycle, s.done_cycle) for s in res.streams],
                 res.phase_end])


def _row(pkg: str, n: int):
    topo = _m(pkg, "core.topology")
    return topo.Mesh2D(n, 1), [topo.Coord(x, 0) for x in range(n)]


# ---------------------------------------------------------------------------
# Emitters
# ---------------------------------------------------------------------------


def _broadcast_json(pkg, n, schedule):
    mesh, members = _row(pkg, n)
    b = _m(pkg, "core.noc.program").ProgramBuilder(mesh)
    for nbytes in (0, 1024, 8192, 32768):
        for chunks in (1, 4):
            for root in sorted({0, n - 1}):
                _m(pkg, "core.schedules").broadcast_ops(
                    b, members, root=root, nbytes=nbytes, schedule=schedule,
                    chunks=chunks, phase=nbytes)
    return b.build().to_json()


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_broadcast_ops_parity(schedule, n):
    ref, port = _both(_broadcast_json, n, schedule)
    assert port == ref


def _all_reduce_json(pkg, n, schedule, pipeline):
    mesh, members = _row(pkg, n)
    b = _m(pkg, "core.noc.program").ProgramBuilder(mesh)
    prev = None
    for nbytes in (0, 1024, 8192, 32768):
        for root in sorted({0, n - 1}):
            prev = _m(pkg, "core.schedules").all_reduce_ops(
                b, members, nbytes=nbytes, schedule=schedule, root=root, deps=prev,
                phase=nbytes, pipeline=pipeline)
    return b.build().to_json()


@pytest.mark.parametrize("pipeline", ("deps", "offsets"))
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_all_reduce_ops_parity(schedule, n, pipeline):
    ref, port = _both(_all_reduce_json, n, schedule, pipeline)
    assert port == ref


def _shim_events(pkg, schedule):
    sched = _m(pkg, "core.schedules")
    _, row8 = _row(pkg, 8)
    with pytest.deprecated_call():
        bc = sched.broadcast_noc_events(row8, 2, 8192, schedule=schedule, chunks=4)
    with pytest.deprecated_call():
        ar = sched.all_reduce_noc_events(row8, 8192, schedule=schedule)
    return _doc([[e.to_dict() for e in bc], [e.to_dict() for e in ar]])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_deprecated_event_shims_parity(schedule):
    ref, port = _both(_shim_events, schedule)
    assert port == ref


def _summa_json(pkg, side, compute):
    mesh = _m(pkg, "core.topology").Mesh2D(side, side)
    summa = _m(pkg, "core.summa")
    return [summa.summa_program(mesh, 2048, schedule=s, compute_cycles=compute).to_json()
            for s in SCHEDULES]


@pytest.mark.parametrize("compute", (None, 0.0, "model"))
@pytest.mark.parametrize("side", (2, 4, 8))
def test_summa_program_parity(side, compute):
    ref, port = _both(_summa_json, side, compute)
    assert port == ref


def test_summa_compute_cycles_parity():
    sizes = (1, 8, 2048, 32768, 1 << 20)
    ref, port = _both(lambda pkg: [_m(pkg, "core.summa").summa_compute_cycles(t, d)
                                   for t in sizes for d in (2, 4, 8)])
    assert port == ref


def _overlap_json(pkg, which, n):
    topo = _m(pkg, "core.topology")
    ov = _m(pkg, "core.overlap")
    members = [topo.Coord(x, 0) for x in range(n)]
    fn = ov.ag_matmul_program if which == "ag" else ov.matmul_rs_program
    prog = fn(topo.Mesh2D(n, n), members, 2048)
    shim = ov.ag_matmul_noc_trace if which == "ag" else ov.matmul_rs_noc_trace
    with pytest.deprecated_call():
        trace = shim(topo.Mesh2D(n, n), members, 2048)
    return prog.to_json(), trace.to_json()


@pytest.mark.parametrize("n", (4, 8))
@pytest.mark.parametrize("which", ("ag", "rs"))
def test_overlap_programs_parity(which, n):
    ref, port = _both(_overlap_json, which, n)
    assert port == ref


# ---------------------------------------------------------------------------
# run_program on every engine and mode
# ---------------------------------------------------------------------------


def _run_doc(pkg, mode, engine):
    topo = _m(pkg, "core.topology")
    summa = _m(pkg, "core.summa")
    prog_mod = _m(pkg, "core.noc.program")
    P = _m(pkg, "core.noc.params").PAPER_MICRO
    mesh = topo.Mesh2D(4, 4)
    progs = [summa.summa_program(mesh, 2048, schedule="tree", iters=2, compute_cycles="model"),
             summa.summa_program(mesh, 1024, schedule="pipelined", iters=2)]
    b = prog_mod.ProgramBuilder(mesh)
    _m(pkg, "core.schedules").all_reduce_ops(b, [topo.Coord(x, 1) for x in range(4)],
                                             nbytes=4096, phase=0)
    progs.append(b.build())
    return [_result_doc(prog_mod.run_program(p, P, mode=mode, engine=engine)) for p in progs]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("mode", MODES)
def test_run_program_parity(mode, engine):
    ref, port = _both(_run_doc, mode, engine)
    assert port == ref


# ---------------------------------------------------------------------------
# Traffic: storms, sweep, faults
# ---------------------------------------------------------------------------


def _storm_doc(pkg, name):
    traffic = _m(pkg, "core.noc.traffic")
    P = _m(pkg, "core.noc.params").PAPER_MICRO
    trace = getattr(traffic, name)(_m(pkg, "core.topology").Mesh2D(4, 4), **STORMS[name])
    return [trace.to_json()] + [_replay_doc(traffic.replay(trace, params=P, mode=mode))
                                for mode in ("barrier", "window")]


@pytest.mark.parametrize("name", sorted(STORMS))
def test_storm_parity(name):
    ref, port = _both(_storm_doc, name)
    assert port == ref


def _sweep_doc(pkg, pattern):
    sweep = _m(pkg, "core.noc.traffic").saturation_sweep
    pts = sweep(_m(pkg, "core.topology").Mesh2D(4, 4), pattern, (0.02, 0.1, 0.4),
                nbytes=256, seed=3, workers=1)
    calib = _m(pkg, "core.noc.calibrate")
    claims = [dataclasses.asdict(c) for c in calib.load_claims(pts, at_rate=0.1)]
    return _doc([[dataclasses.asdict(p) for p in pts], claims])


@pytest.mark.parametrize("pattern", ("uniform", "hotspot"))
def test_saturation_sweep_parity(pattern):
    ref, port = _both(_sweep_doc, pattern)
    assert port == ref


def _degraded_doc(pkg):
    topo = _m(pkg, "core.topology")
    faults = _m(pkg, "core.noc.faults")
    params = _m(pkg, "core.noc.params")
    mesh = topo.Mesh2D(8, 8)
    fs = faults.FaultSet.sample(mesh, dead_links=2, dead_routers=1, flaky_links=1, seed=7)
    prog = faults.degrade_program(
        _m(pkg, "core.summa").summa_program(mesh, 2048, schedule="native", iters=2), fs)
    res = _m(pkg, "core.noc.program").run_program(prog, params.NoCParams(routing="xy",
                                                                          num_vcs=2))
    return _doc([fs.to_dict(), prog.to_json(), _result_doc(res)])


def test_degraded_run_parity():
    ref, port = _both(_degraded_doc)
    assert port == ref
    assert '"faults"' in json.loads(port)[1]


# ---------------------------------------------------------------------------
# The paper's claims and Table 1
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def claims():
    return _both(lambda pkg: [dataclasses.asdict(c) | {"ok": c.ok}
                              for c in _m(pkg, "core.noc.calibrate").all_claims()])


def test_claim_count(claims):
    ref, port = claims
    assert len(ref) == len(port) == N_CLAIMS


@pytest.mark.parametrize("i", range(N_CLAIMS))
def test_claim_parity(claims, i):
    ref, port = claims
    assert _doc(port[i]) == _doc(ref[i])
    assert port[i]["ok"], port[i]


def test_report_and_table1_parity():
    ref, port = _both(lambda pkg: (_m(pkg, "core.noc.calibrate").report(),
                                   _doc(_m(pkg, "core.noc.energy").table1())))
    assert port == ref


def test_fit_claims_parity():
    def fit(pkg):
        traffic = _m(pkg, "core.noc.traffic")
        calib = _m(pkg, "core.noc.calibrate")
        mesh = _m(pkg, "core.topology").Mesh2D(4, 4)
        curves = {nb: traffic.saturation_sweep(mesh, "uniform", (0.005, 0.01, 0.02),
                                               nbytes=nb, seed=1, workers=1)
                  for nb in (256, 1024)}
        cfg = traffic.SyntheticConfig(pattern="uniform", rate=0.01, nbytes=256, seed=1)
        return _doc(dataclasses.asdict(calib.fit_claims(
            curves, calib.population_mean_hops(mesh, cfg))))

    ref, port = _both(fit)
    assert port == ref


# ---------------------------------------------------------------------------
# State carried across: reference files load and run in the port
# ---------------------------------------------------------------------------


def _reference_files() -> dict:
    from repro.core.noc.program import ProgramBuilder
    from repro.core.noc.faults import FaultSet, degrade_program
    from repro.core.summa import summa_program
    from repro.core.topology import Mesh2D, Submesh

    v2 = summa_program(Mesh2D(4, 4), 2048, schedule="native").to_trace()
    v1 = json.loads(v2.to_json())
    del v1["version"]
    for k in ("routing", "num_vcs", "vc_select", "vc_map"):
        v1.pop(k, None)
    o1 = summa_program(Mesh2D(4, 4), 2048, schedule="tree").to_trace()
    o1.routing, o1.num_vcs, o1.vc_select = "o1turn", 2, "packet"
    b = ProgramBuilder(Mesh2D(4, 4), routing="o1turn", num_vcs=2, vc_select="packet",
                       vc_map=(("unicast", 1),))
    m0 = b.multicast((0, 0), Submesh(0, 0, 4, 1).multi_address(), 2048)
    r0 = b.reduction([(x, 3) for x in range(4)], (0, 3), 1024, deps=m0)
    c0 = b.compute((3, 0), cycles=500.0, deps=[m0], start=2.0)
    b.barrier([(0, 0), (3, 0)], flavor="sw", deps=[r0, c0])
    b.unicast((1, 1), (2, 2), 64, phase=5)
    mesh8 = Mesh2D(8, 8)
    fs = FaultSet.sample(mesh8, dead_links=2, flaky_links=1, seed=7)
    degraded = degrade_program(summa_program(mesh8, 1024, schedule="tree", iters=2), fs)
    return {
        "trace_v1": ("trace", json.dumps(v1)),
        "trace_v2": ("trace", v2.to_json()),
        "trace_v2_o1turn": ("trace", o1.to_json()),
        "program_v3": ("program", b.build().to_json()),
        "program_v3_compute": ("program", summa_program(
            Mesh2D(4, 4), 2048, iters=2, compute_cycles="model").to_json()),
        "program_v3_faults": ("program", degraded.to_json()),
    }


def _load_and_run(pkg, kind, text):
    prog_mod = _m(pkg, "core.noc.program")
    P = _m(pkg, "core.noc.params").PAPER_MICRO
    if kind == "trace":
        trace = _m(pkg, "core.noc.traffic").Trace.from_json(text)
        res = _m(pkg, "core.noc.traffic").replay(trace, params=P)
        return [trace.to_json(), _replay_doc(res),
                prog_mod.Program.from_json(text).to_json()]
    prog = prog_mod.Program.from_json(text)
    num_vcs = 2 if prog.faults is not None else None
    return [prog.to_json()] + [_result_doc(prog_mod.run_program(prog, P, mode=mode,
                                                                num_vcs=num_vcs))
                               for mode in MODES]


@pytest.mark.parametrize("name", ("trace_v1", "trace_v2", "trace_v2_o1turn", "program_v3",
                                  "program_v3_compute", "program_v3_faults"))
def test_reference_files_load_and_run_in_the_port(name):
    kind, text = _reference_files()[name]
    ref, port = _both(_load_and_run, kind, text)
    assert port == ref


# ---------------------------------------------------------------------------
# The port alone reproduces the goldens of tests/test_program.py
# ---------------------------------------------------------------------------


def golden_tables(path: Path) -> dict:
    """The ``GOLDEN_*`` dict literals of a module, parsed (not imported)."""
    tables = {}
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("GOLDEN_EMITTERS", "GOLDEN_TRACES",
                                           "GOLDEN_REPLAYS")):
            tables[node.targets[0].id] = ast.literal_eval(node.value)
    return tables


GOLDEN_NAMES = sorted(name for table in golden_tables(ROOT / "tests" / "test_program.py").values()
                      for name in table)


@pytest.fixture(scope="module")
def port_fingerprints():
    sys.path.insert(0, str(ROOT))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke.fabric_fingerprints()


def test_golden_count():
    assert len(GOLDEN_NAMES) == 21


@pytest.mark.parametrize("name", GOLDEN_NAMES)
def test_port_reproduces_golden(port_fingerprints, name):
    tables = golden_tables(ROOT / "tests" / "test_program.py")
    want = {k: v for table in tables.values() for k, v in table.items()}
    assert port_fingerprints[name] == want[name]
