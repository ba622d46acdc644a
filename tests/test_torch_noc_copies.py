"""The port's copies of the framework-free NoC modules are the reference's.

The machine with the card has no JAX, so ``repro_torch`` keeps its own
copy of ``core/topology.py`` and the whole of ``core/noc/`` (the shard
engine, ``resilience/``, ``telemetry/`` and ``service/`` included), and of
the fabric-program emitters of ``core/schedules.py``, ``core/summa.py`` and
``core/overlap.py``, instead of importing ``repro``.  A copy differs from
the reference only by ``repro_torch.`` in place of ``repro.``, and by the
four comments listed in ``DEVIATIONS``, which no longer name a change of the
reference's history; the format tags (``repro-noc-checkpoint``,
``repro-noc-result-store``) stay, so files written by either package load in
the other.
``chip_smoke.py``'s golden fingerprints are those of
``tests/test_program.py``, and the constants its phase 8 pins for the large
meshes, the 128x128 checkpoint and the mid-run fault are the reference's
results.
"""

import ast
import re
from pathlib import Path

import pytest

from test_torch_noc_resilience import _midrun
from test_torch_noc_shard import storm_sim

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

COPIES = (
    "core/topology.py",
    "core/noc/__init__.py",
    "core/noc/calibrate.py",
    "core/noc/energy.py",
    "core/noc/engine.py",
    "core/noc/faults/__init__.py",
    "core/noc/faults/model.py",
    "core/noc/faults/regraft.py",
    "core/noc/faults/repair.py",
    "core/noc/fingerprint.py",
    "core/noc/model.py",
    "core/noc/netsim.py",
    "core/noc/params.py",
    "core/noc/program/__init__.py",
    "core/noc/program/builder.py",
    "core/noc/program/lower.py",
    "core/noc/program/ops.py",
    "core/noc/resilience/__init__.py",
    "core/noc/resilience/checkpoint.py",
    "core/noc/resilience/supervise.py",
    "core/noc/resilience/timeline.py",
    "core/noc/routing/__init__.py",
    "core/noc/routing/policies.py",
    "core/noc/routing/trees.py",
    "core/noc/routing/turns.py",
    "core/noc/service/__init__.py",
    "core/noc/service/cache.py",
    "core/noc/service/client.py",
    "core/noc/service/jobs.py",
    "core/noc/service/scheduler.py",
    "core/noc/service/server.py",
    "core/noc/service/store.py",
    "core/noc/shard.py",
    "core/noc/telemetry/__init__.py",
    "core/noc/telemetry/collector.py",
    "core/noc/telemetry/perfetto.py",
    "core/noc/telemetry/stats.py",
    "core/noc/traffic/__init__.py",
    "core/noc/traffic/patterns.py",
    "core/noc/traffic/sweep.py",
    "core/noc/traffic/trace.py",
)

# (port text after the rename back, pattern of the reference text it stands
# for) for each place where a copy differs from the reference: four comments
# of the reference name the change of its own history that brought a
# guarantee, and the copies state the guarantee alone.  Each is found once on
# each side.
DEVIATIONS: dict[str, list[tuple[str, str]]] = {
    "core/noc/resilience/checkpoint.py": [
        ("(the checkpoint guarantee)", r"\(the PR \d+ checkpoint guarantee\)")],
    "core/noc/resilience/timeline.py": [
        ("\nThe fault subsystem resolves", r"\nPR \d+'s fault subsystem resolves")],
    "core/noc/service/jobs.py": [
        ("(the compile-once invariant)", r"\(the PR \d+ compile-once invariant\)")],
    "core/noc/service/scheduler.py": [
        ("# the Perfetto output) is untouched.", r"# the PR \d+ Perfetto output\) is untouched\.")],
}

EMITTERS = {
    "core/schedules.py": ("broadcast_ops", "all_reduce_ops", "_member_builder",
                          "broadcast_noc_events", "all_reduce_noc_events"),
    "core/summa.py": ("summa_compute_cycles", "summa_program", "summa_noc_trace"),
    "core/overlap.py": ("ag_matmul_program", "matmul_rs_program", "ag_matmul_noc_trace",
                        "matmul_rs_noc_trace"),
}


def _renamed_back(text: str) -> str:
    return re.sub(r"\brepro_torch\.", "repro.", text)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_the_reference_but_for_imports_and_listed_deviations(rel):
    port = _renamed_back((PORT / rel).read_text())
    ref = (REF / rel).read_text()
    for port_text, ref_pattern in DEVIATIONS.get(rel, ()):
        ref_texts = re.findall(ref_pattern, ref)
        assert port.count(port_text) == 1 and len(ref_texts) == 1, \
            f"{rel}: deviation not found once on each side"
        port = port.replace(port_text, ref_texts[0])
    assert port == ref


def test_every_deviation_is_of_a_listed_copy():
    assert set(DEVIATIONS) <= set(COPIES)


def test_every_noc_module_of_the_port_is_a_listed_copy():
    found = {str(p.relative_to(PORT)) for p in (PORT / "core" / "noc").rglob("*.py")}
    assert found == {rel for rel in COPIES if rel.startswith("core/noc/")}


def _functions(path: Path) -> dict:
    text = path.read_text()
    return {node.name: ast.get_source_segment(text, node)
            for node in ast.parse(text).body if isinstance(node, ast.FunctionDef)}


@pytest.mark.parametrize("rel,name", [(rel, name) for rel, names in EMITTERS.items()
                                      for name in names])
def test_emitter_is_the_reference_but_for_imports(rel, name):
    port = _functions(PORT / rel)[name]
    assert _renamed_back(port) == _functions(REF / rel)[name]


def _literals(path: Path, names) -> dict:
    """The module-level literal assignments to ``names`` in ``path``, parsed
    (not imported)."""
    found = {}
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id in names):
            found[node.targets[0].id] = ast.literal_eval(node.value)
    return found


@pytest.mark.parametrize("table", ("GOLDEN_EMITTERS", "GOLDEN_TRACES", "GOLDEN_REPLAYS"))
def test_chip_smoke_goldens_are_test_program_goldens(table):
    smoke = _literals(ROOT / "chip_smoke.py", (table,))
    ref = _literals(ROOT / "tests" / "test_program.py", (table,))
    assert smoke[table] == ref[table]
    assert len(ref[table]) in (4, 8, 9)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 8: the runtime half's pinned numbers are the reference's
# ---------------------------------------------------------------------------


SMOKE = _literals(ROOT / "chip_smoke.py",
                  ("FABRIC_PINNED", "STORM_TILE", "TELEMETRY_CASE", "SERVICE_GRID"))
PINNED = SMOKE["FABRIC_PINNED"]


def test_chip_smoke_pins_the_reference_storm64_makespan():
    sim = storm_sim("repro", 64, tile_bytes=SMOKE["STORM_TILE"])
    assert sim.run(engine="heap") == PINNED["storm64_makespan"]


def test_chip_smoke_pins_the_reference_storm128_makespan_and_snapshot():
    """Paused at half its makespan, the 128x128 storm's snapshot has the
    pinned fingerprint, and the run goes on to the pinned makespan."""
    from repro.core.noc.resilience import checkpoint

    sim = storm_sim("repro", 128, tile_bytes=SMOKE["STORM_TILE"])
    cut = PINNED["storm128_makespan"] // 2
    assert sim.run(engine="shard:1x2:1", stop_at=cut) == cut
    assert checkpoint(sim, cut).fingerprint[:16] == PINNED["storm128_snapshot_sha256"]
    assert sim.run(engine="shard:1x2:1", start_cycle=cut) == PINNED["storm128_makespan"]


def test_chip_smoke_pins_the_reference_midrun_fault():
    """bench_resilience.py's mid-run case (``test_torch_noc_resilience._midrun``)."""
    pristine, static, makespan, _, relowered, dropped, _ = _midrun("repro", "heap")
    assert {"midrun_pristine": pristine, "midrun_static": static, "midrun_fault": makespan,
            "midrun_relowered": relowered, "midrun_dropped": dropped} == \
        {k: v for k, v in PINNED.items() if k.startswith("midrun_")}


def test_chip_smoke_pins_the_reference_telemetry_peak():
    from repro.core.noc.params import PAPER_MICRO
    from repro.core.noc.telemetry import Collector
    from repro.core.noc.traffic import SyntheticConfig, replay, synthetic_trace
    from repro.core.topology import Mesh2D

    trace = synthetic_trace(Mesh2D(16, 16), SyntheticConfig(**SMOKE["TELEMETRY_CASE"]))
    col = Collector()
    replay(trace, params=PAPER_MICRO, routing="xy", num_vcs=2, telemetry=col)
    assert (col.stats().link_table(1)[0]["utilization"]
            == PINNED["telemetry_peak_utilization"])


def test_chip_smoke_service_grid_is_bench_service_grid():
    """``GRID = dict(...)`` of benchmarks/bench_service.py, parsed."""
    [grid] = [{kw.arg: ast.literal_eval(kw.value) for kw in node.value.keywords}
              for node in ast.parse((ROOT / "benchmarks" / "bench_service.py").read_text()).body
              if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
              and node.targets[0].id == "GRID"]
    assert SMOKE["SERVICE_GRID"] == grid
