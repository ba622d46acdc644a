"""The port's copies of the framework-free NoC modules are the reference's.

The machine with the card has no JAX, so ``repro_torch`` keeps its own
copy of ``core/topology.py`` and ``core/noc/`` (and of the fabric-program
emitters of ``core/schedules.py``, ``core/summa.py`` and
``core/overlap.py``) instead of importing ``repro``.  A copy differs from
the reference only by ``repro_torch.`` in place of ``repro.`` and by the
deviations listed here: the two holes that raise ``NotImplementedError``
until the shard engine and the service are ported, and the package
docstring's note that says so.  ``chip_smoke.py``'s golden fingerprints
are those of ``tests/test_program.py``.
"""

import ast
import re
from pathlib import Path

import pytest

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
    "core/noc/routing/__init__.py",
    "core/noc/routing/policies.py",
    "core/noc/routing/trees.py",
    "core/noc/routing/turns.py",
    "core/noc/traffic/__init__.py",
    "core/noc/traffic/patterns.py",
    "core/noc/traffic/sweep.py",
    "core/noc/traffic/trace.py",
)

# (port text after the rename back, reference text) for each deviation.
DEVIATIONS = {
    "core/noc/__init__.py": [(
        '''"""Cycle-level substrate reproducing the paper's own evaluation.

The copy of ``repro.core.noc`` in this package lacks ``shard``,
``resilience``, ``telemetry`` and ``service``, which are not ported yet
(ROADMAP.md, queue 1 item 2): ``NoCSim.run(engine='shard')`` and
``fingerprint.store_schema_doc`` raise ``NotImplementedError``.
''',
        '''"""Cycle-level substrate reproducing the paper's own evaluation.
''')],
    "core/noc/netsim.py": [(
        '''            raise NotImplementedError(
                "engine='shard' is not ported yet (ROADMAP.md, queue 1 item 2: "
                "the next NoC slice)")
''',
        '''            from repro.core.noc.shard import parse_shard_engine, run_shard

            cfg = parse_shard_engine(engine)
            makespan = run_shard(self, max_cycles, cfg, prof,
                                 stop_at=stop_at, start=start_cycle)
''')],
    "core/noc/fingerprint.py": [(
        '''    raise NotImplementedError(
        "store_schema_doc needs service.jobs, which is not ported yet "
        "(ROADMAP.md, queue 1 item 2: the next NoC slice)")
''',
        '''    from repro.core.noc.service.jobs import POINT_KEY_SCHEME
''')],
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
    for port_text, ref_text in DEVIATIONS.get(rel, ()):
        assert port.count(port_text) == 1, f"{rel}: deviation not found once"
        port = port.replace(port_text, ref_text)
    assert port == (REF / rel).read_text()


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


def _golden_tables(path: Path) -> dict:
    tables = {}
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id.startswith("GOLDEN_")):
            tables[node.targets[0].id] = ast.literal_eval(node.value)
    return tables


@pytest.mark.parametrize("table", ("GOLDEN_EMITTERS", "GOLDEN_TRACES", "GOLDEN_REPLAYS"))
def test_chip_smoke_goldens_are_test_program_goldens(table):
    smoke = _golden_tables(ROOT / "chip_smoke.py")
    ref = _golden_tables(ROOT / "tests" / "test_program.py")
    assert smoke[table] == ref[table]
    assert len(ref[table]) in (4, 8, 9)
