"""A cell found by name, and the result line built from a run.

Everything that belongs to one cell is data found by name: the cell in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<traffic>.json``); the traffic names the driver
that runs it (``drivers/<driver>.py``); each metric is a reader of its own
(``metrics/<metric>.py``, a ``read(run)`` that gives a number or None).
A later cell or metric is added as files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
# Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench: Path = BENCH  # the folder the cell's files were found in


@dataclasses.dataclass
class Run:
    """What a driver's run gives the result line and the metrics' readers.

    ``units`` are the calls or steps completed in the window of
    ``window_s`` seconds; ``shapes`` holds the sizes that the readers count
    work from; ``checks`` maps each compared number to (value, limit), a
    value passing when it is at most its limit."""

    setup_s: float
    window_s: float
    units: int
    attempted: int
    end_to_end: dict
    checks: dict
    shapes: dict
    device_kind: str
    memory_peak_bytes: int
    trace: object = None

    @property
    def failed(self) -> int:
        return sum(1 for v, lim in self.checks.values() if not v <= lim)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / spec["paths"][0]
    return Cell(name=name, chips=w["chips"],
                config=read_json(root / configs[w["config"]]["file"]),
                traffic=read_json(bench / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if applies(m, name)],
                bench=bench)


def load_module(path: Path, tag: str):
    """A module from a file whose name need not be an identifier."""
    mod_name = "portbench_" + tag + "_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_of(cell: Cell):
    return load_module(cell.bench / "drivers" / f"{cell.traffic['driver']}.py", "driver")


def metric_reader(name: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{name}.py", "metric").read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, run, trace: bool) -> dict:
    """The line that a run prints last.  ``run`` is a driver's ``Run``."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.bench)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def check_lines(run) -> list:
    """Each compared number beside its limit, for the end of standard error."""
    return [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in run.checks.items()]
