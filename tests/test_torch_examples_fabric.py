"""The port's host-side examples print the reference's lines.

Each reference script (``examples/*.py``, JAX on the CPU) and its port
(``src/repro_torch/examples/``) runs once, in a subprocess of its own,
all of them at the same time; their standard outputs are compared line by
line:

* ``collective_schedules`` and ``telemetry``: the whole output, but for
  the temporary path of telemetry's Perfetto file;
* ``service``: every line, with what differs between two runs of the
  reference masked (socket paths, the TCP port, seconds and milliseconds,
  the order in which the two concurrent clients finish, how the served
  points split between memo hits and in-flight joins, and how the
  workers' compile-cache lookups split between hits and misses: their
  sums stay);
* ``fault_tolerance``'s fabric and simulator halves, and
  ``distributed_gemm``'s NoC cost path: every line (cycles, byte counts,
  sha256 prefixes).

The port's card-touching halves are in ``test_torch_examples_models.py``.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
TIMEOUT_S = 240

# (name, reference command, port command); the fabric halves of the two
# card-touching examples are their own functions, called on both sides.
_REF_PARTS = ("import runpy, sys\n"
              "ns = runpy.run_path(sys.argv[1], run_name='reference_example')\n"
              "for name in sys.argv[2:]:\n"
              "    ns[name]()\n")
_PORT_PARTS = ("import importlib, sys\n"
               "mod = importlib.import_module(sys.argv[1])\n"
               "for name in sys.argv[2:]:\n"
               "    getattr(mod, name)()\n")
RUNS = {
    **{name: ([str(ROOT / "examples" / f"{name}.py")], ["-m", f"repro_torch.examples.{name}"])
       for name in ("collective_schedules", "telemetry", "service")},
    "fault_tolerance": (["-c", _REF_PARTS, str(ROOT / "examples" / "fault_tolerance.py"),
                         "fabric_demo", "resilience_demo"],
                        ["-c", _PORT_PARTS, "repro_torch.examples.fault_tolerance",
                         "fabric_demo", "resilience_demo"]),
    "distributed_gemm": (["-c", _REF_PARTS, str(ROOT / "examples" / "distributed_gemm.py"),
                          "noc_cost_path"],
                         ["-c", _PORT_PARTS, "repro_torch.examples.distributed_gemm",
                          "noc_cost_path"]),
}


@pytest.fixture(scope="module")
def outputs():
    """{name: (reference stdout, port stdout)}, every run started at once."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    procs = {}
    for name, (ref, port) in RUNS.items():
        procs[name] = tuple(
            subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            for args in (ref, port))
    out = {}
    try:
        for name, pair in procs.items():
            got = []
            for side, proc in zip(("reference", "port"), pair):
                stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
                assert proc.returncode == 0, f"{side} {name}: rc {proc.returncode}\n{stderr}"
                got.append(stdout.splitlines())
            out[name] = tuple(got)
    finally:
        for pair in procs.values():
            for proc in pair:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return out


def _mask_telemetry(lines):
    return [re.sub(r"-> \S+storm16\.json$", "-> <file>", ln) for ln in lines]


def _mask_service(lines):
    """The reference's lines with what varies between its runs masked; the
    two concurrent clients' lines sorted."""
    subs = [
        (r"(service listening on ).*", r"\1<socket>"),
        (r"(listening on )\S+:\d+ \(and .*\)", r"\1<host>:<port> (and <socket>)"),
        (r" in \d+\.\d+s ", " in <s> "),
        (r"\(\d+ ms in\)", "(<ms> in)"),
        (r"rows in \d+\.\d+ ms", "rows in <ms> ms"),
    ]
    out = []
    for ln in lines:
        for pat, rep in subs:
            ln = re.sub(pat, rep, ln)
        m = re.match(r"(  accounting: \d+ points requested = \d+ computed \+ )(\d+) memo hits "
                     r"\+ (\d+) in-flight joins( .*)", ln)
        if m:
            ln = f"{m[1]}<{int(m[2]) + int(m[3])} memo hits and in-flight joins>{m[4]}"
        m = re.match(r"(  compile cache: )(\{.*\})(, .*)", ln)
        if m:
            cache = ast.literal_eval(m[2])
            ln = (f"{m[1]}<{cache['hits'] + cache['misses']} lookups>, evictions "
                  f"{cache['evictions']}{m[3]}")
        out.append(ln)
    clients = sorted(ln for ln in out if re.match(r"  (alice|bob): ", ln))
    it = iter(clients)
    return [next(it) if re.match(r"  (alice|bob): ", ln) else ln for ln in out]


MASKS = {"telemetry": _mask_telemetry, "service": _mask_service}


@pytest.mark.parametrize("name", list(RUNS))
def test_port_example_prints_the_references_lines(outputs, name):
    ref, port = outputs[name]
    mask = MASKS.get(name, list)
    ref, port = mask(ref), mask(port)
    assert len(port) == len(ref), (ref, port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"{name} line {i}: reference {a!r}, port {b!r}"


def test_service_masks_leave_the_pinned_rows(outputs):
    """The masks hide no row: the bit-identity line, the six streamed
    latencies and the restart's row counts are compared as printed."""
    port = _mask_service(outputs["service"][1])
    assert "  bit-identical to saturation_sweep: OK" in port
    lat = [re.search(r"mean latency (\d+\.\d) cycles", ln)[1] for ln in port
           if ln.startswith("  streamed row")]
    assert lat == ["74.2", "76.8", "80.7", "85.8", "88.9", "91.5"]
    assert "  server killed mid-grid (exit -9); rows on disk: 3" in port
    assert "  resumed and completed: 6 rows, 3 served from the store, 3 computed after " \
           "restart" in port
    assert "  authenticated TCP client: 2 rows" in port


# The numbers the reference prints (``examples/*.py`` run on the CPU), each
# found in the port's output.
PINNED = [
    ("distributed_gemm", "per-op gated (comm/compute overlap): 2183 cycles"),
    ("distributed_gemm", "barrier-serialized baseline:         2446 cycles  (1.12x slower)"),
    ("distributed_gemm", "comm-only 361 / compute-only 2091 cycles"),
    ("fault_tolerance", "storm completes degraded: makespan 91 -> 158 (1.74x)"),
    ("fault_tolerance", "surviving 4x8 submesh at (0,0)"),
    ("fault_tolerance", "24-unicast workload, makespan 200"),
    ("fault_tolerance", "checkpoint at cycle 100 (28754 bytes, sha256 cc913ce65598…), restored "
                        "run finishes at 200"),
    ("fault_tolerance", "makespan 200 -> 207"),
    ("fault_tolerance", "respawned 1x, replayed its epoch log, makespan 200"),
    ("telemetry", "makespan 561, 30720 busy beats"),
    ("telemetry", "makespan 561 -> 629, peak link utilization 0.114 -> 0.203"),
    ("collective_schedules", "     1Ki      302      302      216       71     3.04       tree"),
    ("collective_schedules", "simulator: 570 cycles; model: 570 cycles"),
    ("collective_schedules", "10 ops, makespan 808 cycles"),
]


@pytest.mark.parametrize("name,text", PINNED, ids=[f"{n}-{i}" for i, (n, _) in enumerate(PINNED)])
def test_port_example_prints_the_pinned_numbers(outputs, name, text):
    assert any(text in ln for ln in outputs[name][1]), (text, outputs[name][1])


def test_host_examples_load_no_torch():
    """``telemetry`` and ``service`` are core-only, as in the reference:
    neither they nor what their ``main`` imports load torch."""
    code = ("import sys\n"
            "import repro_torch.examples.service, repro_torch.examples.telemetry\n"
            "import repro_torch.core.noc.service, repro_torch.core.noc.telemetry\n"
            "import repro_torch.core.noc.traffic.sweep, repro_torch.core.noc.faults\n"
            "print('TORCH', 'torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout, proc.stdout
