"""The port's card-touching examples, run on the host with ``--device cpu``.

``quickstart``, the runtime half of ``fault_tolerance`` and the stacked-mesh
half of ``distributed_gemm`` run once each, in this process, on the
kernels' plain versions:

* quickstart: the loss falls more than a nat below the uniform entropy
  ln(128) = 4.852 (the reference, from its own initial weights, reaches
  3.370), and the 12 generated tokens lie in the vocabulary;
* fault_tolerance: checkpoints at steps [5, 10, 12], a resume at step 13
  that runs to 20, and a recovery from step 15 past the corrupt step 20,
  the reference's steps;
* distributed_gemm: every max_err within 2e-4 (the summa / fcl / overlap
  tolerance of the port's tests) of ``torch.matmul`` in f32.

Without a card, each refuses to start unless ``--device cpu`` is given:
it exits non-zero and prints nothing on its standard output.
"""

from __future__ import annotations

import contextlib
import io
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
CPU = ["--device", "cpu"]
MAIN_TOL = 2e-4


@contextlib.contextmanager
def one_thread():
    """Tiny models, thousands of small ops: one torch thread each.  Under
    ``-n 6`` on a loaded host every small op's parallel region would wait
    on threads that the other workers hold (quickstart took 268 s so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def quickstart():
    from repro_torch.examples import quickstart

    buf = io.StringIO()
    with one_thread(), contextlib.redirect_stdout(buf):
        out = quickstart.main(CPU)
    return out, buf.getvalue().splitlines()


def test_quickstart_loss_falls_a_nat_below_the_uniform_entropy(quickstart):
    out, lines = quickstart
    losses = out["losses"]
    assert len(losses) == 80 and all(math.isfinite(x) for x in losses)
    assert losses[-1] < math.log(128) - 1.0, losses[-1]
    assert lines[0] == f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (uniform entropy would be " \
                       f"{math.log(128):.3f})"


def test_quickstart_generates_twelve_tokens_in_the_vocabulary(quickstart):
    out, lines = quickstart
    tokens = out["tokens"]
    assert len(tokens) == 12 and all(0 <= t < 128 for t in tokens), tokens
    assert lines[1] == f"generated continuation: {tokens}"


@pytest.fixture(scope="module")
def fault_tolerance():
    from repro_torch.examples import fault_tolerance

    with one_thread():
        return fault_tolerance.runtime_demo(torch.device("cpu"))


@pytest.mark.parametrize("key,want", [("checkpoints", [5, 10, 12]), ("resumed_at", 13),
                                      ("ran_to", 20), ("recovered_from", 15)])
def test_fault_tolerance_runtime_steps_are_the_references(fault_tolerance, key, want):
    assert fault_tolerance[key] == want


@pytest.fixture(scope="module")
def gemm_errors():
    from repro_torch.examples import distributed_gemm

    with one_thread():
        out = distributed_gemm.mesh_demo(torch.device("cpu"))
    errs = {f"summa {s}": r["max_err"] for s, r in out["summa"].items()}
    errs.update({f"fcl {s}": e for s, e in out["fcl"].items()})
    errs.update(ag_matmul=out["ag_matmul"], matmul_rs=out["matmul_rs"])
    return errs


GEMM_CASES = [f"summa {s}" for s in ("native", "chain", "pipelined", "tree", "ring")] \
    + [f"fcl {s}" for s in ("native", "chain", "tree")] + ["ag_matmul", "matmul_rs"]


@pytest.mark.parametrize("case", GEMM_CASES)
def test_distributed_gemm_max_err_within_the_main_path_tolerance(gemm_errors, case):
    assert set(gemm_errors) == set(GEMM_CASES)
    assert 0.0 <= gemm_errors[case] <= MAIN_TOL, gemm_errors


@pytest.mark.parametrize("name", ["quickstart", "fault_tolerance", "distributed_gemm"])
def test_card_example_refuses_to_start_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the example runs on it")
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode != 0
    assert proc.stdout == "", proc.stdout
    assert "--device cpu" in proc.stderr, proc.stderr
