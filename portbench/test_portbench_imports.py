"""No run of the benchmark loads JAX or the JAX package, and the reference
loads nothing of the program, compared by whole top-level module names."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys
for name in {modules}:
    __import__(name)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def top_level(modules) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", PROBE.format(modules=list(modules))],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    """The harness, its drivers' program modules and the reference."""
    loaded = top_level(["portbench.run", "portbench.cell", "portbench.trace",
                        "portbench.flops", "portbench.inputs", "portbench.faults",
                        "portbench.controls", "portbench.reference.matmul",
                        "portbench.reference.llama", "portbench.drivers.collective_gemm",
                        "portbench.drivers.train", "repro_torch.core.summa",
                        "repro_torch.core.fcl",
                        "repro_torch.runtime.trainer", "repro_torch.launch.steps",
                        "repro_torch.models.transformer", "repro_torch.models.convert"])
    assert "portbench" in loaded and "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    loaded = top_level(["portbench.reference.matmul", "portbench.reference.llama",
                        "portbench.inputs", "portbench.flops"])
    assert "torch" in loaded
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_run_refuses_without_a_card():
    """Here there is no card: the run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "yi6b-summa-up",
                          "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "CUDA card" in out.stderr
