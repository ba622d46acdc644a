"""The port stands alone: no JAX, nothing of ``repro``, and no silent CPU path.

The port and ``chip_smoke.py`` run on a machine that has no JAX, so they
must import neither ``jax`` nor anything of the reference package ``repro``
(not even its framework-free modules: the port keeps its own copies).
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           timeout=300, env=env, cwd=cwd)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _modules()
    assert {"repro_torch.core.mesh", "repro_torch.kernels._build",
            "repro_torch.core.noc.model", "repro_torch.models.transformer",
            "repro_torch.models.rglru", "repro_torch.models.rwkv6",
            "repro_torch.models.whisper", "repro_torch.models.mlp",
            "repro_torch.configs.moonshot_v1_16b", "repro_torch.configs.whisper_base",
            "repro_torch.kernels.rglru", "repro_torch.kernels.rwkv6",
            "repro_torch.runtime.server", "repro_torch.runtime.trainer",
            "repro_torch.optim.adamw", "repro_torch.optim.compress",
            "repro_torch.optim.schedule", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.manager", "repro_torch.launch.train",
            "repro_torch.core.topology", "repro_torch.core.noc.netsim",
            "repro_torch.core.noc.program", "repro_torch.core.noc.calibrate",
            "repro_torch.core.noc.shard", "repro_torch.core.noc.resilience.checkpoint",
            "repro_torch.core.noc.telemetry.collector",
            "repro_torch.core.noc.service.server", "repro_torch.launch.mesh",
            "repro_torch.launch.steps", "repro_torch.models.parallel",
            "repro_torch.models.convert", "repro_torch.launch.shapes",
            "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
            "repro_torch.launch.hillclimb"} <= set(mods)
    proc = _run(
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_no_source_names_jax_or_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_shard_engine_and_store_schema_are_ported():
    """The two calls that raised ``NotImplementedError`` while the shard
    engine and the service were unported answer as the reference does: the
    shard engine runs (and falls back to no other engine: its profile names
    it), and the result-store schema names the point-key scheme of
    ``service.jobs``."""
    from repro_torch.core.noc import fingerprint
    from repro_torch.core.noc.netsim import NoCSim
    from repro_torch.core.topology import Coord, Mesh2D

    def run(engine):
        sim = NoCSim(Mesh2D(2, 2))
        sim.add_unicast(Coord(0, 0), Coord(1, 1), 64)
        return sim.run(engine=engine, profile=True)

    heap = run("heap").makespan
    for engine in ("shard", "shard:2x2:1"):
        prof = run(engine)
        assert (prof.engine, prof.makespan) == (engine, heap)
    doc = fingerprint.store_schema_doc()
    assert doc["point_key"] == "workload_fingerprint:json_token/v1"
    assert set(fingerprint.store_schema_parts()) == set(doc)


def test_noc_substrate_imports_no_torch():
    """The shard engine's and the service's fork workers must hold no CUDA
    state: nothing under ``core/noc`` imports torch."""
    proc = _run(
        "import importlib, pkgutil, sys\n"
        "import repro_torch.core.noc as noc\n"
        "for i in pkgutil.walk_packages(noc.__path__, 'repro_torch.core.noc.'):\n"
        "    importlib.import_module(i.name)\n"
        "print('TORCH', 'torch' in sys.modules)\n")
    assert proc.returncode == 0, proc.stderr
    assert "TORCH False" in proc.stdout, proc.stdout


def test_kernel_sources_are_in_the_package():
    sources = sorted(p.name for p in (PORT / "kernels" / "csrc").glob("*.cu*"))
    assert sources == ["flash_attention.cu", "flash_attention_wgmma.cu", "gemm.cu",
                       "gemm_wgmma.cu", "hopper.cuh", "reduce_nway.cu", "rglru_scan.cu",
                       "wkv.cu"]


def test_mesh_without_a_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: Mesh() takes it")
    from repro_torch.core.mesh import Mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Mesh((2, 2), ("row", "col"))
    assert Mesh((2, 2), ("row", "col"), device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: chip_smoke.py runs")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
