"""The port's dry run (``launch/dryrun.py``, ``launch/hillclimb.py``) on the
CPU, against the reference's ``run_cell``.

The nine cells of ``tests/progs/dryrun_smoke_prog.py``, at its widths
(``adapt``) and cut shapes (``shrink_shape``), on a ``(2, 4)`` ``("data",
"model")`` mesh:

* the reference's ``run_cell`` (lowered and compiled on 8 spoofed XLA
  host devices in one subprocess, through the prog's own ``CASES``,
  ``adapt`` and ``mesh``; JAX starts with 8 devices before the prog's
  import asks for 512) gives each cell's ``hlo_flops``;
* the port's ``run_cell`` on the plain path (``device="cpu"``:
  ``FakeTensorMode``) traces every cell with status ``ok``, FLOPs and
  bytes above zero (the prog's gates), and FLOPs within 15 % of the
  reference's, but for two cells held at their measured ratio +- 5 %
  (``MEASURED``): ``gemma3_12b long_500k`` (0.565: the reference
  all-gathers the sequence-split cache, 6.3 MB of collectives, and every
  device attends over the whole of it, where each port member attends
  over its own block) and ``rwkv6_3b long_500k`` (1.719: the port runs
  rwkv6's time mix whole on every model member, ``models/rwkv6.py``,
  where GSPMD splits its products);
* the port's ``run_cell`` on the card's path (``device="cuda"``: meta
  tensors, every kernel through its op) traces every cell, and the
  kernel launches it predicts equal the calls that a real run of the same
  step on the CPU makes to the kernels' wrappers (the plain versions run
  there; each call is a launch on the card).

Then: ``run_cell``'s record layout and the resumable CLI, the five
hill-climb variants that set ``attn_bf16_logits`` and one ``run_cell``
of a variant end to end.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch import configs as tconfigs
from repro_torch.core.mesh import Mesh
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import reduce_nway as krn
from repro_torch.kernels import rglru as krg
from repro_torch.kernels import rwkv6 as krw
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.steps import build_cell

ROOT = Path(__file__).resolve().parent.parent
CASES = [("qwen1_5_0_5b", "train_4k"), ("qwen1_5_0_5b", "decode_32k"),
         ("phi3_5_moe", "train_4k"), ("gemma3_12b", "prefill_32k"),
         ("gemma3_12b", "long_500k"), ("rwkv6_3b", "long_500k"),
         ("recurrentgemma_2b", "decode_32k"), ("whisper_base", "train_4k"),
         ("whisper_base", "decode_32k")]
SMALL = {"train_4k": tshapes.ShapeCell("train_4k", "train", 128, 8),
         "prefill_32k": tshapes.ShapeCell("prefill_32k", "prefill", 256, 8),
         "decode_32k": tshapes.ShapeCell("decode_32k", "decode", 256, 8),
         "long_500k": tshapes.ShapeCell("long_500k", "decode", 1024, 1)}
FLOPS_RTOL = 0.15
# cells whose port FLOPs differ from the reference's by design (docstring):
# their measured ratio, held within 5 %
MEASURED = {("gemma3_12b", "long_500k"): 0.565, ("rwkv6_3b", "long_500k"): 1.719}
BF16_VARIANTS = ("bf16_attn", "bf16_attn_loss256", "bf16_attn_noremat", "align_bf16",
                 "bf16_attn_sp_moe")

REFERENCE = r"""
import os, sys, json
# the prog's (2, 4) mesh needs 8 devices: start JAX with 8 before the prog's
# import of repro.launch.dryrun asks for 512
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.devices()
sys.path.insert(0, "tests/progs")
import dryrun_smoke_prog as prog
from repro.configs import get_config
prog.shrink_shape(None)
out = {}
for arch, shape in prog.CASES:
    rec = prog.run_cell(arch, shape, cfg_override=prog.adapt(get_config(arch)), mesh=prog.mesh,
                        mesh_name="2x4", verbose=False)
    out[f"{arch}/{shape}"] = {k: rec.get(k) for k in ("status", "hlo_flops", "hlo_bytes")}
json.dump(out, open(sys.argv[1], "w"))
print("REFERENCE OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(out)], capture_output=True,
                          text=True, timeout=900, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture
def small_shapes(monkeypatch):
    """The prog's cut shapes, for this module's tests only."""
    for name, cell in SMALL.items():
        monkeypatch.setitem(tshapes.SHAPES, name, cell)


def adapt(arch: str):
    """``dryrun_smoke_prog.adapt``: the smoke config at the prog's widths."""
    cfg = tconfigs.get_config(arch)
    return dataclasses.replace(
        tconfigs.get_smoke_config(cfg.name), name=cfg.name,
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        head_dim=16, d_ff=128, vocab=512, loss_chunk=64)


def _mesh(device="cpu"):
    return Mesh((2, 4), ("data", "model"), device=device)


def _run(arch, shape, device, **kw):
    return dryrun.run_cell(arch, shape, cfg_override=adapt(arch), mesh=_mesh(),
                           mesh_name="2x4", device=device, verbose=False, **kw)


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}:{s}" for a, s in CASES])
def test_plain_trace_flops_match_the_reference(reference, small_shapes, arch, shape):
    rec = _run(arch, shape, "cpu")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0 and rec["bytes_per_device"] > 0
    ref = reference[f"{arch}/{shape}"]
    assert ref["status"] == "ok"
    ratio = rec["hlo_flops"] / ref["hlo_flops"]
    want = MEASURED.get((arch, shape), 1.0)
    rtol = 0.05 if (arch, shape) in MEASURED else FLOPS_RTOL
    assert abs(ratio / want - 1.0) <= rtol, (ratio, want)


def _counting(monkeypatch):
    """Count the calls that reach each kernel's launch point (the plain
    version on the CPU; the kernel's op on the card)."""
    calls = {}

    def wrap(module, attr, name):
        real = getattr(module, attr)

        def counted(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kw)

        monkeypatch.setattr(module, attr, counted)

    wrap(kfa, "_forward", "flash_attention")
    wrap(krn, "_reduce", "reduce_nway")
    wrap(krg, "_scan", "rglru_scan")
    wrap(krw, "_wkv", "wkv")
    return calls


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}:{s}" for a, s in CASES])
def test_card_trace_predicts_the_launches_of_a_real_step(small_shapes, arch, shape, monkeypatch):
    rec = _run(arch, shape, "cuda")
    assert rec["status"] == "ok", rec.get("error")
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0 and rec["bytes_per_device"] > 0
    assert rec["method"] == "traced" and rec["hardware"] == "h100-sxm"
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    mesh = _mesh()
    built = build_cell(adapt(arch), shape, mesh)
    inputs = built["make_inputs"](seed=1)
    calls = _counting(monkeypatch)
    built["step_fn"](*inputs)
    assert rec["launches"] == calls, (rec["launches"], calls)
    assert rec["launches"].get("reduce_nway", 0) > 0  # every sharded step sums over an axis


def test_records_and_the_resumable_cli(tmp_path, capsys):
    out = tmp_path / "dry.json"
    args = ["--arch", "qwen1_5_0_5b", "--shape", "decode_32k", "--no-multipod", "--out", str(out)]
    dryrun.main(args)
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["device"] == "cuda" and rec["variant"] == "baseline"
    for key in ("hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown", "model_flops",
                "bytes_per_device", "t_compute", "t_memory", "t_collective", "bottleneck",
                "roofline_fraction", "launches", "trace_s"):
        assert key in rec, key
    dryrun.main(args)
    assert "cached, skip" in capsys.readouterr().out
    skipped = dryrun.run_cell("yi_6b", "long_500k", verbose=False)
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]


@pytest.mark.parametrize("variant", BF16_VARIANTS)
def test_bf16_logit_variants_trace(small_shapes, variant):
    rec = hillclimb.run_variant("phi3_5_moe", "train_4k", variant, cfg=adapt("phi3_5_moe"),
                                mesh=_mesh(), mesh_name="2x4", verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["variant"] == variant and not rec["no_effect"]
    assert "flash_attention" not in rec["launches"]  # bf16 logits take the plain path


def test_a_variant_end_to_end(small_shapes, tmp_path):
    base = _run("qwen1_5_0_5b", "train_4k", "cuda")
    rec = hillclimb.run_variant("qwen1_5_0_5b", "train_4k", "attn_chunk_512",
                                cfg=adapt("qwen1_5_0_5b"), mesh=_mesh(), mesh_name="2x4",
                                verbose=False)
    assert rec["no_effect"] and rec["hlo_flops"] == base["hlo_flops"]
    assert rec["hlo_bytes"] == base["hlo_bytes"]
    out = tmp_path / "hc.json"
    dryrun.append_result(base, out)
    dryrun.append_result(rec, out)
    assert [r["variant"] for r in json.loads(out.read_text())] == ["baseline", "attn_chunk_512"]


@pytest.mark.parametrize("BH", [6, 7], ids=["equal-slices", "ragged-last"])
def test_the_flash_backward_traced_once_counts_its_whole_loop(monkeypatch, BH):
    """The dry run traces the plain flash backward's first slice once for
    all the equal ones: FLOPs, bytes, launches and the live peak equal a
    trace of the whole loop (3 slices of 2 heads, and a ragged one)."""
    import contextlib

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    monkeypatch.setattr(kfa, "GRAD_SCORES", 2 * 16 * 16)

    def trace(once: bool):
        q, k, v = (torch.empty(BH, 16, 64, device="meta", requires_grad=True) for _ in range(3))
        flops = FlopCounterMode(display=False)
        tally = dryrun.Tally(flops)
        ctx = dryrun._flash_grad_traced_once(tally) if once else contextlib.nullcontext()
        with flops, tally, ctx:
            kfa.flash_attention(q, k, v, window=5).sum().backward()
        return flops.get_total_flops(), tally.bytes, tally.launches, tally.peak

    assert len(kfa.grad_parts(BH, 16)) == 3 + BH % 2
    assert trace(True) == trace(False)
    assert kfa.flash_attention_grad.__name__ == "flash_attention_grad"  # restored


def test_the_binding_sends_a_trace_through_the_kernels_ops():
    """``_build.traced``: a meta operand, ``FakeTensorMode`` and
    ``FlopCounterMode`` make a call a trace's (the op, its fake
    implementation and FLOP formula); no mode and no operand off the card
    make it a run's (the card test holds the plain CUDA case)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import _build

    assert _build.traced(torch.empty(2, device="meta"))
    assert not _build.traced()
    with FakeTensorMode():
        assert _build.traced()
    with FlopCounterMode(display=False):
        assert _build.traced()
