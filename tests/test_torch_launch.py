"""The port's launch tooling against the reference's, on the CPU.

* ``launch/shapes.py``: ``SHAPES``, ``LONG_OK``, ``applicable`` and
  ``cells`` equal the reference's for every arch.
* ``launch/roofline.py``: every case of ``tests/test_roofline.py`` runs
  against the port's copy (the file's own source, its imports pointed at
  the port), the HLO text parser included; the H100 terms of a record
  computed by hand.
* ``launch/steps.py``: every input leaf of every (arch x shape) cell of
  all ten archs at full config size on a ``(2, 4)`` ``("data", "model")``
  mesh, and of the nine cells of ``tests/progs/dryrun_smoke_prog.py`` on
  both production meshes, ``(16, 16)`` and ``(2, 16, 16)``: its global
  shape, dtype and spec equal the reference's ``ShapeDtypeStruct`` and
  ``PartitionSpec`` after the port's name mapping
  (``models.convert.leaf_of``: a layer-stacked reference leaf is one port
  leaf per layer, with the reference's spec and shape less the leading
  layer dim), and the bytes a member holds of it (from its spec) equal the
  reference's ``NamedSharding.shard_shape`` bytes; the skipped cells and
  their reasons are the reference's.  The reference's ``build_cell`` is
  ``eval_shape`` only: it runs in two subprocesses, on 8 and on 512
  spoofed XLA host devices (``XLA_FLAGS`` is set before JAX loads).  One
  leaf differs by design: rwkv6's cache ``shift``, which the port keeps
  whole on every model member (``models/rwkv6.py:cache_spec``), where the
  reference splits d over the model axis.  And where the reference's
  ZeRO-1 splits a stacked leaf's moments on the layer dim (a per-layer
  vector whose own dims are split or too small), the port's moments keep
  the parameter's layout: its layers are tensors of their own.
* ``launch/hillclimb.py``: every variant's name, config transform (each
  field it changes, on every arch's config) and build options equal the
  reference's.
* ``launch/mesh.py:make_production_mesh``: the reference's axes and shape,
  nothing allocated.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import shapes as jshapes
from repro_torch import configs as tconfigs
from repro_torch.core.mesh import Mesh
from repro_torch.launch import hillclimb, roofline
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell, local_shape
from repro_torch.models.convert import leaf_of

ROOT = Path(__file__).resolve().parent.parent
SMOKE_CASES = [("qwen1_5_0_5b", "train_4k"), ("qwen1_5_0_5b", "decode_32k"),
               ("phi3_5_moe", "train_4k"), ("gemma3_12b", "prefill_32k"),
               ("gemma3_12b", "long_500k"), ("rwkv6_3b", "long_500k"),
               ("recurrentgemma_2b", "decode_32k"), ("whisper_base", "train_4k"),
               ("whisper_base", "decode_32k")]
ALL_CELLS = [(a, s) for a in tconfigs.ARCH_IDS for s in tshapes.SHAPES]
SMALL = ((2, 4), ("data", "model"))
PRODUCTION = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))
# (family, input path) -> why the port's spec differs from the reference's
DEVIATIONS = {("rwkv6", (1, ("shift",))): "the port keeps the token shift whole on every member"}

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import dataclasses
import jax, numpy as np
from jax.sharding import NamedSharding
from repro import configs
from repro.launch.shapes import applicable
from repro.launch.steps import build_cell
jobs = json.loads(sys.argv[2])
out = {}

def key(k):
    for a in ("key", "idx", "name"):
        if hasattr(k, a):
            return getattr(k, a)
    raise TypeError(k)

for mshape, names, cells in jobs:
    mesh = jax.make_mesh(tuple(mshape), tuple(names),
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    mname = "x".join(map(str, mshape))
    for arch, shape in cells:
        cfg = configs.get_config(arch)
        ok, why = applicable(cfg, shape)
        if not ok:
            out[f"{mname}/{arch}/{shape}"] = {"skipped": why}
            continue
        b = build_cell(cfg, shape, mesh)
        leaves = []
        for i, (sds, sh) in enumerate(zip(b["specs"], b["in_shardings"])):
            flat = jax.tree_util.tree_flatten_with_path(sds)[0]
            shs = jax.tree.leaves(sh, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert len(flat) == len(shs), (arch, shape, i)
            for (path, s), h in zip(flat, shs):
                spec = [list(e) if isinstance(e, tuple) else e for e in tuple(h.spec)]
                nbytes = int(np.prod(h.shard_shape(s.shape))) * s.dtype.itemsize
                leaves.append([i, [key(k) for k in path], list(s.shape), s.dtype.name, spec,
                               nbytes])
        out[f"{mname}/{arch}/{shape}"] = {"leaves": leaves, "kind": b["kind"]}
if sys.argv[4] == "hillclimb":
    from repro.launch.hillclimb import VARIANTS
    hc = {}
    for name, (transform, opts) in VARIANTS.items():
        changed = {}
        for arch in configs.ARCH_IDS:
            base = configs.get_config(arch)
            new = transform(base)
            changed[arch] = {f.name: getattr(new, f.name) for f in dataclasses.fields(base)
                             if getattr(new, f.name) != getattr(base, f.name)}
        hc[name] = {"changed": changed, "opts": opts}
    out["hillclimb"] = hc
json.dump(out, open(sys.argv[3], "w"))
print("REFERENCE OK")
"""


def _run_reference(tmp, devices: int, jobs, extra: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = tmp / f"specs{devices}.json"
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(devices), json.dumps(jobs),
                           str(out), extra], capture_output=True, text=True, timeout=600,
                          env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    out = _run_reference(tmp, 8, [[list(SMALL[0]), list(SMALL[1]), ALL_CELLS]], "hillclimb")
    out.update(_run_reference(tmp, 512, [[list(s), list(n), SMOKE_CASES]
                                         for s, n in PRODUCTION], ""))
    return out


# -- shapes ---------------------------------------------------------------------


def test_shapes_equal_the_reference():
    assert tshapes.LONG_OK == jshapes.LONG_OK
    assert {k: tuple(vars(v).values()) for k, v in tshapes.SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in jshapes.SHAPES.items()}
    from repro import configs as jconfigs

    for arch in tconfigs.ARCH_IDS:
        cfg, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert tshapes.cells(cfg) == jshapes.cells(jc), arch
        for shape in tshapes.SHAPES:
            assert tshapes.applicable(cfg, shape) == jshapes.applicable(jc, shape)


# -- roofline -------------------------------------------------------------------


def _roofline_cases() -> dict:
    """``tests/test_roofline.py``'s test functions, run against the port."""
    src = (ROOT / "tests" / "test_roofline.py").read_text()
    src = src.replace("from repro.launch.roofline", "from repro_torch.launch.roofline")
    src = src.replace("from repro.configs", "from repro_torch.configs")
    assert "repro." not in src.replace("repro_torch.", "")
    ns = {}
    exec(compile(src, "test_roofline.py (port)", "exec"), ns)
    return {k: v for k, v in ns.items() if k.startswith("test_")}


@pytest.mark.parametrize("case", sorted(_roofline_cases()))
def test_reference_roofline_cases_hold_against_the_port(case):
    _roofline_cases()[case]()


def test_h100_roofline_terms():
    r = roofline.Roofline(arch="a", shape="s", mesh="2x4", chips=8,
                          hlo_flops=989e12 * 8 * 0.5,      # 0.5 s of compute
                          hlo_bytes=3.35e12 * 8 * 2.0,     # 2 s of memory
                          coll_bytes=450e9 * 8 * 1.0,      # 1 s of collectives
                          coll_breakdown={"all-reduce": 450e9 * 8}, model_flops=989e12 * 2,
                          bytes_per_device=1.0, hardware=roofline.H100)
    assert r.t_compute == pytest.approx(0.5) and r.t_memory == pytest.approx(2.0)
    assert r.t_collective == pytest.approx(1.0) and r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(0.25)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.to_dict()["hardware"] == "h100-sxm"
    cfg = tconfigs.get_config("yi_6b")
    t = roofline.from_trace("yi_6b", "train_4k", "2x4", 8, flops=1.0, bytes_accessed=2.0,
                            coll={"all-gather": 3.0}, bytes_per_device=4.0, cfg=cfg,
                            cell_kind="train", seq_len=4096, global_batch=256)
    assert t.hardware is roofline.H100 and t.coll_bytes == 3.0
    assert t.model_flops == roofline.model_flops_estimate(cfg, "train", 4096, 256)


# -- steps: the inputs of every cell --------------------------------------------


def _ref_path(key: str, cfg) -> tuple[tuple, bool]:
    """The reference's pytree path of a port parameter's reference leaf, and
    whether the reference stacks it on a leading layer dim."""
    parts = key.split(".")
    stacked = "*" in parts
    parts = [p for p in parts if p != "*"]
    if parts[0] == "blocks":
        parts[0] = "layers"
    if parts[0] == "norms":
        parts = parts[1:]
    if cfg.family == "rglru_hybrid" and parts[0] == "layers":
        parts[1] = int(parts[1])
        if parts[2] == "mixer":
            parts[2] = cfg._block_kind(parts[1])
    return tuple(parts), stacked


def _entries(spec, rank: int) -> tuple:
    """A spec as a tuple of ``rank`` entries: None, an axis, or a tuple of
    axes (one axis written as itself)."""
    out = []
    for e in tuple(spec):
        e = tuple(e) if isinstance(e, (list, tuple)) else e
        out.append(e[0] if isinstance(e, tuple) and len(e) == 1 else e)
    return tuple(out) + (None,) * (rank - len(out))


def _walk(tree, path=()):
    """(path, leaf) of the port's input trees: dict keys, list indices and
    NamedTuple fields."""
    from repro_torch.launch.steps import InputSpec

    if isinstance(tree, InputSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    elif tree is not None:
        for k, v in zip(tree._fields, tree):
            yield from _walk(v, path + (k,))


def _port_leaves(cfg, specs, kind: str, mesh) -> dict:
    """(argument, reference path) -> (shape, dtype, spec, member bytes,
    stacked): the port's per-layer parameter leaves (and their moments)
    folded into the reference's stacked ones."""
    out = {}
    for arg, tree in enumerate(specs):
        for path, leaf in _walk(tree):
            nbytes = int(torch.Size(local_shape(leaf, mesh)).numel()) * leaf.dtype.itemsize
            shape, spec = tuple(leaf.shape), _entries(leaf.spec, len(leaf.shape))
            stacked = False
            if arg == 0 or (kind == "train" and arg == 1 and path[0] in ("m", "v")):
                ref, stacked = _ref_path(leaf_of(path[-1], cfg)[0], cfg)
                path = path[:-1] + ref
            key = (arg, path)
            if key in out:  # another layer of a stacked leaf
                layers, shape, dtype, spec, total = out[key]
                out[key] = (layers + 1, shape, dtype, spec, total + nbytes)
            else:
                out[key] = (1 if stacked else 0, shape, str(leaf.dtype).split(".")[-1], spec,
                            nbytes)
    return {k: (((n,) + shape, dtype, (None,) + spec, b, True) if n
                else (shape, dtype, spec, b, False))
            for k, (n, shape, dtype, spec, b) in out.items()}


def _check_cell(cfg, cell_ref, mesh):
    built = build_cell(cfg, cell_ref["shape"], mesh)
    assert built["kind"] == cell_ref["kind"]
    port = _port_leaves(cfg, built["specs"], built["kind"], mesh)
    ref = {(i, tuple(p)): (tuple(s), d, _entries(sp, len(s)), b)
           for i, p, s, d, sp, b in cell_ref["leaves"]}
    assert set(port) == set(ref), set(port) ^ set(ref)
    for key, (shape, dtype, spec, nbytes, stacked) in port.items():
        want = ref[key]
        assert (shape, dtype) == want[:2], (key, shape, dtype, want)
        if (cfg.family, key) in DEVIATIONS:
            continue
        if stacked and want[2][0] is not None:
            # ZeRO-1 on the layer dim of a stacked leaf (a per-layer vector
            # whose own dims are split or too small): the port's layers are
            # tensors of their own, so their moments keep the parameter's
            # layout, copied over the batch axes
            axes = want[2][0] if isinstance(want[2][0], tuple) else (want[2][0],)
            assert spec == (None,) + want[2][1:], (key, spec, want[2])
            assert nbytes == want[3] * math.prod(mesh.size(a) for a in axes), key
            continue
        assert spec == want[2], (key, spec, want[2])
        assert nbytes == want[3], (key, nbytes, want[3])


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_every_cell_on_2x4_has_the_reference_inputs(reference, arch):
    mesh = Mesh(*SMALL, device="meta")
    cfg = tconfigs.get_config(arch)
    for shape in tshapes.SHAPES:
        cell = reference[f"2x4/{arch}/{shape}"]
        if "skipped" in cell:
            ok, why = tshapes.applicable(cfg, shape)
            assert not ok and why == cell["skipped"]
            with pytest.raises(ValueError, match="skipped"):
                build_cell(cfg, shape, mesh)
            continue
        _check_cell(cfg, dict(cell, shape=shape), mesh)


@pytest.mark.parametrize("mesh_shape,names", PRODUCTION, ids=["16x16", "2x16x16"])
def test_smoke_cells_on_the_production_meshes_have_the_reference_inputs(
        reference, mesh_shape, names):
    mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3, device="meta")
    assert (mesh.shape, mesh.axis_names) == (mesh_shape, names)
    mname = "x".join(map(str, mesh_shape))
    for arch, shape in SMOKE_CASES:
        _check_cell(tconfigs.get_config(arch), dict(reference[f"{mname}/{arch}/{shape}"],
                                                    shape=shape), mesh)


def test_production_mesh_allocates_nothing():
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        mesh = make_production_mesh(multi_pod=multi, device="meta")
        assert mesh.shape == shape and mesh.device.type == "meta"
    if not torch.cuda.is_available():  # None means the card
        with pytest.raises(RuntimeError):
            make_production_mesh()


# -- hillclimb ------------------------------------------------------------------


def test_hillclimb_variants_equal_the_reference(reference):
    ref = reference["hillclimb"]
    assert list(hillclimb.VARIANTS) == list(ref)
    for name, (transform, opts) in hillclimb.VARIANTS.items():
        assert opts == ref[name]["opts"], name
        for arch in tconfigs.ARCH_IDS:
            base = tconfigs.get_config(arch)
            new = transform(base)
            changed = {f: getattr(new, f) for f in base.__dataclass_fields__
                       if getattr(new, f) != getattr(base, f)}
            assert changed == ref[name]["changed"][arch], (name, arch)


def test_hillclimb_marks_the_variants_that_change_nothing_in_the_port():
    marked = {v for v in hillclimb.VARIANTS if hillclimb.no_effect("phi3_5_moe", v)}
    assert marked == {"attn_chunk_512", "attn_chunk_1024"}
