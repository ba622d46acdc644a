"""The port's cell steps (``launch/steps.py:build_cell``), the ZeRO-1 update,
``attn_bf16_logits`` and the sequence-split decode, against the reference.

The reference runs in one subprocess on 8 spoofed XLA host devices
(``XLA_FLAGS`` set before JAX loads, with a long collective rendezvous
deadline, as a loaded run needs), its steps built by its own
``build_cell`` and jitted with its ``in_shardings`` on a ``(2, 4)``
``("data", "model")`` mesh, the cells cut to smoke shapes (``SHAPES``
entries replaced on both sides).  Weights come from the port: its smoke
models from seed 0, handed to the reference by reference leaf (a
layer-stacked leaf stacked), and every other input from numpy.  The port
runs the same cells on the stacked mesh.  f32 smoke configs; tolerance
2e-4 (rtol, and atol 2e-4 of max(1, max|x|): ``_close``), bf16 logits 2e-2
of max|logits|, the reference's bf16 tolerance.

* train: one step of ``build_cell``'s train step (loss, ``grad_norm``, the
  new parameters, AdamW's moments) with ZeRO-1 on and off and with 2
  microbatches;
* prefill and decode (a random cache, position 20) for one arch of each
  family: logits and the caches;
* ``adamw_update(update_specs=)``: against the reference's, and against
  itself without ``update_specs`` within 1e-6;
* ``attn_bf16_logits``: a transformer's forward and whisper's loss,
  prefill and decode after it, unsharded and under ``make_policy``;
  ``_sdpa_block`` and ``_sdpa_flat`` alone against the reference's;
* the sequence-split decode: gemma3's smoke config, its cache laid out
  ``(None, None, "data", kv, hd)`` (``long_500k``, batch 1 whole): a
  prefill and four decode steps against the reference's jitted decode
  under that cache spec, on the stacked mesh, and on 8 gloo ranks
  (``core.mesh.RankMesh``) against the stacked mesh; rwkv6's and the
  hybrid's ``long_500k`` decode (batch 1, no batch axes on a mesh with a
  ``"data"`` axis) against their unsharded decode.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro_torch import configs as tconfigs
from repro_torch.core import mesh as M
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.steps import InputSpec, build_cell, make_policy, tree_map
from repro_torch.models import attention as tattn
from repro_torch.models import get_family
from repro_torch.models.attention import KVCache
from repro_torch.models.convert import (laid_out_specs, reference_leaves, shard_model,
                                        unshard_tensors)
from repro_torch.optim import AdamWConfig, adamw_update, opt_state_specs

ROOT = Path(__file__).resolve().parent.parent
SHAPE, NAMES = (2, 4), ("data", "model")
CELLS = {"train_4k": ("train", 16, 8), "prefill_32k": ("prefill", 16, 8),
         "decode_32k": ("decode", 32, 8), "long_500k": ("decode", 32, 1)}
POS = 20
TRAIN = {"zero1": ("qwen1_5_0_5b", {"zero1": True}),
         "no_zero1": ("qwen1_5_0_5b", {"zero1": False}),
         "zero1 mb2": ("qwen1_5_0_5b", {"zero1": True, "microbatches": 2})}
SERVE = {"qwen1_5_0_5b": ("qwen1_5_0_5b", {}),
         "recurrentgemma_2b": ("recurrentgemma_2b", {}),
         "rwkv6_3b": ("rwkv6_3b", {}),
         "whisper_base": ("whisper_base", {}),
         "qwen1_5_0_5b bf16": ("qwen1_5_0_5b", {"attn_bf16_logits": True}),
         "whisper_base bf16": ("whisper_base", {"attn_bf16_logits": True})}
SEQ_PROMPT, SEQ_STEPS = 12, 4
BF16_TOL = 2e-2
WORLD, DEADLINE_S = 8, 300  # spawning 8 ranks under a loaded run

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_collective_call_terminate_timeout_seconds=900")
import numpy as np, jax, jax.numpy as jnp
from repro import configs
from repro.launch import shapes as shp
from repro.launch.steps import _ns, build_cell, make_policy
from repro.models import get_family
from repro.optim import AdamWConfig, adamw_init, adamw_update
from repro.optim.adamw import opt_state_specs

inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
for name, cell in cases["cells"].items():
    shp.SHAPES[name] = shp.ShapeCell(name, *cell)
ks = jax.tree_util.keystr
out = {}

def load(prefix, like):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(inp[prefix + ks(p)]).astype(x.dtype), like)

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + ks(path)] = np.asarray(leaf, np.float32)

def cfg_of(arch, over):
    return dataclasses.replace(configs.get_smoke_config(arch), **over)

def params_of(tag, jc):
    fam = get_family(jc)
    return load(tag + "/w", jax.eval_shape(lambda: fam.init(jax.random.PRNGKey(0), jc)))

def jitted(b):
    return jax.jit(b["step_fn"], in_shardings=b["in_shardings"],
                   out_shardings=b.get("out_shardings"))

for tag, (arch, opts) in cases["train"].items():
    jc = cfg_of(arch, {})
    b = build_cell(jc, "train_4k", mesh, adamw=AdamWConfig(lr=1e-3), **opts)
    params = params_of(tag, jc)
    batch = {"tokens": inp[tag + "/tokens"], "labels": inp[tag + "/labels"]}
    opt = adamw_init(params)
    with jax.set_mesh(mesh):
        p2, o2, m = jitted(b)(params, opt, batch)
    flat(tag + "/params", p2)
    flat(tag + "/m", o2["m"])
    flat(tag + "/v", o2["v"])
    out[tag + "/loss"] = np.asarray(m["loss"])
    out[tag + "/grad_norm"] = np.asarray(m["grad_norm"])

for tag, (arch, over) in cases["serve"].items():
    jc = cfg_of(arch, over)
    fam = get_family(jc)
    params = params_of(tag, jc)
    prompt = inp[tag + "/prompt"]
    arg = {"frames": inp[tag + "/frames"], "tokens": prompt} if jc.family == "whisper" else prompt
    b = build_cell(jc, "decode_32k", mesh)
    cache = load(tag + "/cache", b["specs"][1])
    with jax.set_mesh(mesh):
        logits, pcache = jitted(build_cell(jc, "prefill_32k", mesh))(params, arg)
        out[tag + "/prefill"] = np.asarray(logits)
        flat(tag + "/pcache", pcache)
        logits, cache = jitted(b)(params, cache, inp[tag + "/tok"], jnp.int32(cases["pos"]))
        out[tag + "/decode"] = np.asarray(logits)
        flat(tag + "/dcache", cache)
    if over.get("attn_bf16_logits"):
        S = prompt.shape[1]
        logits, cache = fam.prefill(params, arg, jc, max_len=S + 1)
        out[tag + "/u_prefill"] = np.asarray(logits)
        out[tag + "/u_decode"] = np.asarray(fam.decode_step(params, cache, inp[tag + "/tok"], S,
                                                             jc)[0])
        if jc.family == "whisper":
            batch = dict(arg, labels=inp[tag + "/labels"])
            out[tag + "/u_forward"] = np.asarray(fam.loss_fn(params, batch, jc))
        else:
            out[tag + "/u_forward"] = np.asarray(fam.forward(params, prompt, jc)[0])
        with jax.set_mesh(mesh):
            pol = make_policy(jc, mesh)
            placed = jax.tree.map(jax.device_put, params, _ns(mesh, fam.param_specs(jc, pol)))
            logits, cache = jax.jit(lambda p, a: fam.prefill(p, a, jc, pol, max_len=S + 1))(
                placed, arg)
            out[tag + "/s_prefill"] = np.asarray(logits)
            if jc.family == "whisper":
                out[tag + "/s_forward"] = np.asarray(jax.jit(
                    lambda p, b: fam.loss_fn(p, b, jc, pol))(placed, batch))
            else:
                out[tag + "/s_forward"] = np.asarray(jax.jit(
                    lambda p, t: fam.forward(p, t, jc, pol)[0])(placed, prompt))
            out[tag + "/s_decode"] = np.asarray(jax.jit(
                lambda p, c, t: fam.decode_step(p, c, t, S, jc, pol)[0])(
                    placed, cache, inp[tag + "/tok"]))

jc = cfg_of("qwen1_5_0_5b", {})
fam = get_family(jc)
pol = make_policy(jc, mesh)
shapes = jax.eval_shape(lambda: fam.init(jax.random.PRNGKey(0), jc))
pspecs = fam.param_specs(jc, pol)
ospecs = opt_state_specs(pspecs, shapes, batch_axes=("data",), zero1=True,
                         axis_sizes={"data": 2, "model": 4})
params, grads = params_of("adamw", jc), load("adamw/g", shapes)
state = {"step": jnp.int32(3), "m": load("adamw/m", shapes), "v": load("adamw/v", shapes)}
fn = lambda p, g, s: adamw_update(p, g, s, AdamWConfig(lr=1e-2), update_specs=ospecs["m"])
with jax.set_mesh(mesh):
    p2, s2, m = jax.jit(fn, in_shardings=(_ns(mesh, pspecs), _ns(mesh, pspecs), _ns(mesh, ospecs)))(
        params, grads, state)
flat("adamw/params", p2)
flat("adamw/m_out", s2["m"])
flat("adamw/v_out", s2["v"])
out["adamw/grad_norm"] = np.asarray(m["grad_norm"])

jc = cfg_of("gemma3_12b", {})
fam = get_family(jc)
params = params_of("seq", jc)
logits, cache = fam.prefill(params, inp["seq/prompt"], jc, max_len=cases["cells"]["long_500k"][1])
out["seq/prefill"] = np.asarray(logits)
b = build_cell(jc, "long_500k", mesh)
with jax.set_mesh(mesh):
    step = jitted(b)
    for t in range(cases["seq_steps"]):
        logits, cache = step(params, cache, inp["seq/tok"][:, t:t + 1],
                             jnp.int32(inp["seq/prompt"].shape[1] + t))
        out[f"seq/decode{t}"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def _cfg(arch, over=None):
    return dataclasses.replace(tconfigs.get_smoke_config(arch), **(over or {}))


def _key(path) -> str:
    """A reference leaf's path as ``jax.tree_util.keystr`` writes it."""
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path)


def _ref_path(key: str, cfg) -> tuple:
    """The reference's pytree path of a port reference leaf."""
    parts = [p for p in key.split(".") if p != "*"]
    if parts[0] == "blocks":
        parts[0] = "layers"
    if parts[0] == "norms":
        parts = parts[1:]
    if cfg.family == "rglru_hybrid" and parts[0] == "layers":
        parts[1] = int(parts[1])
        if parts[2] == "mixer":
            parts[2] = cfg._block_kind(parts[1])
    return tuple(parts)


def _by_leaf(tensors: dict, cfg) -> dict:
    """Tensors by port parameter name -> numpy by reference keystr (a
    layer-stacked leaf stacked on L)."""
    out = {}
    for leaf, names in reference_leaves(tensors, cfg).items():
        t = torch.stack([tensors[n] for n in names]) if "*" in leaf else tensors[names[0]]
        out[_key(_ref_path(leaf, cfg))] = t.detach().float().numpy()
    return out


def _tree_keys(tree, path=""):
    """(keystr, leaf) of a cache tree: NamedTuple fields ``.f``, list items
    ``[i]``, None entries skipped."""
    if tree is None:
        return
    if isinstance(tree, InputSpec):
        yield path, tree
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_keys(v, f"{path}[{i}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _tree_keys(v, f"{path}.{f}")
    else:
        yield path, tree


def _model(arch, over=None, trainable=False):
    cfg = _cfg(arch, over)
    return cfg, get_family(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu",
                                     trainable=trainable)


def _mesh():
    return M.Mesh(SHAPE, NAMES, device="cpu")


def _inputs():
    """Every input of the reference subprocess, by key."""
    rng = np.random.default_rng(0)
    inp = {}
    for tag, (arch, _) in TRAIN.items():
        cfg, model = _model(arch)
        inp.update({f"{tag}/w{k}": v for k, v in _by_leaf(dict(model.named_parameters()),
                                                          cfg).items()})
        inp[f"{tag}/tokens"] = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
        inp[f"{tag}/labels"] = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
    for tag, (arch, over) in SERVE.items():
        cfg, model = _model(arch, over)
        inp.update({f"{tag}/w{k}": v for k, v in _by_leaf(dict(model.named_parameters()),
                                                          cfg).items()})
        inp[f"{tag}/prompt"] = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
        inp[f"{tag}/labels"] = rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
        inp[f"{tag}/tok"] = rng.integers(0, cfg.vocab, (8, 1)).astype(np.int32)
        if cfg.family == "whisper":
            inp[f"{tag}/frames"] = rng.standard_normal((8, cfg.encoder_len, cfg.d_model)) \
                .astype(np.float32)
        spec_tree = _cell(cfg, "decode_32k")["specs"][1]
        for key, leaf in _tree_keys(spec_tree):
            inp[f"{tag}/cache{key}"] = (0.5 * rng.standard_normal(leaf.shape)).astype(np.float32)
    cfg, model = _model("qwen1_5_0_5b")
    params = dict(model.named_parameters())
    inp.update({f"adamw/w{k}": v for k, v in _by_leaf(params, cfg).items()})
    for part, scale in (("g", 1.0), ("m", 0.1), ("v", 0.01)):
        arrays = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
                  for n, p in params.items()}
        if part == "v":
            arrays = {n: a.square() for n, a in arrays.items()}
        inp.update({f"adamw/{part}{k}": scale * v for k, v in _by_leaf(arrays, cfg).items()})
    cfg, model = _model("gemma3_12b")
    inp.update({f"seq/w{k}": v for k, v in _by_leaf(dict(model.named_parameters()),
                                                    cfg).items()})
    inp["seq/prompt"] = rng.integers(0, cfg.vocab, (1, SEQ_PROMPT)).astype(np.int32)
    inp["seq/tok"] = rng.integers(0, cfg.vocab, (1, SEQ_STEPS)).astype(np.int32)
    return inp


@pytest.fixture(autouse=True)
def small_shapes(monkeypatch):
    for name, cell in CELLS.items():
        monkeypatch.setitem(tshapes.SHAPES, name, tshapes.ShapeCell(name, *cell))


def _cell(cfg, shape, mesh=None, **opts):
    saved = dict(tshapes.SHAPES)
    try:  # the fixture's cells, also while the inputs are made
        tshapes.SHAPES.update({k: tshapes.ShapeCell(k, *v) for k, v in CELLS.items()})
        return build_cell(cfg, shape, mesh or _mesh(), **opts)
    finally:
        tshapes.SHAPES.clear()
        tshapes.SHAPES.update(saved)


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("steps")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cases = {"cells": CELLS, "train": TRAIN, "serve": SERVE, "pos": POS, "seq_steps": SEQ_STEPS}
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz"),
                           json.dumps(cases)], capture_output=True, text=True, timeout=900,
                          env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _close(got, want, tol=2e-4, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale, err_msg=what)


def _bf16_close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert float(np.abs(got - want).max()) <= BF16_TOL * float(np.abs(want).max()), what


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- train ----------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(TRAIN))
def test_train_step_equals_the_reference(reference, inputs, tag):
    arch, opts = TRAIN[tag]
    cfg, model = _model(arch, trainable=True)
    mesh = _mesh()
    built = _cell(cfg, "train_4k", mesh, adamw=AdamWConfig(lr=1e-3), **opts)
    model, opt_state, _ = built["make_inputs"](model=model)
    bspecs = built["specs"][2]
    batch = {k: M.shard(_t(inputs[f"{tag}/{k}"]), mesh, bspecs[k].spec)
             for k in ("tokens", "labels")}
    model, opt_state, metrics = built["step_fn"](model, opt_state, batch)
    _close(metrics["loss"], reference[f"{tag}/loss"], what="loss")
    _close(metrics["grad_norm"], reference[f"{tag}/grad_norm"], what="grad_norm")
    assert int(opt_state["step"].reshape(-1)[0]) == 1
    params = unshard_tensors(model, {n: p.detach() for n, p in model.named_parameters()})
    zspecs = built["specs"][1]["m"]
    for part, tensors in (("params", params),
                          ("m", {n: M.unshard(t, mesh, zspecs[n].spec)
                                 for n, t in opt_state["m"].items()}),
                          ("v", {n: M.unshard(t, mesh, zspecs[n].spec)
                                 for n, t in opt_state["v"].items()})):
        for key, got in _by_leaf(tensors, cfg).items():
            _close(got, reference[f"{tag}/{part}{key}"], what=f"{part}{key}")


def test_zero1_moments_are_cut_over_the_batch_axis():
    cfg = _cfg("qwen1_5_0_5b")
    on, off = (_cell(cfg, "train_4k", zero1=z)["specs"][1]["m"] for z in (True, False))
    assert any("data" in str(leaf.spec) for leaf in on.values())
    assert not any("data" in str(leaf.spec) for leaf in off.values())


# -- prefill and decode ---------------------------------------------------------


def _laid_cache(cfg, inputs, tag, mesh):
    spec_tree = _cell(cfg, "decode_32k", mesh)["specs"][1]
    arrays = dict(_tree_keys(spec_tree))
    keyed = {id(leaf): key for key, leaf in arrays.items()}
    return tree_map(lambda leaf: M.shard(_t(inputs[f"{tag}/cache{keyed[id(leaf)]}"]).to(
        leaf.dtype), mesh, leaf.spec), spec_tree), spec_tree


def _cache_arrays(cache, spec_tree, mesh) -> dict:
    specs = dict(_tree_keys(spec_tree))
    return {k: M.unshard(t, mesh, specs[k].spec) for k, t in _tree_keys(cache)}


@pytest.mark.parametrize("tag", [t for t in SERVE if not SERVE[t][1]])
def test_prefill_and_decode_steps_equal_the_reference(reference, inputs, tag):
    arch, over = SERVE[tag]
    cfg, model = _model(arch, over)
    mesh = _mesh()
    built = _cell(cfg, "prefill_32k", mesh)
    model = built["make_inputs"](model=model)[0]
    prompt = M.shard(_t(inputs[f"{tag}/prompt"]), mesh, built["specs"][1]["tokens"].spec
                     if cfg.family == "whisper" else built["specs"][1].spec)
    if cfg.family == "whisper":
        frames = M.shard(_t(inputs[f"{tag}/frames"]), mesh, built["specs"][1]["frames"].spec)
        prompt = {"frames": frames, "tokens": prompt}
    logits, cache = built["step_fn"](model, prompt)
    _close(logits, reference[f"{tag}/prefill"], what="prefill logits")
    pspec = get_family(cfg).cache_spec(cfg, built["policy"])
    if cfg.family == "transformer":  # one spec for k and v
        pspec = KVCache(pspec, pspec)
    specs = dict(_tree_keys(pspec))
    for key, t in _tree_keys(cache):
        _close(M.unshard(t, mesh, specs[key]), reference[f"{tag}/pcache{key}"],
               what=f"pcache{key}")
    dec = _cell(cfg, "decode_32k", mesh)
    cache, spec_tree = _laid_cache(cfg, inputs, tag, mesh)
    tok = M.shard(_t(inputs[f"{tag}/tok"]), mesh, dec["specs"][2].spec)
    logits, cache = dec["step_fn"](model, cache, tok, POS)
    _close(logits, reference[f"{tag}/decode"], what="decode logits")
    for key, got in _cache_arrays(cache, spec_tree, mesh).items():
        _close(got, reference[f"{tag}/dcache{key}"], what=f"dcache{key}")


# -- the ZeRO-1 update ----------------------------------------------------------


def test_adamw_update_specs_equal_the_reference_and_the_update_without_them(reference, inputs):
    cfg, model = _model("qwen1_5_0_5b")
    mesh = _mesh()
    policy = make_policy(cfg, mesh)
    shard_model(model, mesh, policy)
    specs = {n: tuple(s) for n, s in laid_out_specs(model).items()}
    names = [n for n, _ in model.named_parameters()]
    zspecs = opt_state_specs(specs, {n: p.shape[mesh.stacked:] for n, p in
                                     model.named_parameters()}, batch_axes=("data",),
                             axis_sizes={"data": 2, "model": 4})["m"]
    leaves_of = reference_leaves(names, cfg)

    def by_name(part):
        out = {}
        for leaf, ns in leaves_of.items():
            a = _t(inputs[f"adamw/{part}{_key(_ref_path(leaf, cfg))}"])
            out.update(zip(ns, a.unbind(0)) if "*" in leaf else ((ns[0], a),))
        return out

    grads = {n: M.shard(g, mesh, specs[n]) for n, g in by_name("g").items()}
    params = dict(model.named_parameters())
    cfg_a = AdamWConfig(lr=1e-2)
    results = []
    for upd in (zspecs, None):
        lay = upd or specs
        state = {"step": torch.tensor(3, dtype=torch.int32),
                 "m": {n: M.shard(t, mesh, lay[n]) for n, t in by_name("m").items()},
                 "v": {n: M.shard(t, mesh, lay[n]) for n, t in by_name("v").items()}}
        new, st, met = adamw_update(params, grads, state, cfg_a, layout=(mesh, specs),
                                    update_specs=upd)
        results.append(({n: M.unshard(new[n], mesh, specs[n]) for n in names},
                        {n: M.unshard(st["m"][n], mesh, lay[n]) for n in names},
                        {n: M.unshard(st["v"][n], mesh, lay[n]) for n in names}, met))
    (p1, m1, v1, met1), (p0, m0, v0, met0) = results
    _close(met1["grad_norm"], reference["adamw/grad_norm"], what="grad_norm")
    for part, got in (("params", p1), ("m_out", m1), ("v_out", v1)):
        for key, arr in _by_leaf(got, cfg).items():
            _close(arr, reference[f"adamw/{part}{key}"], what=f"{part}{key}")
    for a, b in ((p1, p0), (m1, m0), (v1, v0)):
        for n in names:
            _close(a[n].numpy(), b[n].numpy(), tol=1e-6, what=n)


# -- bf16 logits ----------------------------------------------------------------


@pytest.mark.parametrize("tag", [t for t in SERVE if SERVE[t][1]])
def test_bf16_logits_equal_the_reference(reference, inputs, tag):
    arch, over = SERVE[tag]
    cfg, model = _model(arch, over)
    fam = get_family(cfg)
    prompt = _t(inputs[f"{tag}/prompt"]).long()
    tok = _t(inputs[f"{tag}/tok"]).long()
    arg = {"frames": _t(inputs[f"{tag}/frames"]), "tokens": prompt} \
        if cfg.family == "whisper" else prompt
    S = prompt.shape[1]
    with torch.no_grad():
        if cfg.family == "whisper":
            fwd = fam.loss_fn(model, dict(arg, labels=_t(inputs[f"{tag}/labels"]).long()), cfg)
        else:
            fwd = fam.forward(model, prompt, cfg)[0]
        _bf16_close(fwd, reference[f"{tag}/u_forward"], "forward")
        logits, cache = fam.prefill(model, arg, cfg, max_len=S + 1)
        _bf16_close(logits, reference[f"{tag}/u_prefill"], "prefill")
        _bf16_close(fam.decode_step(model, cache, tok, S, cfg)[0], reference[f"{tag}/u_decode"],
                    "decode")
        mesh = _mesh()
        policy = make_policy(cfg, mesh)
        shard_model(model, mesh, policy)
        if cfg.family == "whisper":
            fwd = fam.loss_fn(model, dict(arg, labels=_t(inputs[f"{tag}/labels"]).long()), cfg,
                              policy)
        else:
            fwd = fam.forward(model, prompt, cfg, policy)[0]
        _bf16_close(fwd, reference[f"{tag}/s_forward"], "sharded forward")
        logits, cache = fam.prefill(model, arg, cfg, policy, max_len=S + 1)
        _bf16_close(logits, reference[f"{tag}/s_prefill"], "sharded prefill")
        _bf16_close(fam.decode_step(model, cache, tok, S, cfg, policy)[0],
                    reference[f"{tag}/s_decode"], "sharded decode")


def test_bf16_sdpa_blocks_equal_the_reference():
    rng = np.random.default_rng(3)
    jc = dataclasses.replace(jconfigs.get_smoke_config("yi_6b"), attn_bf16_logits=True)
    tc = _cfg("yi_6b", {"attn_bf16_logits": True})
    B, Sq, Sk, Hkv, G, hd = 2, 5, 7, 2, 2, 16
    q5 = rng.standard_normal((B, Sq, Hkv, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    mask = np.tril(np.ones((Sq, Sk), bool), k=Sk - Sq)[None, None]
    got = tattn._sdpa_block(_t(q5), _t(k), _t(v), _t(mask), tc)
    want = jattn._sdpa_block(jnp.asarray(q5), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                             jc)
    _bf16_close(got, want, "_sdpa_block")
    q = q5.reshape(B, Sq, Hkv * G, hd)
    got = tattn._sdpa_flat(_t(q), _t(k), _t(v), _t(mask), tc)
    want = jattn._sdpa_flat(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jc)
    _bf16_close(got, want, "_sdpa_flat")
    assert tattn._bf16(1 / 128 ** 0.5) == float(jnp.asarray(1 / 128 ** 0.5, jnp.bfloat16))


# The flag's own numerics (bf16 logits, scale and softmax) against an
# f32-logit control, on logits of std ~9 (q and k of std 3, hd 128), where
# bf16 rounding moves the probabilities.  The limit sits between the two
# readings that the test prints (``pytest -s``): over its eight seeds the
# port's bf16 path and the f32 control, each as a share of max|out| of the
# reference's bf16 path.
FLAG_TOL = 9e-3


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("path", ["_sdpa_block", "_sdpa_flat"])
def test_bf16_sdpa_blocks_hold_the_flags_numerics(path, seed):
    rng = np.random.default_rng(seed)
    jc = dataclasses.replace(jconfigs.get_smoke_config("yi_6b"), attn_bf16_logits=True)
    B, Sq, Sk, Hkv, G, hd = 2, 9, 33, 2, 2, 128
    q = 3 * rng.standard_normal((B, Sq, Hkv, G, hd)).astype(np.float32)
    k = 3 * rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    mask = np.tril(np.ones((Sq, Sk), bool), k=Sk - Sq)[None, None]
    if path == "_sdpa_flat":
        q = q.reshape(B, Sq, Hkv * G, hd)
    want = np.asarray(getattr(jattn, path)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(mask), jc), np.float32)

    def gap(flag):
        got = getattr(tattn, path)(_t(q), _t(k), _t(v), _t(mask),
                                   _cfg("yi_6b", {"attn_bf16_logits": flag}))
        return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())

    sound, control = gap(True), gap(False)
    print(f"{path} seed {seed}: bf16 logits {sound:.3e}, f32 control {control:.3e}")
    assert sound <= FLAG_TOL < control


# -- the sequence-split decode --------------------------------------------------


def _seq_decode(mesh, inputs):
    """gemma3's smoke model from seed 0 laid out for ``long_500k`` on
    ``mesh``: (prefill logits, [logits of each decode step], the policy)."""
    cfg, model = _model("gemma3_12b")
    built = _cell(cfg, "long_500k", mesh)
    model, _, _, _ = built["make_inputs"](model=model)
    policy = built["policy"]
    with torch.no_grad():
        logits, cache = get_family(cfg).prefill(model, _t(inputs["seq/prompt"]).long(), cfg,
                                                policy, max_len=CELLS["long_500k"][1])
        steps = []
        for t in range(SEQ_STEPS):
            tok = M.shard(_t(inputs["seq/tok"][:, t:t + 1]), mesh, built["specs"][2].spec)
            step, cache = built["step_fn"](model, cache, tok, SEQ_PROMPT + t)
            steps.append(step)
    return logits, steps, policy


def test_sequence_split_decode_equals_the_reference(reference, inputs):
    mesh = _mesh()
    logits, steps, policy = _seq_decode(mesh, inputs)
    cfg = _cfg("gemma3_12b")
    assert policy.batch_axes == () and policy.cache_seq_axis == "data"
    assert get_family(cfg).cache_spec(cfg, policy)[2] == "data"
    _close(logits, reference["seq/prefill"], what="prefill")
    for t, got in enumerate(steps):
        _close(got, reference[f"seq/decode{t}"], what=f"decode {t}")


@pytest.mark.parametrize("arch", ["rwkv6_3b", "recurrentgemma_2b"])
def test_long_context_decode_of_the_recurrent_families(arch):
    """No batch axes on a mesh with a "data" axis: equal to the unsharded
    decode on the same cache."""
    cfg, model = _model(arch)
    mesh = _mesh()
    built = _cell(cfg, "long_500k", mesh)
    assert built["policy"].batch_axes == ()
    fam = get_family(cfg)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab, (1, 8), generator=gen)
    tok = torch.randint(0, cfg.vocab, (1, 1), generator=gen)
    with torch.no_grad():
        _, cache = fam.prefill(model, prompt, cfg, max_len=CELLS["long_500k"][1])
        want, _ = fam.decode_step(model, cache, tok, 8, cfg)
        sharded = built["make_inputs"](model=model)[0]
        _, cache = fam.prefill(sharded, prompt, cfg, built["policy"],
                               max_len=CELLS["long_500k"][1])
        got, _ = built["step_fn"](sharded, cache, M.shard(tok, mesh, built["specs"][2].spec), 8)
    _close(got, want, what=arch)


def _rank_main(rank: int, root: str, inputs: dict):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=WORLD)
    for name, cell in CELLS.items():
        tshapes.SHAPES[name] = tshapes.ShapeCell(name, *cell)
    mesh = M.RankMesh(SHAPE, NAMES, device="cpu")
    logits, steps, _ = _seq_decode(mesh, inputs)
    torch.save((logits, steps), f"{root}/rank{rank}.pt")
    dist.destroy_process_group()


def test_sequence_split_decode_on_gloo_ranks_equals_the_stacked_mesh(tmp_path, inputs):
    seq = {k: v for k, v in inputs.items() if k.startswith("seq/")}
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_main, args=(str(tmp_path), seq), nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t0 > DEADLINE_S:
                raise TimeoutError(f"gloo ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        logits, steps, _ = _seq_decode(_mesh(), inputs)
    finally:
        torch.set_num_threads(threads)
    for rank in range(WORLD):
        got_logits, got_steps = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert torch.equal(got_logits, logits), rank
        for t, (g, w) in enumerate(zip(got_steps, steps)):
            assert torch.equal(g, w), (rank, t, (g - w).abs().max())
