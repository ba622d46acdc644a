"""Data-parallel training with int8-compressed gradients on a stacked mesh
of 8 members, and the elastic re-mesh to 4: the port's counterpart of
``tests/progs/dp_train_prog.py``, on the CPU.

The reference trainer runs in a subprocess on 8 spoofed XLA host devices
(``XLA_FLAGS`` must be set before JAX loads, as ``tests/test_multidevice.py``
runs its progs), from ``PRNGKey(0)`` weights on dp_train_prog's tiny config
and source; it writes its losses, its first step's mean gradients and its
parameters to an ``.npz``.  The port starts from the same weights
(``models/convert.py:from_jax_params``).

Tolerances.  Both sides compute each member's loss and gradients in f32 in
other summation orders (XLA against torch, about 1e-7 relative apart), and
``compressed_mean`` then rounds g / scale to an integer: where that
quotient lies within such a difference of a .5 boundary, the two sides
round apart and the mean moves by one quantum, scale / n.  So the first
step's mean gradients are held element by element within 1e-5 of |mean|
plus the leaf's quantum, but for the flips, which are counted (each exactly one
quantum) and must stay below 1 in 10^4 elements (2 of 29,024 on this
config).  AdamW normalises each element's step, so a flip where the mean
is a quantum or two moves that element by up to one step, ``lr``, and
from then on the two runs drift apart as their gradients differ: the
per-step losses are held at rtol 1e-4 (2.2e-5 seen over 40 steps) and
the final parameters within 3 ``lr`` (9e-3; 5.6e-3 seen).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import get_family as jfamily
from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as M
from repro_torch.data import SyntheticLMSource
from repro_torch.models import get_family
from repro_torch.models.convert import from_jax_params, reference_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.elastic import largest_pow2_mesh, reshard
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
PROGS = ROOT / "tests" / "progs"
STEPS = 40
LR = 3e-3
SOURCE = dict(seq_len=16, global_batch=16, seed=0, branching=2)

# The reference side: dp_train_prog's config and trainer, plus the first
# step's mean gradients (the trainer's own shard_map body, returned per
# device), a run with 2 microbatches a member, and a checkpointed run
# resumed by a new trainer.
REFERENCE = r"""
import os, sys, json, dataclasses, tempfile
sys.path.insert(0, sys.argv[1])
import dp_train_prog  # sets XLA_FLAGS to 8 host devices before JAX loads
from functools import partial
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.data import SyntheticLMSource
from repro.optim import AdamWConfig, compressed_mean
from repro.runtime import Trainer, TrainerConfig

cfg = dp_train_prog.tiny_cfg()
kw = json.loads(sys.argv[3])
mesh = jax.make_mesh((8,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
src = SyntheticLMSource(vocab=cfg.vocab, **kw)
tcfg = TrainerConfig(compress_grads=True, dp_axis="data",
                     adamw=AdamWConfig(lr=3e-3, weight_decay=0.0), warmup=5, total_steps=100)
out = {}

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

with jax.set_mesh(mesh):
    tr = Trainer(cfg, tcfg, mesh=mesh)
    params, _ = tr.fit(src, steps=int(sys.argv[4]), resume=False)
    out["losses"] = np.array([m["loss"] for m in tr.metrics_log])
    flat("final", params)

    init = tr.init_state(jax.random.PRNGKey(0))[0]
    batch = {k: jnp.asarray(v) for k, v in src.batch_at(0).items()}
    def body(p, b):
        _, g = tr._grads(p, b)
        mean, _ = compressed_mean(g, "data", None)
        return jax.tree.map(lambda x: x[None], mean)
    per_dev = jax.jit(partial(jax.shard_map, mesh=mesh, in_specs=(P(), P("data")),
                              out_specs=P("data"), check_vma=False)(body))(init, batch)
    flat("mean", per_dev)

    tr_mb = Trainer(cfg, dataclasses.replace(tcfg, microbatches=2), mesh=mesh)
    tr_mb.fit(src, steps=3, resume=False)
    out["losses_mb"] = np.array([m["loss"] for m in tr_mb.metrics_log])

    with tempfile.TemporaryDirectory() as d:
        ck = dataclasses.replace(tcfg, ckpt_dir=d, ckpt_every=2)
        Trainer(cfg, ck, mesh=mesh).fit(src, steps=3, resume=False)
        again = Trainer(cfg, ck, mesh=mesh)
        resumed, _ = again.fit(src, steps=6, resume=True)
        out["losses_resumed"] = np.array([m["loss"] for m in again.metrics_log])
        flat("resumed", resumed)
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def tiny_cfg():
    cfg = get_smoke_config("qwen1_5_0_5b")
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _tcfg(**kw):
    return TrainerConfig(compress_grads=True, dp_axis="data",
                         adamw=AdamWConfig(lr=LR, weight_decay=0.0), warmup=5,
                         total_steps=100, **kw)


def _source(cfg):
    return SyntheticLMSource(vocab=cfg.vocab, **SOURCE)


def _as_model(leaves, prefix, initial):
    """The reference leaves under ``prefix`` (by key path) as the port's model."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(initial)
    tree = jax.tree.unflatten(treedef, [leaves[prefix + jax.tree_util.keystr(p)]
                                        for p, _ in paths])
    return dict(from_jax_params(tree, tiny_cfg(), "cpu").named_parameters())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_reference") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(PROGS), str(out),
                           json.dumps(SOURCE), str(STEPS)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0 and "REFERENCE OK" in proc.stdout, proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def initial():
    """The reference's PRNGKey(0) weights on the tiny config, as numpy."""
    from repro.configs import get_smoke_config as jsmoke

    jc = dataclasses.replace(jsmoke("qwen1_5_0_5b"), n_layers=2, d_model=32, n_heads=2,
                             n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)
    return jax.tree.map(np.asarray, jfamily(jc).init(jax.random.PRNGKey(0), jc))


def _model(initial):
    return from_jax_params(initial, tiny_cfg(), "cpu")


@pytest.fixture(scope="module")
def port_run(initial):
    """40 compressed steps on the stacked 8-member mesh from the reference's weights."""
    cfg = tiny_cfg()
    mesh = M.Mesh((8,), ("data",), device="cpu")
    tr = Trainer(cfg, _tcfg(), model=_model(initial), mesh=mesh)
    model, _ = tr.fit(_source(cfg), steps=STEPS, resume=False)
    return tr, model


def test_dp_compressed_loss_falls_and_tracks_uncompressed(port_run):
    """dp_train_prog's gates: the loss falls by more than 0.3 over 40 steps
    and ends within 0.5 of the uncompressed run on one member."""
    tr, _ = port_run
    cfg = tiny_cfg()
    first = np.mean([m["loss"] for m in tr.metrics_log[:5]])
    last = np.mean([m["loss"] for m in tr.metrics_log[-5:]])
    assert last < first - 0.3, (first, last)
    plain = Trainer(cfg, dataclasses.replace(_tcfg(), compress_grads=False, dp_axis=None),
                    device="cpu")
    plain.fit(_source(cfg), steps=STEPS, resume=False)
    last_u = np.mean([m["loss"] for m in plain.metrics_log[-5:]])
    assert abs(last - last_u) < 0.5, (last, last_u)


def test_elastic_remesh_8_to_4_keeps_a_finite_loss():
    """dp_train_prog's elastic half: replicated parameters laid out on the
    (4, 2) mesh of 8 members, re-meshed onto the (2, 2) mesh of 5
    survivors, and each member's loss on its rows of the batch is finite;
    the mean over the data axis is the global batch's loss."""
    cfg = tiny_cfg()
    fam = get_family(cfg)
    model = fam.init(torch.Generator().manual_seed(0), cfg, "cpu")
    params = dict(model.named_parameters())
    mesh8 = largest_pow2_mesh(range(8), ("data", "model"), model_max=2, device="cpu")
    assert mesh8.shape == (4, 2)
    specs = {k: () for k in params}
    params8 = reshard({k: p.detach() for k, p in params.items()}, specs, mesh8)
    mesh4 = largest_pow2_mesh(range(5), ("data", "model"), model_max=2, device="cpu")
    assert mesh4.shape == (2, 2)
    params4 = reshard(params8, specs, mesh4, src=mesh8)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=8, global_batch=8, seed=0)
    batch = {k: M.shard(torch.from_numpy(v).long(), mesh4, ("data",))
             for k, v in src.batch_at(0).items()}
    losses = torch.empty(mesh4.shape)
    member = fam.init(torch.Generator().manual_seed(1), cfg, "cpu")
    with torch.no_grad():
        for i in range(2):
            for j in range(2):
                for k, p in member.named_parameters():
                    p.copy_(params4[k][i, j])
                losses[i, j] = fam.loss_fn(member, {k: v[i, j] for k, v in batch.items()}, cfg)
    assert torch.isfinite(losses).all()
    whole = fam.loss_fn(model, {k: torch.from_numpy(v).long()
                                for k, v in src.batch_at(0).items()}, cfg)
    np.testing.assert_allclose(losses.mean(0)[0].item(), whole.item(), rtol=1e-5)
    assert torch.equal(losses[:, 0], losses[:, 1])  # the model axis holds copies


def test_losses_match_reference_trainer(reference, port_run):
    tr, _ = port_run
    got = np.array([m["loss"] for m in tr.metrics_log])
    assert got.shape == (STEPS,)
    np.testing.assert_allclose(got, reference["losses"], rtol=1e-4)
    # the first step's loss is member 0's, from equal weights: no rounding flip yet
    np.testing.assert_allclose(got[0], reference["losses"][0], rtol=1e-6)


def test_first_step_mean_gradients_match_reference_but_for_counted_flips(reference, initial):
    """One step's compressed mean against the reference's on every device:
    every element within 1e-5 of its |mean| plus its leaf's quantum (the
    two sides' scales are f32 maxima of gradients a summation order
    apart), or one quantum off (a rounding flip at a .5 boundary), and
    flips rare."""
    cfg = tiny_cfg()
    model = _model(initial)
    mesh = M.Mesh((8,), ("data",), device="cpu")
    tr = Trainer(cfg, _tcfg(), model=model, mesh=mesh)
    state = tr.init_state()
    batch = {k: torch.from_numpy(v).long() for k, v in _source(cfg).batch_at(0).items()}
    _, mean, _ = tr._dp_grads(state[0], batch, None)
    means = {k: v for k, v in reference.items() if k.startswith("mean")}
    for v in means.values():  # every device holds the same mean
        assert (v == v[:1]).all()
    want = _as_model({k: v[0] for k, v in means.items()}, "mean", initial)
    flips = total = 0
    for name, g in mean.items():
        quantum = _quantum(state[0], batch, tr, name)
        w = want[name].detach()
        diff, tol = (g - w).abs(), 1e-5 * (w.abs() + quantum)
        close = diff <= tol
        flipped = (diff - quantum).abs() <= tol
        assert bool((flipped | close).all()), (name, diff.max().item(), quantum)
        flips += int((flipped & ~close).sum())
        total += g.numel()
    print(f"rounding flips in the first step's mean gradients: {flips} of {total}")
    assert flips <= total * 1e-4, (flips, total)


_QUANTA = {}


def _quantum(model, batch, tr, name):
    """scale / n of parameter ``name`` in the first step: the pmax over the
    8 members of max|g| / 127 of its reference leaf (all layers of a
    layer-stacked leaf)."""
    if not _QUANTA:
        per = batch["tokens"].shape[0] // 8
        amax = {}
        for i in range(8):
            _, grads = tr._grads(model, {k: v[i * per:(i + 1) * per] for k, v in batch.items()})
            for k, g in grads.items():
                amax[k] = max(amax.get(k, 0.0), g.float().abs().max().item())
        for names in reference_leaves(amax, tiny_cfg()).values():
            scale = max(max(amax[k] for k in names) / 127.0, 1e-12)
            _QUANTA.update(dict.fromkeys(names, scale / 8))
    return _QUANTA[name]


def test_final_params_match_reference_trainer(reference, port_run, initial):
    _, model = port_run
    want = _as_model(reference, "final", initial)
    worst = max((p.detach() - want[name].detach()).abs().max().item()
                for name, p in model.named_parameters())
    print(f"final parameters: worst |difference| {worst:.3e} (bound {3 * LR:g})")
    assert worst <= 3 * LR


def test_microbatches_compose_with_dp_as_the_reference(reference, initial):
    """2 microbatches a member, averaged before the compressed mean."""
    cfg = tiny_cfg()
    tr = Trainer(cfg, _tcfg(microbatches=2), model=_model(initial),
                 mesh=M.Mesh((8,), ("data",), device="cpu"))
    tr.fit(_source(cfg), steps=3, resume=False)
    np.testing.assert_allclose([m["loss"] for m in tr.metrics_log], reference["losses_mb"],
                               rtol=2e-5)


def test_resume_gives_every_member_member0s_residuals_as_the_reference(reference, initial,
                                                                       tmp_path):
    """A checkpoint at step 2 holds member 0's residuals, and a new trainer
    resumed from it runs on as the reference's does."""
    cfg = tiny_cfg()
    mesh = M.Mesh((8,), ("data",), device="cpu")
    ck = _tcfg(ckpt_dir=str(tmp_path), ckpt_every=2)
    first = Trainer(cfg, ck, model=_model(initial), mesh=mesh)
    first.fit(_source(cfg), steps=3, resume=False)
    again = Trainer(cfg, ck, model=_model(initial), mesh=mesh)
    (_, opt_state, err), step, _ = again.recover(again.init_state())
    assert step == 3 and int(opt_state["step"]) == 3
    live = first.state[2]
    for k, e in err.items():
        assert e.shape == (8,) + live[k].shape[1:]
        assert torch.equal(e, live[k][:1].expand_as(e))  # member 0's, everywhere
    assert any(not torch.equal(live[k][0], live[k][1]) for k in live)
    resumed, _ = again.fit(_source(cfg), steps=6, resume=True)
    assert [m["step"] for m in again.metrics_log] == [4, 5, 6]
    np.testing.assert_allclose([m["loss"] for m in again.metrics_log],
                               reference["losses_resumed"], rtol=2e-5)
    want = _as_model(reference, "resumed", initial)
    for name, p in resumed.named_parameters():
        assert (p.detach() - want[name].detach()).abs().max().item() <= 3 * LR, name
