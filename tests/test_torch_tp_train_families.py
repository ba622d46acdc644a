"""Sharded training of the recurrentgemma hybrid, rwkv6 and whisper, on the CPU.

For each of the three smoke configs, with sequence parallelism off and on,
the JAX parameters from ``PRNGKey(0)`` are carried across by
``from_jax_params`` and laid out on a stacked ``(2, 4)`` ``("data",
"model")`` mesh by ``shard_model`` under ``make_policy``.  The sharded
``loss_fn`` and every leaf's global gradient (``global_grads``: each copy's
share summed, unsharded) are held at rtol / atol 2e-4 against the
reference's own sharded run: ``jax.jit(jax.value_and_grad(loss_fn(...,
policy)))`` under ``jax.set_mesh`` on 8 spoofed XLA host devices in one
subprocess for the module (``XLA_FLAGS`` is set before JAX loads), its
parameters placed with ``NamedSharding`` by its ``param_specs``; and the
gradients' global norm under the layout (``optim.global_norm``) against
the norm of the reference's.  The batches are ``tests/test_torch_tp_train.py``'s:
labels of -1 in row 0, and, in the cases with a vocab of 250 padded to
256 and a loss chunk of 6 (the last slab ragged), labels in the padded
rows.  Whisper's batch carries its frames.  The same loss and gradients
are held against the port's unsharded model.

The trainer: 4 steps of ``Trainer(policy=, mesh=)`` for the hybrid and
rwkv6, sequence-parallel, against 4 of the reference's ``Trainer(policy=,
mesh=)`` under ``jax.set_mesh``, losses and final parameters at the
unsharded trainer test's rtol 1e-4 / atol 1e-5, from the reference
trainer's initial weights, which its subprocess writes.  (The reference's
trainer takes token batches only, so whisper has none.)
"""

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import mesh as M
from repro_torch.data import SyntheticLMSource
from repro_torch.launch.steps import make_policy
from repro_torch.models import get_family
from repro_torch.models.convert import (from_jax_params, global_grads, laid_out_specs,
                                        reference_leaves, shard_model, unshard_tensors)
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE, NAMES = (2, 4), ("data", "model")
B, S = 4, 16
ARCHS = ("recurrentgemma_2b", "rwkv6_3b", "whisper_base")
# loss and gradient cases: name -> (arch, seq_parallel, config overrides)
CASES = {f"{a} sp={sp}": (a, sp, {}) for a in ARCHS for sp in (False, True)}
for _a in ("recurrentgemma_2b", "whisper_base"):  # a tied head over a padded vocab
    CASES[f"{_a} padded vocab, ragged slab"] = (_a, True, {"vocab": 250, "loss_chunk": 6})
# trainer cases: name -> (arch, seq_parallel, adamw)
TRAINERS = {f"{a} sp": (a, True, {"lr": 1e-3}) for a in ("recurrentgemma_2b", "rwkv6_3b")}
TRAIN_STEPS = 4

REFERENCE = r"""
import os, sys, json, dataclasses
# a device thread starved by a loaded host must not abort the run at the
# collectives' default 40 s rendezvous deadline
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_collective_call_terminate_timeout_seconds=900")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.data import SyntheticLMSource
from repro.launch.steps import make_policy
from repro.models import get_family
from repro.optim import AdamWConfig
from repro.runtime.trainer import Trainer, TrainerConfig

inp = dict(np.load(sys.argv[1]))
cases, trainers, steps = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}

def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf)

for name, (arch, sp, over) in cases.items():
    jc = dataclasses.replace(configs.get_smoke_config(arch), **over)
    fam = get_family(jc)
    pol = make_policy(jc, mesh, seq_parallel=sp)
    params = fam.init(jax.random.PRNGKey(0), jc)
    batch = {k[len(name) + 1:]: v for k, v in inp.items() if k.startswith(name + "/")}
    with jax.set_mesh(mesh):
        placed = jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
                              fam.param_specs(jc, pol), params,
                              is_leaf=lambda x: isinstance(x, P))
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: fam.loss_fn(p, b, jc, pol)))(
            placed, batch)
    flat(f"{name}/init", params)
    out[f"{name}/loss"] = np.asarray(loss)
    out[f"{name}/gnorm"] = np.asarray(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                                                   for g in jax.tree.leaves(grads))))
    flat(f"{name}/grads", grads)
for name, (arch, sp, adamw) in trainers.items():
    jc = configs.get_smoke_config(arch)
    pol = make_policy(jc, mesh, seq_parallel=sp)
    src = SyntheticLMSource(vocab=jc.vocab, seq_len=16, global_batch=4, seed=1)
    with jax.set_mesh(mesh):
        tr = Trainer(jc, TrainerConfig(adamw=AdamWConfig(**adamw), warmup=2, total_steps=10),
                     policy=pol, mesh=mesh)
        params, _ = tr.fit(src, steps=steps, resume=False)
    out[f"{name}/losses"] = np.array([m["loss"] for m in tr.metrics_log])
    flat(f"{name}/init", tr.init_state(jax.random.PRNGKey(0))[0])
    flat(f"{name}/params", params)
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def _cfg(name: str):
    arch, _, over = CASES[name]
    return dataclasses.replace(tconfigs.get_smoke_config(arch), **over)


def _batch(name: str) -> dict:
    """Tokens and labels of a case (negative labels in row 0; for a padded
    vocab, labels in the padded rows too), and whisper's frames."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    cfg = _cfg(name)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.padded_vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    if cfg.padded_vocab != cfg.vocab:
        labels[1, :4] = np.arange(cfg.vocab, cfg.vocab + 4)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "whisper":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train_families")
    np.savez(d / "in.npz", **{f"{name}/{k}": v for name in CASES for k, v in _batch(name).items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz"),
                           json.dumps([CASES, TRAINERS, TRAIN_STEPS])],
                          capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _tree(ref: dict, prefix: str):
    """The nested pytree of numpy arrays that ``prefix`` + keystr(path) keys
    hold: ``['name']`` a dict key, ``[i]`` a list index (the hybrid's layers)."""
    root = {}
    for key, value in ref.items():
        if key.startswith(prefix + "["):
            parts = [int(i) if i else k for k, i in
                     re.findall(r"\[(?:'([^']*)'|(\d+))\]", key[len(prefix):])]
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _by_leaf(model) -> dict:
    """A model's parameters by reference leaf (layer-stacked leaves stacked)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {leaf: torch.stack([params[n] for n in names]) if "*" in leaf else params[names[0]]
            for leaf, names in reference_leaves(params, model.cfg).items()}


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v if k == "frames" else np.asarray(v, np.int64))
            for k, v in batch.items()}


def _sharded_grads(model, cfg, seq_parallel: bool, batch: dict):
    """(loss, global gradients by reference leaf, the gradients' global norm)
    of ``model`` laid out on the (2, 4) mesh."""
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    sharded = shard_model(copy.deepcopy(model), mesh, policy).requires_grad_(True)
    loss = get_family(cfg).loss_fn(sharded, batch, cfg, policy)
    names = [n for n, _ in sharded.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(sharded.parameters()))))
    specs = laid_out_specs(sharded)
    summed = {k: M.sum_copies(g, mesh, specs[k]) for k, g in grads.items()}
    return loss, global_grads(sharded, grads), global_norm(summed, (mesh, specs))


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_gradients_match_the_reference(reference, case):
    cfg = _cfg(case)
    model = from_jax_params(_tree(reference, f"{case}/init"), cfg, "cpu", trainable=True)
    loss, got, norm = _sharded_grads(model, cfg, CASES[case][1], _tensors(_batch(case)))
    np.testing.assert_allclose(loss.item(), float(reference[f"{case}/loss"]), **TOL)
    want = _by_leaf(from_jax_params(_tree(reference, f"{case}/grads"), cfg, "cpu"))
    assert sorted(got) == sorted(want)
    for leaf, g in got.items():
        assert g.shape == want[leaf].shape, leaf
        _close(g, want[leaf].numpy(), leaf)
    np.testing.assert_allclose(norm.item(), float(reference[f"{case}/gnorm"]), rtol=2e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_gradients_equal_the_unsharded_model(case):
    cfg = _cfg(case)
    model = get_family(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu", trainable=True)
    batch = _tensors(_batch(case))
    loss, got, _ = _sharded_grads(model, cfg, CASES[case][1], batch)
    want_loss = get_family(cfg).loss_fn(model, batch, cfg)
    np.testing.assert_allclose(loss.item(), want_loss.item(), **TOL)
    plain = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(want_loss, list(model.parameters()))))
    want = {leaf: torch.stack([plain[n] for n in ns]) if "*" in leaf else plain[ns[0]]
            for leaf, ns in reference_leaves(plain, cfg).items()}
    for leaf, g in got.items():
        _close(g, want[leaf].numpy(), leaf)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sharded_trainer_matches_the_reference_trainer(reference, name):
    arch, sp, adamw = TRAINERS[name]
    tc = tconfigs.get_smoke_config(arch)
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    init = from_jax_params(_tree(reference, f"{name}/init"), tc, "cpu")
    trainer = Trainer(tc, TrainerConfig(adamw=AdamWConfig(**adamw), warmup=2, total_steps=10),
                      model=init, mesh=mesh, policy=make_policy(tc, mesh, seq_parallel=sp))
    src = SyntheticLMSource(vocab=tc.vocab, seq_len=16, global_batch=4, seed=1)
    model, _ = trainer.fit(src, steps=TRAIN_STEPS, resume=False)
    np.testing.assert_allclose([m["loss"] for m in trainer.metrics_log],
                               reference[f"{name}/losses"], rtol=1e-5)
    got = unshard_tensors(model, dict(model.named_parameters()))
    want = from_jax_params(_tree(reference, f"{name}/params"), tc, "cpu")
    for k, w in want.named_parameters():
        _close(got[k], w.detach().numpy(), k, dict(rtol=1e-4, atol=1e-5))
