"""Sharded training of the transformer family, on the CPU.

For each of the seven transformer smoke configs (the dense yi, qwen, glm4,
gemma3, chameleon and the MoE moonshot and phi3.5-moe), with sequence
parallelism off and on, the JAX parameters from ``PRNGKey(0)`` are carried
across by ``from_jax_params`` and laid out on a stacked ``(2, 4)``
``("data", "model")`` mesh by ``shard_model`` under ``make_policy``.  The
sharded ``loss_fn`` and every leaf's global gradient (``global_grads``:
each copy's share summed, unsharded) are held at rtol / atol 2e-4 against
the reference's own sharded run: ``jax.jit(jax.value_and_grad(loss_fn(...,
policy)))`` under ``jax.set_mesh`` on 8 spoofed XLA host devices in one
subprocess for the module (``XLA_FLAGS`` is set before JAX loads), its
parameters placed with ``NamedSharding`` by its ``param_specs``.  The
gradients' global norm under the layout (``optim.global_norm``) is held
against the norm of the reference's gradients.  The MoE configs run the
expert-parallel MoE at their ``capacity_factor`` of 1.25, whose capacity
is per member, as in the reference; at ``capacity_factor`` 64 (no row
dropped) the cross-entropy's gradients equal the port's unsharded model's
(the aux loss is averaged over the members' token slices, as the
reference's ``_moe_ep`` averages it, so it is not the unsharded model's).

The vocab-parallel loss: labels in each member's vocab block, in the
padded rows and negative, over a ragged last slab, against the plain
``chunked_cross_entropy`` on the global tensors, and (qwen with a vocab of
250, padded to 256, and a loss chunk of 6) against the reference.  The
trainer: 4 steps of ``Trainer(policy=, mesh=)`` against 4 of the
reference's ``Trainer(policy=, mesh=)`` under ``jax.set_mesh``, losses and
final parameters at the unsharded trainer test's rtol 1e-4 / atol 1e-5,
in two cases, both sequence-parallel: qwen with the clip active and an eps
of the size of the clipped gradients' elements, so that a norm that
counted a laid-out leaf's copies would change every update; and the MoE
with 2 microbatches.  The reference subprocess also writes its initial
weights, from which the port starts.  Then resuming a sharded run unsharded and back, a leaf without
a gradient, and compressed gradients under a policy (which the reference's
compressed step ignores: it raises).

The collectives' ``autograd`` rules (``core/mesh.py``, the ``reduce_nway``
Function) are held against autograd through the plain stacked ops.
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
from repro_torch.kernels.reduce_nway import reduce_nway
from repro_torch.launch.steps import make_policy
from repro_torch.models import transformer as tt
from repro_torch.models.common import chunked_cross_entropy
from repro_torch.models.convert import (from_jax_params, global_grads, laid_out_specs,
                                        reference_leaves, shard_model, unshard_tensors)
from repro_torch.models.parallel import Members
from repro_torch.optim import AdamWConfig, global_norm
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE, NAMES = (2, 4), ("data", "model")
B, S = 4, 16
ARCHS = [a for a in tconfigs.ARCH_IDS if tconfigs.get_config(a).family == "transformer"]
# loss and gradient cases: name -> (arch, seq_parallel, config overrides)
CASES = {f"{a} sp={sp}": (a, sp, {}) for a in ARCHS for sp in (False, True)}
CASES["qwen1_5_0_5b padded vocab, ragged slab"] = ("qwen1_5_0_5b", True,
                                                   {"vocab": 250, "loss_chunk": 6})
# trainer cases: name -> (arch, seq_parallel, adamw, TrainerConfig fields)
TRAINERS = {
    "qwen1_5_0_5b sp, clip active": ("qwen1_5_0_5b", True,
                                     {"lr": 1e-3, "grad_clip": 0.05, "eps": 1e-4}, {}),
    "moonshot_v1_16b sp, microbatches 2": ("moonshot_v1_16b", True, {"lr": 1e-3},
                                           {"microbatches": 2}),
}
TRAIN_STEPS = 4

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
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
    batch = {"tokens": inp[f"{name}/tokens"], "labels": inp[f"{name}/labels"]}
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
for name, (arch, sp, adamw, kw) in trainers.items():
    jc = configs.get_smoke_config(arch)
    pol = make_policy(jc, mesh, seq_parallel=sp)
    src = SyntheticLMSource(vocab=jc.vocab, seq_len=16, global_batch=4, seed=1)
    with jax.set_mesh(mesh):
        tr = Trainer(jc, TrainerConfig(adamw=AdamWConfig(**adamw), warmup=2, total_steps=10, **kw),
                     policy=pol, mesh=mesh)
        params, _ = tr.fit(src, steps=steps, resume=False)
    out[f"{name}/losses"] = np.array([m["loss"] for m in tr.metrics_log])
    flat(f"{name}/init", tr.init_state(jax.random.PRNGKey(0))[0])
    flat(f"{name}/params", params)
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def _batch(name: str):
    """Tokens and labels of a case: negative labels in row 0; for the padded
    case, labels in the padded rows too."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    cfg = _cfg(name)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.padded_vocab, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    if cfg.padded_vocab != cfg.vocab:
        labels[1, :4] = np.arange(cfg.vocab, cfg.vocab + 4)
    return tokens, labels


def _cfg(name: str):
    arch, _, over = CASES[name]
    return dataclasses.replace(tconfigs.get_smoke_config(arch), **over)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    inp = {}
    for name in CASES:
        inp[f"{name}/tokens"], inp[f"{name}/labels"] = _batch(name)
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz"),
                           json.dumps([CASES, TRAINERS, TRAIN_STEPS])],
                          capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _tree(ref: dict, prefix: str) -> dict:
    """The nested pytree of numpy arrays that ``prefix`` + keystr(path) keys hold."""
    out = {}
    for key, value in ref.items():
        if key.startswith(prefix + "["):
            parts = re.findall(r"\['([^']*)'\]", key[len(prefix):])
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
    return out


def _by_leaf(model) -> dict:
    """A model's parameters by reference leaf (layer-stacked leaves stacked)."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return {leaf: torch.stack([params[n] for n in names]) if "*" in leaf else params[names[0]]
            for leaf, names in reference_leaves(params, model.cfg).items()}


def _models(cfg, seq_parallel: bool, params=None):
    """(the unsharded model, from the reference's weights ``params`` or the
    port's seed 0, its laid-out copy, mesh, policy)."""
    model = tt.init(torch.Generator().manual_seed(0), cfg, "cpu", trainable=True) \
        if params is None else from_jax_params(params, cfg, "cpu", trainable=True)
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    sharded = shard_model(copy.deepcopy(model), mesh, policy).requires_grad_(True)
    return model, sharded, mesh, policy


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_gradients_match_the_reference(reference, case):
    cfg = _cfg(case)
    _, sharded, mesh, policy = _models(cfg, CASES[case][1], _tree(reference, f"{case}/init"))
    tokens, labels = _batch(case)
    loss = tt.loss_fn(sharded, {"tokens": _tok(tokens), "labels": _tok(labels)}, cfg, policy)
    np.testing.assert_allclose(loss.item(), float(reference[f"{case}/loss"]), **TOL)
    names = [n for n, _ in sharded.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(sharded.parameters()))))
    got = global_grads(sharded, grads)
    want = _by_leaf(from_jax_params(_tree(reference, f"{case}/grads"), cfg, "cpu"))
    assert sorted(got) == sorted(want)
    for leaf, g in got.items():
        assert g.shape == want[leaf].shape, leaf
        _close(g, want[leaf].numpy(), leaf)
    specs = laid_out_specs(sharded)
    summed = {k: M.sum_copies(g, mesh, specs[k]) for k, g in grads.items()}
    np.testing.assert_allclose(global_norm(summed, (mesh, specs)).item(),
                               float(reference[f"{case}/gnorm"]), rtol=2e-4)


@pytest.mark.parametrize("arch", ["moonshot_v1_16b", "phi3_5_moe"])
@pytest.mark.parametrize("seq_parallel", [False, True])
def test_moe_cross_entropy_gradients_without_drops_equal_the_unsharded_model(arch,
                                                                             seq_parallel):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), capacity_factor=64.0)
    model, sharded, mesh, policy = _models(cfg, seq_parallel)
    tokens = _tok(np.random.default_rng(7).integers(0, cfg.vocab, (B, S + 1)))
    hidden, _ = tt.forward(model, tokens[:, :-1], cfg)
    want_loss = chunked_cross_entropy(hidden, model.head, tokens[:, 1:], cfg)
    want = torch.autograd.grad(want_loss, list(model.parameters()))
    with mesh:
        mb = Members(policy)
        x, _ = tt._forward_tp(sharded, tokens[:, :-1], cfg, mb)
        loss = mb.backward_loss(chunked_cross_entropy(mb.gather_seq(x), sharded.head,
                                                      mb.shard_batch(tokens[:, 1:]), cfg, mb))
    np.testing.assert_allclose(loss.item(), want_loss.item(), **TOL)
    names = [n for n, _ in sharded.named_parameters()]
    got = global_grads(sharded, dict(zip(names, torch.autograd.grad(loss,
                                                                    list(sharded.parameters())))))
    want = _by_leaf(_with_params(model, want))
    for leaf, g in got.items():
        _close(g, want[leaf].numpy(), leaf)


def _with_params(model, tensors):
    """A copy of ``model`` whose parameters are ``tensors`` (in order)."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for p, t in zip(out.parameters(), tensors):
            p.copy_(t)
    return out


@pytest.mark.parametrize("seq_parallel", [False, True])
def test_vocab_parallel_loss_against_the_plain_loss(seq_parallel):
    """Labels in each member's block of the vocab, in the padded rows and
    negative, over slabs of 6 (the last ragged): every member's value is
    the plain loss of the global tensors, and the gradients of the hidden
    states and the head (their copies summed) are the plain ones."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1_5_0_5b"), vocab=250,
                              loss_chunk=6)
    V, d = cfg.padded_vocab, cfg.d_model
    gen = torch.Generator().manual_seed(3)
    hidden = torch.randn(B, S, d, generator=gen)
    head = torch.randn(V, d, generator=gen) * 0.3
    labels = torch.randint(0, V, (B, S), generator=gen)
    labels[0, :4] = torch.tensor([0, V // 4, V // 2, 3 * V // 4 + 1])  # each member's block
    labels[1, :6] = torch.arange(cfg.vocab, V)  # the padded rows
    labels[2, 5:9] = -1
    h, w = hidden.clone().requires_grad_(), head.clone().requires_grad_()
    want = chunked_cross_entropy(h, w, labels, cfg)
    want_h, want_w = torch.autograd.grad(want, (h, w))
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    hspec, wspec = (("data",), None, None), ("model", None)
    hs = M.shard(hidden, mesh, hspec).requires_grad_()
    ws = M.shard(head, mesh, wspec).requires_grad_()
    with mesh:
        mb = Members(policy)
        per_member = chunked_cross_entropy(hs, ws, mb.shard_batch(labels), cfg, mb)
        assert per_member.shape == SHAPE
        got_h, got_w = torch.autograd.grad(mb.backward_loss(per_member), (hs, ws))
    _close(per_member, np.full(SHAPE, want.item()), "loss", dict(rtol=1e-5, atol=1e-6))
    _close(M.unshard(M.sum_copies(got_h, mesh, hspec), mesh, hspec), want_h.numpy(), "hidden",
           dict(rtol=1e-5, atol=1e-6))
    _close(M.unshard(M.sum_copies(got_w, mesh, wspec), mesh, wspec), want_w.numpy(), "head",
           dict(rtol=1e-5, atol=1e-6))


def _trainer(ref, name, mesh=None, policy=None, **over):
    """The port's trainer of case ``name`` from the reference trainer's
    initial weights."""
    arch, _, adamw, kw = TRAINERS[name]
    tc = tconfigs.get_smoke_config(arch)
    init = from_jax_params(_tree(ref, f"{name}/init"), tc, "cpu")
    tcfg = TrainerConfig(adamw=AdamWConfig(**adamw), warmup=2, total_steps=10, **kw, **over)
    if mesh is None:
        return Trainer(tc, tcfg, model=init)
    return Trainer(tc, tcfg, model=init, mesh=mesh, policy=policy)


def _source(name):
    cfg = tconfigs.get_smoke_config(TRAINERS[name][0])
    return SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_sharded_trainer_matches_the_reference_trainer(reference, name):
    arch, sp = TRAINERS[name][:2]
    tc = tconfigs.get_smoke_config(arch)
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    trainer = _trainer(reference, name, mesh, make_policy(tc, mesh, seq_parallel=sp))
    model, _ = trainer.fit(_source(name), steps=TRAIN_STEPS, resume=False)
    np.testing.assert_allclose([m["loss"] for m in trainer.metrics_log],
                               reference[f"{name}/losses"], rtol=1e-5)
    got = unshard_tensors(model, dict(model.named_parameters()))
    want = from_jax_params(_tree(reference, f"{name}/params"), tc, "cpu")
    for k, w in want.named_parameters():
        _close(got[k], w.detach().numpy(), k, dict(rtol=1e-4, atol=1e-5))


def test_a_sharded_run_resumes_unsharded_and_back(reference, tmp_path):
    """2 sharded steps, a checkpoint of global leaves, 2 unsharded steps from
    it; and 2 unsharded, then 2 sharded: both equal 4 straight unsharded
    steps."""
    name = "qwen1_5_0_5b sp, clip active"
    tc = tconfigs.get_smoke_config(TRAINERS[name][0])
    src = _source(name)
    straight, _ = _trainer(reference, name).fit(src, steps=4, resume=False)
    want = {k: p.detach() for k, p in straight.named_parameters()}
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(tc, mesh, seq_parallel=True)
    for order in (("sharded", "unsharded"), ("unsharded", "sharded")):
        ckpt = tmp_path / "_".join(order)
        runs = {"sharded": lambda: _trainer(reference, name, mesh, policy, ckpt_dir=str(ckpt)),
                "unsharded": lambda: _trainer(reference, name, ckpt_dir=str(ckpt))}
        runs[order[0]]().fit(src, steps=2, resume=False)
        last = runs[order[1]]()
        model, _ = last.fit(src, steps=4)
        assert [m["step"] for m in last.metrics_log] == [3, 4], order
        got = unshard_tensors(model, dict(model.named_parameters())) \
            if order[1] == "sharded" else dict(model.named_parameters())
        for k, w in want.items():
            _close(got[k], w.numpy(), f"{order}: {k}", dict(rtol=1e-4, atol=1e-5))


def test_a_parameter_without_a_gradient_raises_under_a_policy(monkeypatch):
    tc = tconfigs.get_smoke_config("qwen1_5_0_5b")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    trainer = Trainer(tc, TrainerConfig(), mesh=mesh,
                      policy=make_policy(tc, mesh, seq_parallel=True))
    # a loss that leaves blocks.0.norm1 out of the graph
    monkeypatch.setattr(trainer, "_loss", lambda model, batch: sum(
        p.float().sum() for n, p in model.named_parameters() if n != "blocks.0.norm1"))
    with pytest.raises(RuntimeError, match=r"blocks\.0\.norm1"):
        trainer.fit(SyntheticLMSource(vocab=tc.vocab, seq_len=16, global_batch=4, seed=1),
                    steps=1, resume=False)


def test_compressed_gradients_under_a_policy_raise():
    tc = tconfigs.get_smoke_config("qwen1_5_0_5b")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Trainer(tc, TrainerConfig(compress_grads=True, dp_axis="data"), mesh=mesh,
                policy=make_policy(tc, mesh))


# ---------------------------------------------------------------------------
# The collectives' transposes on the stacked mesh
# ---------------------------------------------------------------------------

# name -> (the axis function, its plain stacked form in torch ops): x is
# (2, 4, 8, 6), d the axis' dim, n its size
def _plain_all_gather(x, d, n, tiled):
    g = x.movedim(d, 1)
    g = g.flatten(1, 2) if tiled else g
    return g.unsqueeze(d).expand(g.shape[:d] + (n,) + g.shape[d:])


COLLECTIVES = {
    "psum": (lambda x, a: M.psum(x, a),
             lambda x, d, n: x.sum(d, keepdim=True).expand(x.shape)),
    "psum_scatter": (lambda x, a: M.psum_scatter(x, a),
                     lambda x, d, n: x.sum(d).unflatten(1, (n, -1)).movedim(1, d)),
    "all_gather tiled": (lambda x, a: M.all_gather(x, a, tiled=True),
                         lambda x, d, n: _plain_all_gather(x, d, n, True)),
    "all_gather": (lambda x, a: M.all_gather(x, a, tiled=False),
                   lambda x, d, n: _plain_all_gather(x, d, n, False)),
    "all_to_all": (lambda x, a: M.all_to_all(x, a, 0, 1),
                   lambda x, d, n: x.unflatten(2, (n, -1)).transpose(d, 2)
                   .movedim(2, 3).flatten(3, 4)),
    "ppermute": (lambda x, a: M.ppermute(x, a, [(i, (i + 1) % M.axis_size(a))
                                                for i in range(M.axis_size(a))]),
                 lambda x, d, n: x.roll(1, d)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", NAMES)
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_gradients_match_autograd_through_the_plain_ops(name, axis, dtype):
    fn, plain = COLLECTIVES[name]
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    d, n = mesh.dim(axis), mesh.size(axis)
    gen = torch.Generator().manual_seed(sorted(COLLECTIVES).index(name))
    x = torch.randn(SHAPE + (8, 6), generator=gen).to(getattr(torch, dtype))
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    with mesh:
        y = fn(xa, axis)
    want_y = plain(xb, d, n)
    assert y.shape == want_y.shape and y.grad_fn is not None
    ct = torch.randn(y.shape, generator=gen).to(y.dtype)
    got, = torch.autograd.grad(y, xa, ct)
    want, = torch.autograd.grad(want_y, xb, ct)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2**-7, atol=1e-2)
    _close(y.float(), want_y.float().detach().numpy(), "forward", tol)
    _close(got.float(), want.float().numpy(), "gradient", tol)


@pytest.mark.parametrize("name", ["psum", "psum_scatter", "all_gather tiled", "all_to_all"])
def test_collective_gradients_pass_gradcheck_in_f64(name):
    fn = COLLECTIVES[name][0]
    x = torch.randn(SHAPE + (4, 2), dtype=torch.float64, requires_grad=True)
    with M.Mesh(SHAPE, NAMES, device="cpu"):
        assert torch.autograd.gradcheck(lambda t: fn(t, "model"), (x,))


def test_reduce_nway_add_carries_a_gradient_and_max_says_it_carries_none():
    x = torch.randn(5, 3, 4, requires_grad=True)
    y = reduce_nway(x, op="add", dim=1)
    g = torch.randn(5, 4)
    got, = torch.autograd.grad(y, x, g)
    assert torch.equal(got, g[:, None].expand(5, 3, 4))
    with pytest.raises(ValueError, match="no gradient"):
        reduce_nway(x, op="max", dim=1)
    with torch.no_grad():
        assert torch.equal(reduce_nway(x, op="max", dim=1), x.amax(1))
    with M.Mesh(SHAPE, NAMES, device="cpu"), pytest.raises(ValueError, match="no gradient"):
        M.pmax(torch.randn(SHAPE + (3,), requires_grad=True), "model")


def test_sum_copies_is_the_adjoint_of_shard():
    """<shard(u), v> == <u, unshard(sum_copies(v))> for a spec that leaves an
    axis unnamed, and a replicated one."""
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for spec in ((None, "model"), ()):
        u = torch.randn(6, 8, dtype=torch.float64, generator=gen)
        v = torch.randn(SHAPE + tuple(M.shard(u, mesh, spec).shape[2:]), dtype=torch.float64,
                        generator=gen)
        lhs = (M.shard(u, mesh, spec) * v).sum()
        rhs = (u * M.unshard(M.sum_copies(v, mesh, spec), mesh, spec)).sum()
        assert abs(lhs.item() - rhs.item()) < 1e-9 * abs(lhs.item()), spec
