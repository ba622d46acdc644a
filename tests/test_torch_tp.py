"""Tensor- and expert-parallel serving of the transformer family, on the CPU.

For each of the seven transformer smoke configs (the dense yi, qwen, glm4,
gemma3, chameleon and the MoE moonshot and phi3.5-moe) the JAX parameters
from ``PRNGKey(0)`` are carried across by ``from_jax_params`` and laid out
on a stacked ``(2, 4)`` ``("data", "model")`` mesh by ``shard_model`` under
``make_policy``.  The sharded ``prefill`` (logits, and the KV cache read
back through ``cache_spec``) and a ``decode_step`` after it are held at
2e-4 against the reference's own sharded run: ``jax.jit`` of its
``prefill`` and ``decode_step`` with the policy, under ``jax.set_mesh`` on
8 spoofed XLA host devices in a subprocess (``XLA_FLAGS`` is set before
JAX loads), its parameters placed with ``NamedSharding`` by its
``param_specs``.  The MoE configs run the expert-parallel MoE at their
``capacity_factor`` of 1.25, whose capacity is per member, as in the
reference.  Against the port's own unsharded model, the MoE configs run at
``capacity_factor`` 64, where no row is dropped and the expert-parallel MoE
equals the local one.  ``Server(policy=, mesh=)`` serves the same tokens
as the reference's ``Server`` under the mesh.  A sharded model of any
family refuses to run without its policy, an unsharded one with a policy,
and sequence parallelism over another axis than the model axis.
(Sharded training, the sharded loss and sequence parallelism are held
against the reference in ``tests/test_torch_tp_train.py``; the other three
families' sharded serving and training in ``tests/test_torch_tp_families.py``
and ``tests/test_torch_tp_train_families.py``.)
"""

import copy
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

from repro import configs as jconfigs
from repro.models import get_family as jfamily
from repro_torch import configs as tconfigs
from repro_torch.core import mesh as M
from repro_torch.launch.steps import make_policy
from repro_torch.models import get_family
from repro_torch.models import transformer as tt
from repro_torch.models.convert import from_jax_params, shard_model
from repro_torch.runtime.server import Request, Server

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE, NAMES = (2, 4), ("data", "model")
B, S = 4, 16
ARCHS = [a for a in tconfigs.ARCH_IDS if tconfigs.get_config(a).family == "transformer"]
SERVED = ("yi_6b", "moonshot_v1_16b")
MAX_LEN, MAX_NEW = 32, 6
PROMPT_LENS = (5, 9, 12, 7, 11, 6)  # two waves over 4 slots: 4 requests, then 2

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch.steps import make_policy
from repro.models import get_family
from repro.runtime.server import Request, Server

inp = dict(np.load(sys.argv[1]))
archs, served, max_len, max_new = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in archs:
    jc = configs.get_smoke_config(arch)
    fam = get_family(jc)
    pol = make_policy(jc, mesh)
    params = fam.init(jax.random.PRNGKey(0), jc)
    tokens = inp["tokens"]
    S = tokens.shape[1] - 1
    with jax.set_mesh(mesh):
        placed = jax.tree.map(lambda s, a: jax.device_put(a, NamedSharding(mesh, s)),
                              fam.param_specs(jc, pol), params,
                              is_leaf=lambda x: isinstance(x, P))
        logits, cache = jax.jit(lambda p, t: fam.prefill(p, t, jc, pol, max_len=S + 1))(
            placed, tokens[:, :S])
        dlogits, dcache = jax.jit(lambda p, c, t: fam.decode_step(p, c, t, S, jc, pol))(
            placed, cache, tokens[:, S:])
        out[f"{arch}/logits"], out[f"{arch}/dlogits"] = np.asarray(logits), np.asarray(dlogits)
        out[f"{arch}/k"], out[f"{arch}/v"] = np.asarray(dcache.k), np.asarray(dcache.v)
        if arch in served:
            reqs = [Request(prompt=[int(t) for t in p[p >= 0]], max_new=max_new)
                    for p in inp["prompts"]]
            done = Server(jc, placed, max_len=max_len, policy=pol).serve(reqs, batch_slots=4)
            out[f"{arch}/served"] = np.array([r.out for r in done])
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


def _prompts():
    rng = np.random.default_rng(5)
    out = np.full((len(PROMPT_LENS), max(PROMPT_LENS)), -1, np.int64)
    for i, n in enumerate(PROMPT_LENS):
        out[i, :n] = rng.integers(0, 256, n)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    tokens = np.random.default_rng(2).integers(0, 256, (B, S + 1)).astype(np.int32)
    np.savez(d / "in.npz", tokens=tokens, prompts=_prompts())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"), str(d / "out.npz"),
                           json.dumps([ARCHS, SERVED, MAX_LEN, MAX_NEW])],
                          capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return tokens, dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, config, the unsharded model, the sharded copy, mesh, policy)."""
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jfamily(jc).init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(tc, mesh)
    sharded = shard_model(copy.deepcopy(model), mesh, policy)
    return arch, tc, model, sharded, mesh, policy


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def test_sharded_prefill_and_decode_match_the_reference(reference, pair):
    tokens, ref = reference
    arch, tc, _, sharded, mesh, policy = pair
    logits, cache = tt.prefill(sharded, _tok(tokens[:, :S]), tc, policy, max_len=S + 1)
    assert logits.shape == (B, tc.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref[f"{arch}/logits"], **TOL)
    dlogits, cache = tt.decode_step(sharded, cache, _tok(tokens[:, S:]), S, tc, policy)
    np.testing.assert_allclose(dlogits.numpy(), ref[f"{arch}/dlogits"], **TOL)
    spec = tt.cache_spec(tc, policy)
    for name in ("k", "v"):
        got = M.unshard(getattr(cache, name), mesh, spec)
        np.testing.assert_allclose(got.numpy(), ref[f"{arch}/{name}"], **TOL)


def test_sharded_passes_match_the_unsharded_model(pair):
    """Same weights, same tokens: prefill, decode and forward within 2e-4
    of the port's unsharded model (MoE without drops)."""
    arch, tc, model, sharded, _, policy = pair
    if tc.n_experts:
        tc = dataclasses.replace(tc, capacity_factor=64.0)
    tokens = _tok(np.random.default_rng(4).integers(0, tc.vocab, (B, S + 1)))
    want, cache = tt.prefill(model, tokens[:, :S], tc, max_len=S + 1)
    got, scache = tt.prefill(sharded, tokens[:, :S], tc, policy, max_len=S + 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    want = tt.decode_step(model, cache, tokens[:, S:], S, tc)[0]
    got = tt.decode_step(sharded, scache, tokens[:, S:], S, tc, policy)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    hidden, aux = tt.forward(sharded, tokens, tc, policy)
    want_hidden, _ = tt.forward(model, tokens, tc)
    np.testing.assert_allclose(hidden.numpy(), want_hidden.numpy(), **TOL)
    assert aux.shape == () and (float(aux) > 0) == bool(tc.n_experts)


def test_sharded_cache_layout_follows_kv_dims(pair):
    """The cache is split on kv heads where the model axis divides them,
    else on head_dim: (2, 4, L, B/2, S_max, kv, hd) with one of the two cut."""
    arch, tc, _, sharded, _, policy = pair
    _, cache = tt.prefill(sharded, torch.zeros((B, S), dtype=torch.int64), tc, policy)
    kv_s, hd_s = policy.kv_dims(tc.n_kv_heads, tc.head_dim)
    want = (2, 4, tc.n_layers, B // 2, S, tc.n_kv_heads // (4 if kv_s else 1),
            tc.head_dim // (4 if hd_s and not kv_s else 1))
    assert tuple(cache.k.shape) == want


@pytest.mark.parametrize("arch", SERVED)
def test_server_under_a_mesh_serves_the_reference_tokens(reference, arch):
    _, ref = reference
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    model = from_jax_params(jax.tree.map(np.asarray, jfamily(jc).init(jax.random.PRNGKey(0), jc)),
                            tc, "cpu")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    server = Server(tc, model, max_len=MAX_LEN, device="cpu", policy=make_policy(tc, mesh),
                    mesh=mesh)
    assert model.mesh is mesh
    reqs = [Request(prompt=[int(t) for t in p[p >= 0]], max_new=MAX_NEW) for p in _prompts()]
    done = server.serve(reqs, batch_slots=4)
    assert [r.out for r in done] == ref[f"{arch}/served"].tolist()


@pytest.mark.parametrize("arch", ("recurrentgemma_2b", "rwkv6_3b", "whisper_base"))
def test_a_sharded_family_refuses_what_is_not_ported(arch):
    """The other three families' sharded passes (held against the reference
    in ``tests/test_torch_tp_families.py``) refuse as the transformer's do:
    a sharded model needs its policy, an unsharded one takes none, and
    sequence parallelism over another axis than the model axis raises."""
    cfg = tconfigs.get_smoke_config(arch)
    fam = get_family(cfg)
    model = fam.init(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(cfg, mesh)
    tokens = torch.zeros((B, S), dtype=torch.int64)
    batch = {"frames": torch.zeros((B, cfg.encoder_len, cfg.d_model)), "tokens": tokens} \
        if cfg.family == "whisper" else tokens
    with pytest.raises(ValueError):  # an unsharded model cannot take a policy
        fam.prefill(model, batch, cfg, policy)
    sharded = shard_model(copy.deepcopy(model), mesh, policy)
    with pytest.raises(ValueError):  # a sharded model needs its policy
        fam.prefill(sharded, batch, cfg)
    if cfg.family != "whisper":
        with pytest.raises(ValueError):
            Server(cfg, sharded, device="cpu")._prefill(tokens)
    other = dataclasses.replace(policy, seq_axis="data")
    sharded.policy = other
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fam.prefill(sharded, batch, cfg, other)


def test_a_sharded_transformer_refuses_what_is_not_ported(pair):
    """A sharded model needs its policy and an unsharded one takes none.
    The sharded loss and sequence parallelism over the model axis, which
    raised before the training half was ported, now run: the loss is
    finite (a dense config's equal to the unsharded model's within 2e-4)
    and the prefill logits with sequence parallelism equal those without;
    sequence parallelism over another axis still raises."""
    arch, tc, model, sharded, mesh, policy = pair
    tokens = _tok(np.random.default_rng(6).integers(0, tc.vocab, (B, S)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    with torch.no_grad():
        loss = tt.loss_fn(sharded, batch, tc, policy)
        assert loss.shape == () and bool(torch.isfinite(loss))
        if not tc.n_experts:  # the MoE's aux is per member, as the reference's
            np.testing.assert_allclose(loss.item(), tt.loss_fn(model, batch, tc).item(), **TOL)
        want = tt.prefill(sharded, tokens, tc, policy)[0]
    with pytest.raises(ValueError):  # a sharded model needs its policy
        tt.prefill(sharded, tokens, tc)
    with pytest.raises(ValueError):  # and an unsharded one cannot take one
        tt.prefill(model, tokens, tc, policy)
    seq = dataclasses.replace(policy, seq_axis="model")
    other = dataclasses.replace(policy, seq_axis="data")
    try:
        sharded.policy = seq
        got = tt.prefill(sharded, tokens, tc, seq)[0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
        sharded.policy = other
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tt.prefill(sharded, tokens, tc, other)
    finally:
        sharded.policy = policy
