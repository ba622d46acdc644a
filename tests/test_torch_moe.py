"""The port's capacity-routed MoE against the JAX reference, on the CPU.

The same numpy inputs go through ``repro.models.mlp`` and
``repro_torch.models.mlp``: the capacity, the router (``gate_idx`` held
exactly as integers, ``gate_vals`` and the aux loss at 1e-6), the
dispatch indices (exactly, with drops forced by a low capacity factor)
and ``_moe_local`` with and without drops at 2e-4 in f32.  Then the
moonshot-v1-16b-a3b and phi3.5-moe smoke configs, with the reference's
parameters from ``PRNGKey(0)`` carried across by ``from_jax_params``:
``forward`` (hidden states and the summed aux), ``prefill`` (logits and
cache), ``decode_step``, decode after prefill at the reference test's
``capacity_factor=64``, ``loss_fn`` and every gradient against
``jax.value_and_grad``, and the serving loop against the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as tt
from repro_torch.models.convert import from_jax_params
from repro_torch.runtime.server import Request, Server

TOL = dict(rtol=2e-4, atol=2e-4)
MOE = ["moonshot_v1_16b", "phi3_5_moe"]
B, S = 2, 16


def _rand(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _cfgs(arch, **kw):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)


def _moe_params(arch, seed=0):
    jc, tc = _cfgs(arch)
    jp = jax.tree.map(np.asarray, jmlp.init_moe_params(jax.random.PRNGKey(seed), jc))
    return jp, {k: _t(v) for k, v in jp.items()}


# -- capacity, routing, dispatch ---------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 64.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_capacity_matches_the_reference(arch, cf):
    for get in ("get_config", "get_smoke_config"):
        jc = dataclasses.replace(getattr(jconfigs, get)(arch), capacity_factor=cf)
        tc = dataclasses.replace(getattr(tconfigs, get)(arch), capacity_factor=cf)
        for n in (1, 2, 3, 4, 7, 16, 31, 100, 2049, 8192, 8196):
            assert tmlp.moe_capacity(tc, n) == jmlp.moe_capacity(jc, n), (get, n)


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _moe_params(arch)
    xf = _rand(1, (64, jc.d_model))
    vals, idx, aux = tmlp._route(tp, _t(xf), tc)
    jvals, jidx, jaux = jmlp._route(jp, jnp.asarray(xf), jc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(vals), _np(jvals), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_route_breaks_ties_toward_the_lower_index():
    """Zero rows give uniform probabilities: jax.lax.top_k picks experts 0..K-1."""
    jc, tc = _cfgs("moonshot_v1_16b")
    jp, tp = _moe_params("moonshot_v1_16b")
    xf = np.zeros((5, jc.d_model), np.float32)
    xf[2] = _rand(3, (jc.d_model,))
    _, idx, _ = tmlp._route(tp, _t(xf), tc)
    _, jidx, _ = jmlp._route(jp, jnp.asarray(xf), jc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == list(range(tc.top_k))


@pytest.mark.parametrize("C", [1, 3, 5, 64])
def test_dispatch_indices_match_the_reference(C):
    E, T, K = 8, 32, 3
    rng = np.random.default_rng(C)
    gate_idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]).astype(np.int32)
    got = tmlp._dispatch_indices(torch.from_numpy(gate_idx).long(), E, C)
    want = jmlp._dispatch_indices(jnp.asarray(gate_idx), E, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[3]
    assert bool(keep.all()) == (C >= T)  # drops at every C below T here


@pytest.mark.parametrize("cf", [0.5, 1.25, 64.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_local_matches_the_reference(arch, cf):
    """cf 0.5 drops pairs at the capacity boundary; 64 keeps every one."""
    jc, tc = _cfgs(arch, capacity_factor=cf)
    jp, tp = _moe_params(arch)
    xf = _rand(4, (48, jc.d_model))
    out, aux = tmlp._moe_local(tp, _t(xf), tc)
    jout, jaux = jmlp._moe_local(jp, jnp.asarray(xf), jc)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)
    keep = tmlp._dispatch_indices(tmlp._route(tp, _t(xf), tc)[1], tc.n_experts,
                                  tmlp.moe_capacity(tc, 48))[3]
    if cf != 1.25:
        assert bool(keep.all()) == (cf == 64.0)


def test_moe_is_bit_equal_across_calls():
    _, tc = _cfgs("moonshot_v1_16b", capacity_factor=0.5)
    _, tp = _moe_params("moonshot_v1_16b")
    x = _t(_rand(5, (2, 24, tc.d_model)))
    a, aux_a = tmlp.moe(tp, x, tc)
    b, aux_b = tmlp.moe(tp, x, tc)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert a.shape == x.shape


# -- the smoke models --------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jtransformer.init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    return arch, jc, tc, params, model, tokens


def test_moe_params_carry_across(pair):
    _, jc, tc, params, model, _ = pair
    moe = params["layers"]["moe"]
    for i, blk in enumerate(model.blocks):
        assert blk.mlp is None and blk.moe["router"].dtype == torch.float32
        for k, v in moe.items():
            np.testing.assert_array_equal(blk.moe[k].numpy(), np.asarray(v[i]))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))


def test_forward_and_aux_match_jax(pair):
    _, jc, tc, params, model, tokens = pair
    hidden, aux = tt.forward(model, _tok(tokens[:, :S]), tc)
    jhidden, jaux = jax.jit(lambda p, t: jtransformer.forward(p, t, jc))(params, tokens[:, :S])
    np.testing.assert_allclose(_np(hidden), _np(jhidden), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_prefill_and_decode_match_jax(pair):
    _, jc, tc, params, model, tokens = pair
    logits, cache = tt.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    jlogits, jcache = jax.jit(lambda p, t: jtransformer.prefill(p, t, jc, max_len=S + 1))(
        params, tokens[:, :S])
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **TOL)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **TOL)
    dlogits, dcache = tt.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    jdlogits, jdcache = jax.jit(lambda p, c, t: jtransformer.decode_step(p, c, t, S, jc))(
        params, jcache, tokens[:, S:])
    np.testing.assert_allclose(_np(dlogits), _np(jdlogits), **TOL)
    np.testing.assert_allclose(_np(dcache.k), _np(jdcache.k), **TOL)
    np.testing.assert_allclose(_np(dcache.v), _np(jdcache.v), **TOL)


def test_decode_after_prefill_matches_jax_without_drops(pair):
    """At capacity_factor 64 (no drops, as the reference's own gate) the
    decode step after a prefill of S equals a prefill of S + 1, and both
    equal the reference's."""
    _, jc, tc, params, model, tokens = pair
    jc, tc = (dataclasses.replace(c, capacity_factor=64.0) for c in (jc, tc))
    full, _ = tt.prefill(model, _tok(tokens), tc, max_len=S + 1)
    _, cache = tt.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    dec, _ = tt.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL)
    _, jcache = jax.jit(lambda p, t: jtransformer.prefill(p, t, jc, max_len=S + 1))(
        params, tokens[:, :S])
    jdec, _ = jax.jit(lambda p, c, t: jtransformer.decode_step(p, c, t, S, jc))(
        params, jcache, tokens[:, S:])
    np.testing.assert_allclose(_np(dec), _np(jdec), **TOL)


@pytest.fixture(scope="module", params=MOE)
def loss_pair(request):
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jtransformer.init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (2, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (2, 40)).astype(np.int32)
    labels[0, :3] = -1
    loss, grads = jax.value_and_grad(jtransformer.loss_fn)(
        params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu", trainable=True)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, grads), tc, "cpu")
    batch = {"tokens": _tok(tokens), "labels": _tok(labels)}
    return arch, float(loss), ref_grads, model, batch


def test_loss_fn_matches_jax(loss_pair):
    arch, ref_loss, _, model, batch = loss_pair
    cfg = tconfigs.get_smoke_config(arch)
    np.testing.assert_allclose(tt.loss_fn(model, batch, cfg).item(), ref_loss, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_gradients_match_jax(loss_pair, remat):
    """Every leaf, the router's included, within 2e-4 of its max|.|."""
    arch, _, ref_grads, model, batch = loss_pair
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
    loss = tt.loss_fn(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = dict(ref_grads.named_parameters())
    assert names == list(want) and any(n.endswith("moe.router") for n in names)
    for name, g in zip(names, grads):
        w = want[name].detach()
        assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item(), name


# -- serving -----------------------------------------------------------------------


def test_server_serves_the_moe_like_the_reference():
    """``Server`` needs no change for the MoE: the moonshot smoke config
    serves the reference's greedy tokens over ragged waves."""
    jc, tc = jconfigs.get_smoke_config("moonshot_v1_16b"), tconfigs.get_smoke_config(
        "moonshot_v1_16b")
    params = jtransformer.init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(0, tc.vocab, n)] for n in (5, 8, 6, 7, 4)]
    js = JServer(jc, params, max_len=24)
    ts = Server(tc, model, max_len=24, device="cpu")
    jdone = js.serve([JRequest(prompt=p, max_new=6) for p in prompts], batch_slots=2)
    done = ts.serve([Request(prompt=p, max_new=6) for p in prompts], batch_slots=2)
    assert [r.out for r in done] == [r.out for r in jdone]
    assert all(r.done and len(r.out) == 6 for r in done)


def test_cli_takes_the_moe_archs_and_stops_whisper(capsys):
    done = tserve.main(["--device", "cpu", "--arch", "moonshot_v1_16b", "--requests", "2",
                        "--max-new", "3"])
    assert len(done) == 2 and all(len(r.out) == 3 for r in done)
    for main in (tserve.main, ttrain.main):
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--arch", "whisper_base"])
        assert "whisper" in capsys.readouterr().err
    for arch in MOE:
        for scale in ("smoke", "100m"):
            cfg = ttrain.scaled_config(arch, scale)
            smoke = tconfigs.get_smoke_config(arch)
            assert (cfg.n_experts, cfg.top_k) == (smoke.n_experts, smoke.top_k)
