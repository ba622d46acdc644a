"""The port's whisper encoder-decoder against the JAX reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch`` in f32 at
2e-4: the LayerNorm, bidirectional self-attention, cross-attention (one
query and many), the tanh-GELU MLP, and, for the whisper-base smoke
config with the reference's parameters from ``PRNGKey(0)`` carried across
by ``from_jax_params``: ``encode``, ``prefill`` (logits, self-attention
cache, memory), ``decode_step``, decode after prefill against a longer
prefill (the gate of ``tests/test_arch_smoke.py``), ``loss_fn`` and every
gradient against ``jax.value_and_grad``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import get_family
from repro_torch.models import whisper as tw
from repro_torch.models.convert import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
ARCH = "whisper_base"
B, S = 2, 16


def _rand(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _cfgs():
    return jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)


# -- blocks ------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_layer_norm_matches_jax(shift):
    """eps 1e-5, scaled by ``scale`` (not 1 + scale), in f32; bf16 in, bf16 out."""
    x, scale, bias = _rand(1, (3, 5, 64)) + shift, _rand(2, (64,)), _rand(3, (64,))
    got = tcommon.layer_norm(_t(x), _t(scale), _t(bias))
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    y = tcommon.layer_norm(_t(x).bfloat16(), torch.ones(64), torch.zeros(64))
    assert y.dtype == torch.bfloat16
    ref = jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.ones(64), jnp.zeros(64))
    np.testing.assert_allclose(_np(y), _np(ref), rtol=1e-2, atol=1e-2)


def _attn_params(seed=0):
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, jattn.init_attn_params(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_bidirectional_attention_matches_jax(n_kv):
    """No RoPE, every key visible; GQA groups as in the reference."""
    jc, tc = (dataclasses.replace(c, n_kv_heads=n_kv) for c in _cfgs())
    jp = jax.tree.map(np.asarray, jattn.init_attn_params(jax.random.PRNGKey(n_kv), jc))
    tp = {k: _t(v) for k, v in jp.items()}
    x = _rand(5, (B, 20, jc.d_model))
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (B, 20))
    out = tattn.attention(tp, _t(x), None, tc, bidirectional=True)
    ref = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), jc, bidirectional=True)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    causal = tattn.attention(tp, _t(x), torch.from_numpy(pos.copy()), tc)
    assert not np.allclose(_np(causal), _np(ref), **TOL)


@pytest.mark.parametrize("Sq", [1, 7])
def test_cross_attention_matches_jax(Sq):
    jc, tc, jp, tp = _attn_params(1)
    x, memory = _rand(6, (B, Sq, jc.d_model)), _rand(7, (B, 24, jc.d_model))
    out = tattn.cross_attention(tp, _t(x), _t(memory), tc)
    ref = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(memory), jc)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_mlp_uses_the_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation."""
    jc, tc = _cfgs()
    jp = jax.tree.map(np.asarray, jwhisper._mlp_init(jax.random.PRNGKey(0), jc))
    jp["b1"], jp["b2"] = _rand(8, jp["b1"].shape), _rand(9, jp["b2"].shape)
    x = _rand(10, (B, 5, jc.d_model), scale=2.0)
    out = tw._mlp({k: _t(v) for k, v in jp.items()}, _t(x), tc)
    ref = jwhisper._mlp(jp, jnp.asarray(x), jc, jcommon.REPLICATED)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


# -- the smoke model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jc, tc = _cfgs()
    params = jwhisper.init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
    frames = (rng.standard_normal((B, jc.encoder_len, jc.d_model)) * 0.1).astype(np.float32)
    return jc, tc, params, model, tokens, frames


def test_family_and_init_layout(pair):
    jc, tc, params, model, _, _ = pair
    assert get_family(tc) is tw
    fresh = tw.init(torch.Generator().manual_seed(0), tc, "cpu")
    for m in (model, fresh):
        assert sum(p.numel() for p in m.parameters()) == \
            sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
        assert len(m.enc_layers) == jc.encoder_layers and len(m.dec_layers) == jc.n_layers
        assert not any(p.requires_grad for p in m.parameters())
    for i, lp in enumerate(fresh.dec_layers):
        for group, d in lp.items():
            assert {k: tuple(v.shape) for k, v in d.items()} == \
                {k: v.shape[1:] for k, v in params["dec_layers"][group].items()}
    for name in ("scale", "bias"):
        np.testing.assert_array_equal(model.norms["enc_norm"][name].numpy(),
                                      np.asarray(params["enc_norm"][name]))
    assert float(fresh.enc_layers[0]["ln1"]["scale"].min()) == 1.0


def test_encode_matches_jax(pair):
    jc, tc, params, model, _, frames = pair
    memory = tw.encode(model, _t(frames), tc)
    jmemory = jax.jit(lambda p, f: jwhisper.encode(p, f, jc))(params, frames)
    assert memory.shape == (B, jc.encoder_len, jc.d_model)
    np.testing.assert_allclose(_np(memory), _np(jmemory), **TOL)


def test_prefill_and_decode_match_jax(pair):
    jc, tc, params, model, tokens, frames = pair
    batch = {"frames": frames, "tokens": tokens[:, :S]}
    logits, cache = tw.prefill(model, {"frames": _t(frames), "tokens": _tok(tokens[:, :S])},
                               tc, max_len=S + 1)
    jlogits, jcache = jax.jit(lambda p, b: jwhisper.prefill(p, b, jc, max_len=S + 1))(
        params, batch)
    assert logits.shape == (B, jc.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    np.testing.assert_allclose(_np(cache.self_kv.k), _np(jcache.self_kv.k), **TOL)
    np.testing.assert_allclose(_np(cache.self_kv.v), _np(jcache.self_kv.v), **TOL)
    np.testing.assert_allclose(_np(cache.memory), _np(jcache.memory), **TOL)

    dlogits, dcache = tw.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    jdlogits, jdcache = jax.jit(lambda p, c, t: jwhisper.decode_step(p, c, t, S, jc))(
        params, jcache, tokens[:, S:])
    np.testing.assert_allclose(_np(dlogits), _np(jdlogits), **TOL)
    np.testing.assert_allclose(_np(dcache.self_kv.k), _np(jdcache.self_kv.k), **TOL)
    np.testing.assert_allclose(_np(dcache.self_kv.v), _np(jdcache.self_kv.v), **TOL)


def test_prefill_decode_consistency(pair):
    """decode(prefill(x[:S]), x[S]) matches prefill(x[:S+1]) on the port alone."""
    _, tc, _, model, tokens, frames = pair
    fr = _t(frames)
    full, _ = tw.prefill(model, {"frames": fr, "tokens": _tok(tokens)}, tc, max_len=S + 1)
    _, cache = tw.prefill(model, {"frames": fr, "tokens": _tok(tokens[:, :S])}, tc,
                          max_len=S + 1)
    dec, _ = tw.decode_step(model, cache, _tok(tokens[:, S:]), S, tc)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL)


@pytest.fixture(scope="module")
def loss_pair(pair):
    jc, tc, params, _, _, frames = pair
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jc.vocab, (B, 40)).astype(np.int32)
    labels = rng.integers(0, jc.vocab, (B, 40)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"frames": frames, "tokens": tokens, "labels": labels}
    loss, grads = jax.value_and_grad(jwhisper.loss_fn)(
        params, jax.tree.map(jnp.asarray, batch), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu", trainable=True)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, grads), tc, "cpu")
    tbatch = {"frames": _t(frames), "tokens": _tok(tokens), "labels": _tok(labels)}
    return float(loss), ref_grads, model, tbatch


def test_loss_fn_matches_jax(loss_pair):
    ref_loss, _, model, batch = loss_pair
    tc = tconfigs.get_smoke_config(ARCH)
    np.testing.assert_allclose(tw.loss_fn(model, batch, tc).item(), ref_loss, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_gradients_match_jax(loss_pair, remat):
    """Every leaf (encoder, decoder, norms, ``enc_pos``, the tied embedding)
    within 2e-4 of its max|.|."""
    _, ref_grads, model, batch = loss_pair
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), remat=remat)
    loss = tw.loss_fn(model, batch, tc)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = dict(ref_grads.named_parameters())
    assert names == list(want) and "enc_pos" in names
    for name, g in zip(names, grads):
        w = want[name].detach()
        assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item(), name
