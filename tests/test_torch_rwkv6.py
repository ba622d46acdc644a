"""The port's RWKV-6 against the JAX reference, on the CPU.

The smoke config of rwkv6-3b (2 layers, d_model 64, head size 16, so 4
heads), the JAX parameters from ``PRNGKey(0)`` carried across by
``from_jax_params`` (layers stacked on L there, one dict per layer here):
the time mix and channel mix, ``forward``, ``prefill`` (logits, states and
token shifts) and ``decode_step`` are held against the reference in f32 at
2e-4, with the recurrence through the WKV kernel's plain version.  The
reference's prefill asserts that its chunk (64 up to 4096 tokens) divides
S; the port takes any S, held against its own decode chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rwkv6 as jrwkv
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import get_family
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import from_jax_params
from repro_torch.runtime.server import Request, Server

ARCH = "rwkv6_3b"
TOL = dict(rtol=2e-4, atol=2e-4)
B = 2


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tok(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def _rand(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jc, tc = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    params = jrwkv.init(jax.random.PRNGKey(0), jc)
    # the reference initialises the bonus to zero and the mixes to 0.5: make them count
    layers = dict(params["layers"])
    layers["bonus_u"] = jnp.asarray(_rand(90, layers["bonus_u"].shape))
    layers["mix_rkvg"] = jnp.asarray(np.random.default_rng(91).uniform(
        0, 1, layers["mix_rkvg"].shape).astype(np.float32))
    params = dict(params, layers=layers)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, 80)).astype(np.int32)
    jprefill = jax.jit(lambda p, t: jrwkv.prefill(p, t, jc))
    jdecode = jax.jit(lambda p, c, t, pos: jrwkv.decode_step(p, c, t, pos, jc))
    return jc, tc, params, model, tokens, jprefill, jdecode


def _layer(pair, i=0):
    jc, tc, params, model, *_ = pair
    return jc, tc, jax.tree.map(lambda a: a[i], params["layers"]), model.layers[i]


# -- time mix and channel mix -------------------------------------------------------


def test_heads_come_from_the_head_size():
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert trwkv._heads(tc) == jrwkv._heads(jc)
    assert trwkv._heads(tconfigs.get_config(ARCH)) == (40, 64)


def test_token_shift_matches_jax():
    x, prev = _rand(0, (B, 5, 8)), _rand(1, (B, 8))
    np.testing.assert_array_equal(_np(trwkv._token_shift(_t(x), _t(prev))),
                                  _np(jrwkv._token_shift(jnp.asarray(x), jnp.asarray(prev))))


def test_tmix_inputs_match_jax(pair):
    jc, tc, jl, tl = _layer(pair)
    x, prev = _rand(2, (B, 7, jc.d_model)), _rand(3, (B, jc.d_model))
    got = trwkv._tmix_inputs(tl, _t(x), _t(prev), tc)
    ref = jrwkv._tmix_inputs(jl, jnp.asarray(x), jnp.asarray(prev), jc)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_np(g), _np(r), **TOL)
    assert got[-1].dtype == torch.float32 and float(got[-1].max()) < 0.0


@pytest.mark.parametrize("S", [16, 64])
def test_time_mix_matches_jax(pair, S):
    """From a non-zero state and shift, as decode after prefill would see."""
    jc, tc, jl, tl = _layer(pair, 1)
    H, hd = jrwkv._heads(jc)
    x, prev = _rand(4, (B, S, jc.d_model)), _rand(5, (B, jc.d_model))
    state0 = _rand(6, (B, H, hd, hd))
    out, state, last = trwkv.time_mix(tl, _t(x), _t(prev), _t(state0), tc)
    jout, jstate, jlast = jrwkv.time_mix(jl, jnp.asarray(x), jnp.asarray(prev),
                                         jnp.asarray(state0), jc)
    for g, r in ((out, jout), (state, jstate), (last, jlast)):
        np.testing.assert_allclose(_np(g), _np(r), **TOL)


def test_channel_mix_matches_jax(pair):
    jc, tc, jl, tl = _layer(pair)
    x, prev = _rand(7, (B, 9, jc.d_model)), _rand(8, (B, jc.d_model))
    out, last = trwkv.channel_mix(tl, _t(x), _t(prev), tc)
    jout, jlast = jrwkv.channel_mix(jl, jnp.asarray(x), jnp.asarray(prev), jc,
                                    jrwkv.REPLICATED)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)


# -- the model ----------------------------------------------------------------------


def test_forward_matches_jax(pair):
    jc, tc, params, model, tokens, *_ = pair
    hidden, aux = trwkv.forward(model, _tok(tokens[:, :16]), tc)
    jhidden, _ = jax.jit(lambda p, t: jrwkv.forward(p, t, jc))(params, tokens[:, :16])
    assert hidden.shape == (B, 16, jc.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_np(hidden), _np(jhidden), **TOL)
    np.testing.assert_allclose(_np(model(_tok(tokens[:, :16]))[0]), _np(jhidden), **TOL)


@pytest.mark.parametrize("S", [16, 64])
def test_prefill_and_decode_match_jax(pair, S):
    jc, tc, params, model, tokens, jprefill, jdecode = pair
    logits, cache = trwkv.prefill(model, _tok(tokens[:, :S]), tc)
    jlogits, jcache = jprefill(params, tokens[:, :S])
    assert logits.shape == (B, jc.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    np.testing.assert_allclose(_np(cache.state), _np(jcache.state), **TOL)
    np.testing.assert_allclose(_np(cache.shift), _np(jcache.shift), **TOL)
    for pos in (S, S + 1):
        nxt = tokens[:, pos:pos + 1]
        logits, cache = trwkv.decode_step(model, cache, _tok(nxt), pos, tc)
        jlogits, jcache = jdecode(params, jcache, nxt, pos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        np.testing.assert_allclose(_np(cache.state), _np(jcache.state), **TOL)
        np.testing.assert_allclose(_np(cache.shift), _np(jcache.shift), **TOL)


@pytest.mark.parametrize("S", [16, 70])
def test_prefill_decode_consistency(pair, S):
    """decode(prefill(x[:S]), x[S]) matches prefill(x[:S+1]); at S = 70 the
    last chunk of 64 is ragged, which the reference's prefill refuses."""
    _, tc, _, model, tokens, *_ = pair
    full, _ = trwkv.prefill(model, _tok(tokens[:, :S + 1]), tc)
    _, cache = trwkv.prefill(model, _tok(tokens[:, :S]), tc)
    dec, _ = trwkv.decode_step(model, cache, _tok(tokens[:, S:S + 1]), S, tc)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL)


def test_prefill_runs_the_kernel_per_layer(pair, monkeypatch):
    _, tc, _, model, tokens, *_ = pair
    calls = []
    wkv = trwkv.wkv

    def count(*a, **kw):
        calls.append(a[0].shape)
        return wkv(*a, **kw)

    monkeypatch.setattr(trwkv, "wkv", count)
    trwkv.prefill(model, _tok(tokens[:, :10]), tc)
    assert calls == [(B, 10, 4, 16)] * tc.n_layers


# -- parameters ---------------------------------------------------------------------


def test_init_has_the_reference_layout():
    jc, tc = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    jp = jax.eval_shape(lambda: jrwkv.init(jax.random.PRNGKey(0), jc))
    model = trwkv.init(torch.Generator().manual_seed(0), tc, "cpu")
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(getattr(model, name).shape) == jp[name].shape
    for lp in model.layers:
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in lp.items()}
        assert got == {k: (v.shape[1:], v.dtype.name) for k, v in jp["layers"].items()}
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert not any(p.requires_grad for p in model.parameters())


def test_from_jax_params_is_exact_in_bf16():
    """bf16 leaves come across exactly; the f32 leaves stay f32."""
    jc = dataclasses.replace(jconfigs.get_smoke_config(ARCH), param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), param_dtype=torch.bfloat16)
    params = jax.tree.map(np.asarray, jrwkv.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(params, tc, "cpu")
    assert model.lm_head.dtype == torch.bfloat16
    for i, lp in enumerate(model.layers):
        np.testing.assert_array_equal(lp["w_r"].float().numpy(),
                                      params["layers"]["w_r"][i].astype(np.float32))
        assert lp["w_r"].dtype == torch.bfloat16 and lp["w_lora_a"].dtype == torch.float32


def test_get_family_and_entry_points():
    tc = tconfigs.get_smoke_config(ARCH)
    assert get_family(tc) is trwkv
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trwkv.init(torch.Generator().manual_seed(0), tc)


# -- serving ------------------------------------------------------------------------


def _servers(pair, max_len=48):
    jc, tc, params, model, *_ = pair
    return JServer(jc, params, max_len=max_len), Server(tc, model, max_len=max_len, device="cpu")


def test_generate_matches_jax(pair):
    js, ts = _servers(pair)
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    out = ts.generate(prompts, max_new=8)
    assert out == js.generate(prompts, max_new=8)
    assert all(len(o) == 8 and all(0 <= t < ts.cfg.vocab for t in o) for o in out)


def test_serve_matches_jax_with_ragged_prompts(pair):
    js, ts = _servers(pair)
    prompts = [[i + 1, i + 2, i + 3][: 1 + i % 3] for i in range(5)]
    treqs = ts.serve([Request(prompt=p, max_new=3 + i % 2) for i, p in enumerate(prompts)],
                     batch_slots=3)
    jreqs = js.serve([JRequest(prompt=p, max_new=3 + i % 2) for i, p in enumerate(prompts)],
                     batch_slots=3)
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_serve_cli_runs_on_the_host(capsys):
    done = tserve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                        "--max-new", "4", "--batch-slots", "2"])
    assert len(done) == 3 and all(r.done and len(r.out) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
