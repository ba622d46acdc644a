"""The port's recurrentgemma hybrid against the JAX reference, on the CPU.

The smoke config of recurrentgemma-2b (3 layers: rec, rec, attn; window
8), the JAX parameters from ``PRNGKey(0)`` carried across by
``from_jax_params``: the recurrent block's pieces, ``forward``, ``prefill``
(logits and cache) and ``decode_step`` are held against the reference in
f32 at 2e-4, with the recurrence through the scan kernel's plain version
and the local attention through the flash kernel's.

Past the window the reference's prefill and decode disagree on where a
position lies in the rolling cache (ROADMAP.md queue 3): there the port is
held against the longer prefill, which does not read the cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro.runtime.server import Request as JRequest
from repro.runtime.server import Server as JServer
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import get_family
from repro_torch.models import rglru as trglru
from repro_torch.models.convert import from_jax_params
from repro_torch.runtime.server import Request, Server

ARCH = "recurrentgemma_2b"
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
    params = jrglru.init(jax.random.PRNGKey(0), jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu")
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (B, 40)).astype(np.int32)
    jprefill = jax.jit(lambda p, t, m: jrglru.prefill(p, t, jc, max_len=m), static_argnums=2)
    jdecode = jax.jit(lambda p, c, t, pos: jrglru.decode_step(p, c, t, pos, jc))
    return jc, tc, params, model, tokens, jprefill, jdecode


def _rec_params(pair):
    jc, tc, params, model, *_ = pair
    return jc, tc, params["layers"][0]["rec"], model.layers[0].mixer


def _check_cache(cache, jcache):
    for i, kind in enumerate(trglru._kinds(jconfigs.get_smoke_config(ARCH))):
        if kind == "rec":
            np.testing.assert_allclose(_np(cache.rec_h[i]), _np(jcache.rec_h[i]), **TOL)
            np.testing.assert_allclose(_np(cache.conv[i]), _np(jcache.conv[i]), **TOL)
            assert cache.attn[i] is None
        else:
            np.testing.assert_allclose(_np(cache.attn[i].k), _np(jcache.attn[i].k), **TOL)
            np.testing.assert_allclose(_np(cache.attn[i].v), _np(jcache.attn[i].v), **TOL)
            assert cache.rec_h[i] is None and cache.conv[i] is None


# -- the recurrent block ------------------------------------------------------------


def test_kinds_follow_the_reference():
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert trglru._kinds(tc) == jrglru._kinds(jc)
    assert trglru._kinds(tconfigs.get_config(ARCH)).count("rec") == 18


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    x, w = _rand(0, (B, 7, 6)), _rand(1, (4, 6))
    state = _rand(2, (B, 3, 6)) if with_state else None
    out, new = trglru._causal_conv(_t(x), _t(w), None if state is None else _t(state))
    jout, jnew = jrglru._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if state is None else jnp.asarray(state))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(new), _np(jnew), **TOL)


def test_rg_lru_coeffs_match_jax(pair):
    jc, tc, jp, tp = _rec_params(pair)
    xw = _rand(3, (B, 5, jc.lru_width))
    a, b = trglru._rg_lru_coeffs(tp, _t(xw), tc)
    ja, jb = jrglru._rg_lru_coeffs(jp, jnp.asarray(xw), jc)
    np.testing.assert_allclose(_np(a), _np(ja), **TOL)
    np.testing.assert_allclose(_np(b), _np(jb), **TOL)
    assert float(a.max()) < 1.0 and float(a.min()) > 0.0


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_matches_jax(with_h0):
    a = (1.0 / (1.0 + np.exp(-_rand(4, (B, 19, 8)) * 2))).astype(np.float32)
    b, h0 = _rand(5, (B, 19, 8)), (_rand(6, (B, 8)) if with_h0 else None)
    out = trglru._lru_scan(_t(a), _t(b), None if h0 is None else _t(h0))
    ref = jrglru._lru_scan(jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_rec_block_matches_jax(pair, with_state):
    jc, tc, jp, tp = _rec_params(pair)
    x = _rand(7, (B, 9, jc.d_model))
    state = _rand(8, (B, jc.lru_width)) if with_state else None
    conv = _rand(9, (B, jc.conv_width - 1, jc.lru_width)) if with_state else None
    out, (h, c) = trglru.rec_block(tp, _t(x), tc, None if state is None else _t(state),
                                   None if conv is None else _t(conv))
    jout, (jh, jcv) = jrglru.rec_block(jp, jnp.asarray(x), jc, state=state, conv_state=conv)
    for got, ref in ((out, jout), (h, jh), (c, jcv)):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_rec_block_decode_matches_jax(pair):
    jc, tc, jp, tp = _rec_params(pair)
    x = _rand(10, (B, 1, jc.d_model))
    state, conv = _rand(11, (B, jc.lru_width)), _rand(12, (B, jc.conv_width - 1, jc.lru_width))
    out, (h, c) = trglru.rec_block_decode(tp, _t(x), tc, _t(state), _t(conv))
    jout, (jh, jcv) = jrglru.rec_block_decode(jp, jnp.asarray(x), jc, jnp.asarray(state),
                                              jnp.asarray(conv))
    for got, ref in ((out, jout), (h, jh), (c, jcv)):
        np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_gelu_is_the_tanh_form(pair):
    """jax.nn.gelu defaults to the tanh approximation; the exact erf form
    differs by ~1e-4 here, which 2e-4 would not always catch in a block."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(_t(x), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# -- the model ----------------------------------------------------------------------


def test_forward_matches_jax(pair):
    jc, tc, params, model, tokens, *_ = pair
    hidden, aux = trglru.forward(model, _tok(tokens[:, :16]), tc)
    jhidden, _ = jax.jit(lambda p, t: jrglru.forward(p, t, jc))(params, tokens[:, :16])
    assert hidden.shape == (B, 16, jc.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(_np(hidden), _np(jhidden), **TOL)
    np.testing.assert_allclose(_np(model(_tok(tokens[:, :16]))[0]), _np(jhidden), **TOL)


@pytest.mark.parametrize("S", [6, 8, 16])
def test_prefill_and_decode_match_jax(pair, S):
    """Within one window (6, 8) and at a whole multiple of it (16), where the
    reference's rolling cache is right."""
    jc, tc, params, model, tokens, jprefill, jdecode = pair
    logits, cache = trglru.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    jlogits, jcache = jprefill(params, tokens[:, :S], S + 1)
    assert logits.shape == (B, jc.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    _check_cache(cache, jcache)
    dlogits, dcache = trglru.decode_step(model, cache, _tok(tokens[:, S:S + 1]), S, tc)
    jdlogits, jdcache = jdecode(params, jcache, tokens[:, S:S + 1], S)
    np.testing.assert_allclose(_np(dlogits), _np(jdlogits), **TOL)
    _check_cache(dcache, jdcache)


def test_decode_past_the_window_matches_the_longer_prefill(pair):
    """S = 13 > window 8: the port's decode at 13 equals a prefill of 14
    (the port's and the reference's); the reference's own decode does not."""
    jc, tc, params, model, tokens, jprefill, jdecode = pair
    S = 13
    _, cache = trglru.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + 1)
    dec, _ = trglru.decode_step(model, cache, _tok(tokens[:, S:S + 1]), S, tc)
    full, _ = trglru.prefill(model, _tok(tokens[:, :S + 1]), tc, max_len=S + 1)
    jfull, _ = jprefill(params, tokens[:, :S + 1], S + 1)
    np.testing.assert_allclose(_np(dec), _np(full), **TOL)
    np.testing.assert_allclose(_np(dec), _np(jfull), **TOL)
    _, jcache = jprefill(params, tokens[:, :S], S + 1)
    jdec, _ = jdecode(params, jcache, tokens[:, S:S + 1], S)
    assert np.abs(_np(jdec) - _np(jfull)).max() > 1e-2  # the reference caveat


def test_decode_chain_wraps_the_window(pair):
    """Prefill 5, then 20 decode steps: the rolling cache wraps twice and
    every step matches the reference's decode (right from S <= window) and
    the port's prefill of the same length."""
    jc, tc, params, model, tokens, jprefill, jdecode = pair
    S, steps = 5, 20
    _, cache = trglru.prefill(model, _tok(tokens[:, :S]), tc, max_len=S + steps)
    _, jcache = jprefill(params, tokens[:, :S], S + steps)
    for pos in range(S, S + steps):
        nxt = tokens[:, pos:pos + 1]
        logits, cache = trglru.decode_step(model, cache, _tok(nxt), pos, tc)
        jlogits, jcache = jdecode(params, jcache, nxt, pos)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        if pos % 7 == 0:
            full, _ = trglru.prefill(model, _tok(tokens[:, :pos + 1]), tc, max_len=S + steps)
            np.testing.assert_allclose(_np(logits), _np(full), **TOL)


def test_prefill_runs_the_kernels_per_layer(pair, monkeypatch):
    """Each prefill reaches the scan once per recurrent layer and the flash
    kernel once per attention layer (their plain versions, on the CPU)."""
    _, tc, _, model, tokens, *_ = pair
    calls = {"scan": 0, "flash": 0}
    scan, flash = trglru.rglru_scan, trglru.attn_mod.flash_attention

    def count(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(trglru, "rglru_scan", count("scan", scan))
    monkeypatch.setattr(trglru.attn_mod, "flash_attention", count("flash", flash))
    trglru.prefill(model, _tok(tokens[:, :10]), tc)
    assert calls == {"scan": 2, "flash": 1}


# -- parameters ---------------------------------------------------------------------


def test_init_has_the_reference_layout():
    jc, tc = jconfigs.get_smoke_config(ARCH), tconfigs.get_smoke_config(ARCH)
    jp = jax.eval_shape(lambda: jrglru.init(jax.random.PRNGKey(0), jc))
    model = trglru.init(torch.Generator().manual_seed(0), tc, "cpu")
    assert tuple(model.embed.shape) == jp["embed"].shape
    for layer, jl in zip(model.layers, jp["layers"]):
        kind = "rec" if "rec" in jl else "attn"
        assert layer.kind == kind
        for group, jgroup in (("mixer", kind), ("mlp", "mlp")):
            got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                   for k, v in getattr(layer, group).items()}
            assert got == {k: (v.shape, v.dtype.name) for k, v in jl[jgroup].items()}
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert not any(p.requires_grad for p in model.parameters())


def test_init_is_seeded_and_keeps_lambda_in_f32():
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), param_dtype=torch.bfloat16)
    a, b = (trglru.init(torch.Generator().manual_seed(3), tc, "cpu") for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert a.layers[0].mixer["lambda"].dtype == torch.float32
    assert a.layers[0].mixer["w_x"].dtype == torch.bfloat16


def test_from_jax_params_is_exact_in_bf16():
    jc = dataclasses.replace(jconfigs.get_smoke_config(ARCH), param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tconfigs.get_smoke_config(ARCH), param_dtype=torch.bfloat16)
    params = jax.tree.map(np.asarray, jrglru.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(params, tc, "cpu")
    assert model.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(model.embed.float().numpy(), params["embed"].astype(np.float32))
    rec = params["layers"][0]["rec"]
    assert model.layers[0].mixer["lambda"].dtype == torch.float32
    np.testing.assert_array_equal(model.layers[0].mixer["w_a_gate"].float().numpy(),
                                  rec["w_a_gate"].astype(np.float32))


def test_get_family_and_entry_points():
    tc = tconfigs.get_smoke_config(ARCH)
    assert get_family(tc) is trglru
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trglru.init(torch.Generator().manual_seed(0), tc)


# -- serving ------------------------------------------------------------------------


def _servers(pair, max_len=32):
    jc, tc, params, model, *_ = pair
    return JServer(jc, params, max_len=max_len), Server(tc, model, max_len=max_len, device="cpu")


def test_generate_matches_jax(pair):
    js, ts = _servers(pair)
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]
    out = ts.generate(prompts, max_new=12)  # decode wraps the window of 8
    assert out == js.generate(prompts, max_new=12)
    assert all(len(o) == 12 and all(0 <= t < ts.cfg.vocab for t in o) for o in out)


def test_serve_matches_jax_with_ragged_prompts(pair):
    js, ts = _servers(pair)
    prompts = [[i + 1, i + 2, i + 3, i + 4][: 1 + i % 4] for i in range(5)]
    treqs = ts.serve([Request(prompt=p, max_new=4) for p in prompts], batch_slots=2)
    jreqs = js.serve([JRequest(prompt=p, max_new=4) for p in prompts], batch_slots=2)
    assert all(r.done for r in treqs)
    assert [r.out for r in treqs] == [r.out for r in jreqs]


def test_serve_cli_runs_on_the_host(capsys):
    done = tserve.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                        "--max-new", "4", "--batch-slots", "2"])
    assert len(done) == 3 and all(r.done and len(r.out) == 4 for r in done)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
