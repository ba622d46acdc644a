"""The port's training numerics against the JAX reference, on the CPU.

* ``chunked_cross_entropy`` against the reference's (a ragged last chunk,
  ignored ``-1`` labels) at 1e-5;
* each kernel's ``autograd.Function`` (``FlashAttention``, ``RglruScan``,
  ``Wkv``): ``gradcheck`` in f64 at small shapes, and in f32 against
  autograd through the kernel's plain version at the reference tests'
  tolerances (2e-4, 1e-4, 2e-3 of max|g_plain|), ``wkv`` also at the
  model's strongest decay ``logw = -e^2``, where the sequential oracle
  decides;
* ``loss_fn`` and every parameter's gradient of the three families' smoke
  configs in f32 against ``jax.value_and_grad`` of the reference
  ``loss_fn``, with the reference's weights carried by ``from_jax_params``
  and its gradient tree mapped by the same converter: the loss within 1e-5
  relative, each leaf within 2e-4 of max|g_ref|.  With rwkv6's decay at
  ``-e^2`` the reference's chunked wkv is NaN; there the port is held
  against itself with ``wkv`` replaced by the f64 sequential oracle.
"""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import get_family as jfamily
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.kernels.rglru import RglruScan, rglru_scan
from repro_torch.kernels.rwkv6 import Wkv, wkv
from repro_torch.models import common as tcommon
from repro_torch.models import get_family as tfamily
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.convert import from_jax_params

ARCHS = ["qwen1_5_0_5b", "recurrentgemma_2b", "rwkv6_3b"]


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# chunked_cross_entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk", [(20, 8), (16, 16), (7, 16), (24, 5)])
def test_chunked_cross_entropy_matches_reference(S, chunk):
    B, D, V = 2, 12, 40
    hidden, head = _rand(0, (B, S, D)), _rand(1, (V, D), 0.3)
    labels = np.random.default_rng(2).integers(0, V, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -2:] = -1
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen1_5_0_5b"), loss_chunk=chunk)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1_5_0_5b"), loss_chunk=chunk)
    ref = jcommon.chunked_cross_entropy(jnp.asarray(hidden), jnp.asarray(head),
                                        jnp.asarray(labels), jcfg)
    got = tcommon.chunked_cross_entropy(_t(hidden), _t(head), torch.from_numpy(labels), tcfg)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_chunked_cross_entropy_gradients_and_all_ignored():
    """The checkpointed chunks give the gradients of the whole-sequence loss,
    and a batch whose labels are all ignored gives 0 (count clamped to 1)."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config("qwen1_5_0_5b"), loss_chunk=6)
    hidden = _t(_rand(3, (2, 15, 8))).requires_grad_()
    head = _t(_rand(4, (30, 8), 0.3)).requires_grad_()
    labels = torch.from_numpy(np.random.default_rng(5).integers(-1, 30, (2, 15)))
    got = torch.autograd.grad(tcommon.chunked_cross_entropy(hidden, head, labels, cfg),
                              (hidden, head))
    valid = labels >= 0
    logits = hidden @ head.T
    whole = torch.nn.functional.cross_entropy(logits[valid], labels[valid])
    want = torch.autograd.grad(whole, (hidden, head))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    none = torch.full((2, 15), -1)
    assert tcommon.chunked_cross_entropy(hidden, head, none, cfg).item() == 0.0


def test_maybe_remat_gives_the_same_gradients():
    cfg = tconfigs.get_smoke_config("qwen1_5_0_5b")
    fam = tfamily(cfg)
    gen = torch.Generator().manual_seed(0)
    model = fam.init(gen, cfg, "cpu", trainable=True)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        loss = fam.loss_fn(model, batch, c)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    for a, b in zip(grads[False], grads[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_models_are_frozen_unless_built_trainable():
    cfg = tconfigs.get_smoke_config("rwkv6_3b")
    gen = torch.Generator().manual_seed(0)
    assert not any(p.requires_grad for p in tfamily(cfg).init(gen, cfg, "cpu").parameters())
    assert all(p.requires_grad for p in tfamily(cfg).init(gen, cfg, "cpu", True).parameters())


# ---------------------------------------------------------------------------
# The kernels' autograd.Functions
# ---------------------------------------------------------------------------


def _f64(*shapes, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=g, dtype=torch.float64) * scale).requires_grad_()
            for s in shapes]


@pytest.mark.parametrize("window", [0, 3])
def test_flash_attention_gradcheck_f64(window):
    q, k, v = _f64((3, 9, 4), (3, 9, 4), (3, 9, 4))
    assert torch.autograd.gradcheck(lambda *x: FlashAttention.apply(*x, window, None), (q, k, v))


def test_flash_attention_backward_slices_bh(monkeypatch):
    """The backward works in slices of BH; one head at a time gives the same."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (_t(_rand(i, (5, 12, 8))).requires_grad_() for i in range(3))
    g = _t(_rand(9, (5, 12, 8)))
    whole = torch.autograd.grad(flash_attention(q, k, v, window=4), (q, k, v), g)
    monkeypatch.setattr(fa, "GRAD_SCORES", 12 * 12)
    sliced = torch.autograd.grad(flash_attention(q, k, v, window=4), (q, k, v), g)
    for a, b in zip(whole, sliced):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rglru_scan_gradcheck_f64():
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 11, 5, generator=g, dtype=torch.float64).requires_grad_()
    b = torch.randn(2, 11, 5, generator=g, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(RglruScan.apply, (a, b))


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("S", [7, 19, 33])
def test_wkv_gradcheck_f64(S, with_state0):
    r, k, v = _f64((1, S, 2, 4), (1, S, 2, 4), (1, S, 2, 4), seed=S)
    g = torch.Generator().manual_seed(S + 1)
    logw = (-torch.exp(torch.rand(1, S, 2, 4, generator=g, dtype=torch.float64) * 4 - 2)
            ).requires_grad_()
    u = _f64((2, 4), seed=S + 2)[0]
    if with_state0:
        s0 = _f64((1, 2, 4, 4), seed=S + 3)[0]
        assert torch.autograd.gradcheck(Wkv.apply, (r, k, v, logw, u, s0))
    else:
        assert torch.autograd.gradcheck(lambda *x: Wkv.apply(*x, None), (r, k, v, logw, u))


def _plain_grads(fn, inputs, grads_out):
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, grads_out)


def _check_grads(got, want, tol):
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= tol * scale, ((g - w).abs().max().item(), scale)


@pytest.mark.parametrize("window", [0, 6])
def test_flash_attention_grads_f32(window):
    q, k, v = (_t(_rand(i, (4, 24, 16))).requires_grad_() for i in range(3))
    g = _t(_rand(7, (4, 24, 16)))
    out = flash_attention(q, k, v, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), g)
    want = _plain_grads(lambda *x: kref.flash_attention_ref(*x, window=window), (q, k, v), (g,))
    _check_grads(got, want, 2e-4)


def test_rglru_scan_grads_f32():
    a = _t(np.random.default_rng(0).random((2, 40, 6)) ** 0.1).requires_grad_()
    b = _t(_rand(1, (2, 40, 6))).requires_grad_()
    g = _t(_rand(2, (2, 40, 6)))
    out = rglru_scan(a, b)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (a, b), g)
    _check_grads(got, _plain_grads(kref.rglru_scan_ref, (a, b), (g,)), 1e-4)


@pytest.mark.parametrize("decay", ["range", "strongest"])
def test_wkv_grads_f32(decay):
    B, S, H, hd = 2, 45, 2, 8
    r, k, v = (_t(_rand(i, (B, S, H, hd))).requires_grad_() for i in range(3))
    if decay == "range":  # log-uniform over the model's range [-e^2, -e^-20]
        lw = -np.exp(np.random.default_rng(3).random((B, S, H, hd)) * 22 - 20)
    else:
        lw = np.full((B, S, H, hd), -math.e ** 2)
    logw = _t(lw).requires_grad_()
    u = _t(_rand(4, (H, hd), 0.5)).requires_grad_()
    s0 = _t(_rand(5, (B, H, hd, hd))).requires_grad_()
    g_out, g_state = _t(_rand(6, (B, S, H, hd))), _t(_rand(7, (B, H, hd, hd)))
    out, state = wkv(r, k, v, logw, u, s0)
    assert out.grad_fn is not None and state.grad_fn is not None
    inputs = (r, k, v, logw, u, s0)
    got = torch.autograd.grad((out, state), inputs, (g_out, g_state))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    want = _plain_grads(kref.wkv_ref, inputs, (g_out, g_state))
    _check_grads(got, want, 2e-3)
    # the sequential oracle in f64 decides
    want64 = _plain_grads(kref.wkv_ref, [t.double() for t in inputs],
                          (g_out.double(), g_state.double()))
    _check_grads(got, [w.float() for w in want64], 2e-3)
    # the final state's gradient may be absent
    out_only = torch.autograd.grad(wkv(r, k, v, logw, u, s0)[0], inputs, g_out)
    _check_grads(out_only, _plain_grads(lambda *x: kref.wkv_ref(*x)[0], inputs, (g_out,)), 2e-3)


@pytest.mark.parametrize("S", [16, 37, 64])
def test_wkv_chunked_ref_equals_the_sequential_oracle(S):
    B, H, hd = 2, 3, 8
    r, k, v = (_t(_rand(10 + i, (B, S, H, hd))) for i in range(3))
    logw = _t(-np.exp(np.random.default_rng(13).random((B, S, H, hd)) * 22 - 20))
    logw[:, : S // 2] = -math.e ** 2
    u, s0 = _t(_rand(14, (H, hd))), _t(_rand(15, (B, H, hd, hd)))
    want_out, want_state = kref.wkv_ref(r, k, v, logw, u, s0)
    got_out, got_state = kref.wkv_chunked_ref(r, k, v, logw, u, s0)
    assert _rel(got_out, want_out) < 1e-5 and _rel(got_state, want_state) < 1e-5


# ---------------------------------------------------------------------------
# loss_fn and its gradients, whole models
# ---------------------------------------------------------------------------


def _batch(vocab, S, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (2, S)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


def _tbatch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    """(arch, reference loss and grads, port model) on one batch whose S is
    no whole multiple of the loss chunk of 16."""
    arch = request.param
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jfamily(jc).init(jax.random.PRNGKey(0), jc)
    S = 32 if arch == "rwkv6_3b" else 40  # the reference's chunked wkv divides S
    tokens, labels = _batch(jc.vocab, S)
    loss, grads = jax.value_and_grad(jfamily(jc).loss_fn)(
        params, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}, jc)
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu", trainable=True)
    ref_grads = from_jax_params(jax.tree.map(np.asarray, grads), tc, "cpu")
    return arch, float(loss), ref_grads, model, _tbatch(tokens, labels)


def test_loss_fn_matches_reference(loss_pair):
    arch, ref_loss, _, model, batch = loss_pair
    cfg = tconfigs.get_smoke_config(arch)
    loss = tfamily(cfg).loss_fn(model, batch, cfg)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_gradients_match_reference(loss_pair, remat):
    arch, _, ref_grads, model, batch = loss_pair
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), remat=remat)
    loss = tfamily(cfg).loss_fn(model, batch, cfg)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    want = dict(ref_grads.named_parameters())
    assert names == list(want)
    for name, g in zip(names, grads):
        w = want[name].detach()
        scale = w.abs().max().item()
        assert (g - w).abs().max().item() <= 2e-4 * scale, name


def test_rwkv6_strongest_decay_against_the_f64_oracle():
    """At w0 = 2 every logw is -e^2: the reference's chunked wkv is NaN,
    and the port's loss and gradients (kernel forward, chunked plain
    backward) equal those with ``wkv`` replaced by the sequential oracle
    in f64."""
    arch = "rwkv6_3b"
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = jfamily(jc).init(jax.random.PRNGKey(1), jc)
    params["layers"]["w0"] = jnp.full_like(params["layers"]["w0"], 2.0)
    tokens, labels = _batch(jc.vocab, 32, seed=1)
    ref_loss = jfamily(jc).loss_fn(params, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels)}, jc)
    assert np.isnan(float(ref_loss))
    model = from_jax_params(jax.tree.map(np.asarray, params), tc, "cpu", trainable=True)
    batch = _tbatch(tokens, labels)

    def value_and_grads():
        loss = tfamily(tc).loss_fn(model, batch, tc)
        return loss.item(), torch.autograd.grad(loss, list(model.parameters()))

    loss, grads = value_and_grads()

    def oracle(r, k, v, logw, u, state0=None):
        out, state = kref.wkv_ref(r.double(), k.double(), v.double(), logw.double(),
                                  u.double(), None if state0 is None else state0.double())
        return out.to(r.dtype), state.float()

    with mock.patch.object(trwkv, "wkv", oracle):
        want_loss, want = value_and_grads()
    assert math.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    for (name, _), g, w in zip(model.named_parameters(), grads, want):
        assert bool(torch.isfinite(g).all()), name
        assert (g - w).abs().max().item() <= 2e-4 * w.abs().max().item(), name


@pytest.mark.parametrize("B,H,Hkv", [(1, 4, 4), (1, 4, 2), (3, 4, 1)])
def test_causal_flash_hands_the_kernel_contiguous_heads(monkeypatch, B, H, Hkv):
    """The kernel needs contiguous (B * H, S, hd) operands; at B = 1 a reshape
    of the transposed heads alone would hand it a strided view."""
    from repro_torch.models import attention as attn_mod

    seen = []

    def spy(q, k, v, *, window=0):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return kref.flash_attention_ref(q, k, v, window=window)

    monkeypatch.setattr(attn_mod, "flash_attention", spy)
    q, k = torch.randn(B, 8, H, 16), torch.randn(B, 8, Hkv, 16)
    out = attn_mod._causal_flash(q, k, k, 0)
    assert seen == [True] and out.shape == (B, 8, H * 16)
