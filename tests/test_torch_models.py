"""The port's model building blocks against the JAX reference, on the CPU.

Config records, RoPE, the RMS norm, the dense MLP, self-attention (through
the flash kernel's plain version here) and one-token decode attention, each
fed the same numpy inputs as its JAX body, in f32 at 2e-4.
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
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import get_family
from repro_torch.models import mlp as tmlp
from repro_torch.models import rglru as trglru
from repro_torch.models import rope as trope
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttransformer
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import from_jax_params

TOL = dict(rtol=2e-4, atol=2e-4)
DENSE = [a for a in tconfigs.ARCH_IDS if tconfigs.get_config(a).family == "transformer"]


def _rand(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _dtype_name(dt):
    return str(dt).rsplit(".", 1)[-1] if isinstance(dt, torch.dtype) else np.dtype(dt).name


# -- configs --------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_config_records_equal_the_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    jc, tc = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name.endswith("_dtype"):
            assert _dtype_name(a) == _dtype_name(b), f.name
        else:
            assert a == b, f.name
    assert (tc.head_dim, tc.q_per_kv, tc.padded_vocab, tc.n_params) == \
        (jc.head_dim, jc.q_per_kv, jc.padded_vocab, jc.n_params)


def test_config_aliases_and_waiting_archs():
    """Every arch of the reference is ported, in its order and with equal
    records: none waits."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.WAITING == [] and tapi._WAITING == ()
    assert tconfigs.ALIASES == jconfigs.ALIASES
    for alias, arch in tconfigs.ALIASES.items():
        assert tconfigs.get_config(alias) is tconfigs.get_config(arch)
    jall, tall = jconfigs.all_configs(), tconfigs.all_configs()
    assert list(tall) == list(jall)
    for arch, jc in jall.items():
        tc = tall[arch]
        for f in dataclasses.fields(jc):
            if not f.name.endswith("_dtype"):
                assert getattr(tc, f.name) == getattr(jc, f.name), (arch, f.name)
        assert (tc.n_params, tc.n_active_params) == (jc.n_params, jc.n_active_params), arch
    assert tconfigs.get_smoke_config("phi3.5-moe-42b-a6.6b").n_experts == 4
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("no_such_arch")


@pytest.mark.parametrize("family,module", [("transformer", ttransformer),
                                           ("rglru_hybrid", trglru), ("rwkv6", trwkv),
                                           ("whisper", twhisper)])
def test_get_family_returns_every_family(family, module):
    """Every family of the reference returns the port's module."""
    assert get_family(family) is module
    assert get_family(tconfigs.get_config("yi_6b")) is ttransformer


@pytest.mark.parametrize("arch", DENSE)
def test_layer_windows_match(arch):
    for get in ("get_config", "get_smoke_config"):
        assert ttransformer.layer_windows_list(getattr(tconfigs, get)(arch)) == \
            jtransformer.layer_windows_list(getattr(jconfigs, get)(arch))


# -- primitives -----------------------------------------------------------------


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
@pytest.mark.parametrize("hd", [16, 32])
def test_rope_matches_jax(hd, theta):
    x = _rand(0, (2, 7, 3, hd))
    pos = np.random.default_rng(1).integers(0, 50, (2, 7)).astype(np.int32)
    out = trope.apply_rope(_t(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(_np(out), _np(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                                              theta)), **TOL)


def test_rope_rotates_halves_not_pairs():
    """Position 1 rotates (x1, x2) = halves of the head dim, not interleaved pairs."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0  # first element of the first half
    out = trope.apply_rope(x, torch.tensor([[1]]), theta=1.0)
    assert abs(out[..., 2].item() - np.sin(1.0)) < 1e-6  # lands in the second half
    assert out[..., 1].item() == 0.0


def test_rms_norm_matches_jax():
    x, scale = _rand(2, (3, 5, 64)), _rand(3, (64,))
    np.testing.assert_allclose(
        _np(tcommon.rms_norm(_t(x), _t(scale), 1e-6)),
        _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **TOL)
    # zero scales leave a unit-RMS output (the scales multiply by 1 + scale)
    y = tcommon.rms_norm(_t(x), torch.zeros(64))
    np.testing.assert_allclose(y.pow(2).mean(-1).numpy(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("arch", ["yi_6b", "qwen1_5_0_5b"])
def test_mlp_matches_jax(arch):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = _tree_np(jmlp.init_mlp_params(jax.random.PRNGKey(0), jc))
    x = _rand(4, (2, 5, jc.d_model))
    out = tmlp.mlp({k: _t(v) for k, v in params.items()}, _t(x), tc)
    np.testing.assert_allclose(_np(out), _np(jmlp.mlp(params, jnp.asarray(x), jc)), **TOL)


# -- attention ------------------------------------------------------------------


def _attn_params(arch, seed=0, bias=False):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    params = _tree_np(jattn.init_attn_params(jax.random.PRNGKey(seed), jc))
    if bias:  # the reference initialises the biases to zero: make them count
        for i, name in enumerate(("bq", "bk", "bv")):
            params[name] = _rand(50 + i, params[name].shape)
    return jc, tc, params, {k: _t(v) for k, v in params.items()}


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("arch", ["yi_6b", "qwen1_5_0_5b", "glm4_9b", "gemma3_12b"])
def test_attention_matches_jax(arch, window):
    """GQA with n_kv 1 (yi, glm4), 2 (gemma3) and 4 = n_heads (qwen, with qkv biases)."""
    jc, tc, jp, tp = _attn_params(arch, bias=arch == "qwen1_5_0_5b")
    B, S = 2, 24
    x = _rand(5, (B, S, jc.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    out = tattn.attention(tp, _t(x), torch.from_numpy(pos.copy()), tc, window=window)
    ref = jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), jc, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("window,pos", [(0, 0), (0, 11), (4, 11)])
@pytest.mark.parametrize("arch", ["yi_6b", "qwen1_5_0_5b"])
def test_attention_decode_matches_jax(arch, window, pos):
    jc, tc, jp, tp = _attn_params(arch, bias=arch == "qwen1_5_0_5b")
    B, S_max = 2, 16
    shape = (B, S_max, jc.n_kv_heads, jc.head_dim)
    k, v = _rand(7, shape), _rand(8, shape)
    x = _rand(9, (B, 1, jc.d_model))
    out, cache = tattn.attention_decode(tp, _t(x), tattn.KVCache(_t(k), _t(v)), pos, tc,
                                        window=window)
    jout, jcache = jattn.attention_decode(jp, jnp.asarray(x),
                                          jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                                          pos, jc, window=window)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(cache.k), _np(jcache.k), **TOL)
    np.testing.assert_allclose(_np(cache.v), _np(jcache.v), **TOL)


def test_causal_window_mask_matches_jax():
    for Sq, Sk, window, offset in [(5, 5, 0, 0), (6, 6, 3, 0), (1, 9, 4, 8)]:
        np.testing.assert_array_equal(
            tattn.causal_window_mask(Sq, Sk, window, offset).numpy(),
            np.asarray(jattn.causal_window_mask(Sq, Sk, window, offset)))


def test_bf16_logits_are_not_ported():
    """Under its old name: ``attn_bf16_logits`` is ported now.  A model
    builds with it, and causal attention with bf16 logits (the plain
    bf16-logit path, windowed too) equals the reference's within 2e-2 of
    max|out|, the reference's bf16 tolerance."""
    tc = dataclasses.replace(tconfigs.get_smoke_config("yi_6b"), attn_bf16_logits=True)
    ttransformer.init(torch.Generator().manual_seed(0), tc, "cpu")
    jc, _, jp, tp = _attn_params("yi_6b")
    jc = dataclasses.replace(jc, attn_bf16_logits=True)
    B, S = 2, 24
    x = _rand(5, (B, S, jc.d_model))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for window in (0, 8):
        out = _np(tattn.attention(tp, _t(x), torch.from_numpy(pos.copy()), tc, window=window))
        ref = _np(jattn.attention(jp, jnp.asarray(x), jnp.asarray(pos), jc, window=window))
        assert np.abs(out - ref).max() <= 2e-2 * np.abs(ref).max()


# -- parameters -----------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_init_has_the_reference_layout(arch):
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    jp = jax.eval_shape(lambda: jtransformer.init(jax.random.PRNGKey(0), jc))
    model = ttransformer.init(torch.Generator().manual_seed(0), tc, "cpu")
    assert tuple(model.embed.shape) == jp["embed"].shape
    assert ("lm_head" in jp) == (model.lm_head is not None)
    groups = ("attn", "moe" if tc.n_experts else "mlp")
    assert set(jp["layers"]) == {"norm1", "norm2", *groups}
    for blk in model.blocks:
        for group in groups:
            assert {k: tuple(v.shape) for k, v in getattr(blk, group).items()} == \
                {k: v.shape[1:] for k, v in jp["layers"][group].items()}
        assert float(blk.norm1.abs().sum()) == 0.0 and float(blk.norm2.abs().sum()) == 0.0
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    assert not any(p.requires_grad for p in model.parameters())


def test_init_is_seeded():
    tc = tconfigs.get_smoke_config("yi_6b")
    a, b = (ttransformer.init(torch.Generator().manual_seed(3), tc, "cpu") for _ in range(2))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_from_jax_params_is_exact_in_bf16():
    """ml_dtypes.bfloat16 leaves go through float32 and back without change."""
    jc = dataclasses.replace(jconfigs.get_smoke_config("qwen1_5_0_5b"),
                             param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(tconfigs.get_smoke_config("qwen1_5_0_5b"),
                             param_dtype=torch.bfloat16)
    params = _tree_np(jtransformer.init(jax.random.PRNGKey(0), jc))
    model = from_jax_params(params, tc, "cpu")
    assert model.embed.dtype == torch.bfloat16 and model.lm_head is None  # tied
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  params["embed"].astype(np.float32))
    wq = params["layers"]["attn"]["wq"]
    for i, blk in enumerate(model.blocks):
        np.testing.assert_array_equal(blk.attn["wq"].float().numpy(), wq[i].astype(np.float32))


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the entry points take it")
    tc = tconfigs.get_smoke_config("yi_6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttransformer.init(torch.Generator().manual_seed(0), tc)
    params = _tree_np(jtransformer.init(jax.random.PRNGKey(0), jconfigs.get_smoke_config("yi_6b")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params(params, tc)
