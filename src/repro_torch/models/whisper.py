"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port's counterpart of ``src/repro/models/whisper.py``.  The conv
frontend is a stub, as in the reference: the encoder takes precomputed
frame embeddings (B, encoder_len, d_model).  Pre-LN layers with LayerNorm
(``models/common.py:layer_norm``, eps 1e-5, computed in f32) and
non-gated MLPs with the tanh-approximated GELU (``jax.nn.gelu``'s
default).  The encoder adds a learned ``enc_pos`` and runs bidirectional
self-attention (plain: the flash kernel is causal-only); the decoder
applies RoPE in its causal self-attention, which goes through the flash
kernel (``models/attention.py:self_attention``), then cross-attends to
the encoder's output (plain, unmasked).  Logits are f32 over the tied
``dec_embed``.

The model is an ``nn.Module`` of per-layer parameter dicts, run by Python
loops where the reference scans its layers stacked on L.  ``prefill``
takes ``{"frames", "tokens"}`` and returns the last token's logits and a
``WhisperCache``; ``decode_step`` writes the self-attention cache in place
and recomputes the cross-attention K and V from ``memory`` every step, as
the reference does.  The reference's ``Server`` passes a token array to
``prefill``, which whisper's ``prefill`` does not take, so whisper is
driven through ``prefill`` and ``decode_step`` directly, not served.

``param_specs`` (with ``_mlp_specs``) gives each parameter's layout under
a ``ShardingPolicy`` by the port's names (``enc_layers.*.attn.wq``,
``norms.enc_norm.scale``, ...).  Whisper's sharded execution is not
ported yet (ROADMAP.md): its passes raise on a sharded policy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    REPLICATED,
    ModelConfig,
    ShardingPolicy,
    check_supported,
    chunked_cross_entropy,
    dense_init,
    embed_init,
    layer_norm,
    maybe_remat,
    param,
    resolve_device,
)
from repro_torch.models.parallel import model_axis_raise


class WhisperCache(NamedTuple):
    self_kv: KVCache       # (L, B, S_max, kv, hd)
    memory: torch.Tensor   # (B, enc_len, d) encoded audio


def _params(tree: dict) -> nn.ModuleDict:
    """A dict of dicts of tensors as a ModuleDict of frozen ParameterDicts."""
    return nn.ModuleDict({k: nn.ParameterDict({n: param(t) for n, t in v.items()})
                          for k, v in tree.items()})


class Whisper(nn.Module):
    """The parameters of one model; the passes are the module functions below.

    ``enc_layers`` / ``dec_layers`` are per-layer dicts with the reference's
    keys (``ln1``, ``ln2``[, ``ln3``], ``attn`` or ``self_attn`` and
    ``cross_attn``, ``mlp``); the norms are ``{"scale", "bias"}`` dicts.
    """

    def __init__(self, cfg: ModelConfig, enc_pos, dec_embed, enc_layers: list[dict],
                 dec_layers: list[dict], enc_norm: dict, dec_norm: dict,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        if cfg.family != "whisper":
            raise ValueError(f"a whisper model from a {cfg.family!r} config")
        if len(enc_layers) != (cfg.encoder_layers or cfg.n_layers) or \
                len(dec_layers) != cfg.n_layers:
            raise ValueError(f"{len(enc_layers)} / {len(dec_layers)} layers for "
                             f"{cfg.encoder_layers} / {cfg.n_layers}")
        self.cfg = cfg
        self.enc_pos = param(enc_pos)
        self.dec_embed = param(dec_embed)
        self.enc_layers = nn.ModuleList(_params(lp) for lp in enc_layers)
        self.dec_layers = nn.ModuleList(_params(lp) for lp in dec_layers)
        self.norms = _params({"enc_norm": enc_norm, "dec_norm": dec_norm})
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.dec_embed.device


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _mlp_init(gen, cfg: ModelConfig, device) -> dict:
    return {
        "w1": dense_init(gen, (cfg.d_model, cfg.d_ff), cfg.param_dtype, device),
        "b1": torch.zeros((cfg.d_ff,), dtype=cfg.param_dtype, device=device),
        "w2": dense_init(gen, (cfg.d_ff, cfg.d_model), cfg.param_dtype, device),
        "b2": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device),
    }


def _ln_init(cfg: ModelConfig, device) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32, device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device)}


def init(gen: torch.Generator, cfg: ModelConfig, device=None,
         trainable: bool = False) -> Whisper:
    """Random weights drawn from ``gen`` on ``device`` (None means CUDA, and
    raises without a card), requiring gradients when ``trainable``."""
    device = resolve_device(device)
    n_enc = cfg.encoder_layers or cfg.n_layers
    enc_pos = (torch.randn((cfg.encoder_len, cfg.d_model), generator=gen, device=device)
               * 0.02).to(cfg.param_dtype)
    dec_embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    enc_layers = [{"ln1": _ln_init(cfg, device), "ln2": _ln_init(cfg, device),
                   "attn": attn_mod.init_attn_params(gen, cfg, device),
                   "mlp": _mlp_init(gen, cfg, device)} for _ in range(n_enc)]
    dec_layers = [{"ln1": _ln_init(cfg, device), "ln2": _ln_init(cfg, device),
                   "ln3": _ln_init(cfg, device),
                   "self_attn": attn_mod.init_attn_params(gen, cfg, device),
                   "cross_attn": attn_mod.init_attn_params(gen, cfg, device),
                   "mlp": _mlp_init(gen, cfg, device)} for _ in range(cfg.n_layers)]
    return Whisper(cfg, enc_pos, dec_embed, enc_layers, dec_layers, _ln_init(cfg, device),
                   _ln_init(cfg, device), trainable)


def _mlp_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    return {
        "w1": policy.w_col(cfg.d_ff),
        "b1": (policy._model_if_divisible(cfg.d_ff),),
        "w2": policy.w_row(cfg.d_ff),
        "b2": (None,),
    }


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each parameter's spec under ``policy``, by reference leaf: per-layer
    specs for the layers the reference stacks on L."""
    ln = {"scale": (None,), "bias": (None,)}
    attn = attn_mod.attn_param_specs(cfg, policy)
    enc = {"ln1": ln, "ln2": ln, "attn": attn, "mlp": _mlp_specs(cfg, policy)}
    dec = {"ln1": ln, "ln2": ln, "ln3": ln, "self_attn": attn, "cross_attn": attn,
           "mlp": _mlp_specs(cfg, policy)}
    specs = {"enc_pos": (None, None), "dec_embed": policy.embed(cfg.padded_vocab)}
    for stack, layer in (("enc_layers", enc), ("dec_layers", dec)):
        for group, leaves in layer.items():
            specs.update({f"{stack}.*.{group}.{k}": v for k, v in leaves.items()})
    for norm in ("enc_norm", "dec_norm"):
        specs.update({f"norms.{norm}.{k}": v for k, v in ln.items()})
    return specs


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def _mlp(p, x, cfg: ModelConfig):
    cd = cfg.compute_dtype
    h = F.gelu(x @ p["w1"].to(cd) + p["b1"].to(cd), approximate="tanh")
    return h @ p["w2"].to(cd) + p["b2"].to(cd)


def _enc_layer(lp, x, cfg: ModelConfig):
    h = _ln(x, lp["ln1"])
    x = x + attn_mod.attention(lp["attn"], h, None, cfg, bidirectional=True)
    return x + _mlp(lp["mlp"], _ln(x, lp["ln2"]), cfg)


def encode(model: Whisper, frames, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """frames: (B, enc_len, d_model) precomputed conv-frontend embeddings."""
    model_axis_raise("whisper", policy, model)
    cd = cfg.compute_dtype
    x = frames.to(cd) + model.enc_pos.to(cd)[None]
    layer = maybe_remat(_enc_layer, cfg.remat)
    for lp in model.enc_layers:
        x = layer(lp, x, cfg)
    return _ln(x, model.norms["enc_norm"])


def _dec_layer(lp, x, positions, memory, cfg: ModelConfig):
    """One decoder layer: (x, k after RoPE, v) for the cache."""
    h = _ln(x, lp["ln1"])
    o, kr, v = attn_mod.self_attention(lp["self_attn"], h, positions, cfg)
    x = x + o @ lp["self_attn"]["wo"].to(cfg.compute_dtype)
    x = x + attn_mod.cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]), memory, cfg)
    return x + _mlp(lp["mlp"], _ln(x, lp["ln3"]), cfg), kr, v


def _decoder(model: Whisper, tokens, memory, cfg: ModelConfig, cache: KVCache | None = None):
    """tokens: (B, S) -> the normed hidden states (B, S, d); writes each
    layer's keys and values into ``cache`` at [0, S) when one is given."""
    B, S = tokens.shape
    x = model.dec_embed[tokens].to(cfg.compute_dtype)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    layer = _dec_layer if cache is not None else maybe_remat(_dec_layer, cfg.remat)
    for i, lp in enumerate(model.dec_layers):
        x, kr, v = layer(lp, x, positions, memory, cfg)
        if cache is not None:
            cache.k[i, :, :S] = kr
            cache.v[i, :, :S] = v
    return _ln(x, model.norms["dec_norm"])


def loss_fn(model: Whisper, batch: dict, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """Mean next-token loss of ``batch`` (``frames`` (B, enc_len, d),
    ``tokens`` and ``labels`` (B, S)) against the tied ``dec_embed``."""
    model_axis_raise("whisper", policy, model)
    memory = encode(model, batch["frames"], cfg)
    hidden = _decoder(model, batch["tokens"], memory, cfg)
    return chunked_cross_entropy(hidden, model.dec_embed, batch["labels"], cfg)


def _logits(model: Whisper, x) -> torch.Tensor:
    return x[:, -1].float() @ model.dec_embed.float().T


def prefill(model: Whisper, batch: dict, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED,
            max_len: int | None = None):
    """batch: {frames, tokens} -> (last logits, WhisperCache).  The cache
    holds the self-attention keys after RoPE and the values for positions
    ``[0, S)``, zero up to ``max_len``."""
    model_axis_raise("whisper", policy, model)
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    memory = encode(model, batch["frames"], cfg)
    cache = attn_mod.init_cache(cfg, B, max_len, cfg.n_layers, device=memory.device)
    hidden = _decoder(model, tokens, memory, cfg, cache)
    return _logits(model, hidden), WhisperCache(self_kv=cache, memory=memory)


def decode_step(model: Whisper, cache: WhisperCache, tokens, pos: int, cfg: ModelConfig,
                policy: ShardingPolicy = REPLICATED):
    """One decode step.  tokens: (B, 1); pos: the current position.  Writes
    the self-attention cache at ``pos`` in place; returns (logits, cache)."""
    model_axis_raise("whisper", policy, model)
    x = model.dec_embed[tokens].to(cfg.compute_dtype)
    k, v = cache.self_kv
    for i, lp in enumerate(model.dec_layers):
        o, _ = attn_mod.attention_decode(lp["self_attn"], _ln(x, lp["ln1"]),
                                         KVCache(k[i], v[i]), pos, cfg)
        x = x + o
        x = x + attn_mod.cross_attention(lp["cross_attn"], _ln(x, lp["ln2"]),
                                         cache.memory, cfg)
        x = x + _mlp(lp["mlp"], _ln(x, lp["ln3"]), cfg)
    x = _ln(x, model.norms["dec_norm"])
    return _logits(model, x), cache
