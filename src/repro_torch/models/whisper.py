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
``norms.enc_norm.scale``, ...).  Under a sharded policy the passes run
the partitioned bodies of ``models/parallel.py`` on a model laid out for
it: every attention (the encoder's bidirectional, the decoder's causal
self- and its cross-attention) runs on the member's heads and ends in
``wo``'s row-parallel sum; the MLPs are column-parallel in ``w1`` / ``b1``
and row-parallel in ``w2``, ``b2`` added once after the sum; the norms
and ``enc_pos`` are replicated and ``dec_embed`` is vocab-parallel.  Under
sequence parallelism the encoder's S is the frames.  The cache keeps the
whole ``memory`` on every model member, gathered once per prefill, and
its self-attention k and v by ``policy.kv_dims`` (``cache_spec``).
"""

from __future__ import annotations

import dataclasses
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
from repro_torch.models.parallel import (Members, check_layout, last_token, vocab_embed,
                                          vocab_logits)


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
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            return mb.unshard_batch(mb.gather_seq(_encode_tp(model, frames, cfg, mb)))
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
    ``tokens`` and ``labels`` (B, S)) against the tied ``dec_embed``; under
    a sharding policy vocab-parallel, as ``transformer.loss_fn``."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            memory = mb.gather_seq(_encode_tp(model, batch["frames"], cfg, mb))
            x = _decoder_tp(model, batch["tokens"], memory, cfg, mb)
            loss = chunked_cross_entropy(mb.gather_seq(x), model.dec_embed,
                                         mb.shard_batch(batch["labels"]), cfg, mb)
            return mb.backward_loss(loss)
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
    tokens = batch["tokens"]
    B, S = tokens.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            return _prefill_tp(model, batch, cfg, max_len, Members(policy))
    memory = encode(model, batch["frames"], cfg)
    cache = attn_mod.init_cache(cfg, B, max_len, cfg.n_layers, device=memory.device)
    hidden = _decoder(model, tokens, memory, cfg, cache)
    return _logits(model, hidden), WhisperCache(self_kv=cache, memory=memory)


def decode_step(model: Whisper, cache: WhisperCache, tokens, pos: int, cfg: ModelConfig,
                policy: ShardingPolicy = REPLICATED):
    """One decode step.  tokens: (B, 1); pos: the current position.  Writes
    the self-attention cache at ``pos`` in place; returns (logits, cache)."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            # one token: no sequence to split
            return _decode_tp(model, cache, tokens, pos, cfg,
                              Members(dataclasses.replace(policy, seq_axis=None)))
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


# ---------------------------------------------------------------------------
# Under a sharding policy (models/parallel.py): the member's tensors
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> WhisperCache:
    """The cache's layout: the self-attention k and v (L, B, S_max, kv, hd)
    as ``policy.kv_dims`` says, ``memory`` (B, enc_len, d) whole on each
    model member (the reference's ``P(bspec, None, None)``)."""
    b = policy.batch_axes or None
    kv_s, hd_s = policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    kv = (None, b, None, kv_s, hd_s)
    return WhisperCache(self_kv=KVCache(kv, kv), memory=(b, None, None))


def _ln_tp(x, p, mb: Members):
    return layer_norm(x, mb.bcast(p["scale"], x), mb.bcast(p["bias"], x))


def _mlp_tp(p, x, cfg: ModelConfig, mb: Members):
    """``w1`` / ``b1`` column-parallel and ``w2`` row-parallel, its sum over
    the model axis taken before ``b2`` is added, once (under sequence
    parallelism: S gathered first, the sum scattered on S)."""
    cd = cfg.compute_dtype
    x = mb.gather_seq(x)
    h = mb.mm(x, p["w1"].to(cd))
    h = F.gelu(h + mb.bcast(p["b1"].to(cd), h), approximate="tanh")
    out = mb.row_out(mb.mm(h, p["w2"].to(cd)), mb.split(_mlp_specs(cfg, mb.policy)["w2"]))
    return out + mb.bcast(p["b2"].to(cd), out)


def _enc_layer_tp(lp, x, cfg: ModelConfig, mb: Members):
    """One encoder layer on the member's tensors (its block of the frames
    under sequence parallelism).  It enters the mesh itself, since its
    remat recompute runs in the backward pass."""
    with mb.mesh:
        h = _ln_tp(x, lp["ln1"], mb)
        x = x + attn_mod.unmasked_attention_tp(lp["attn"], h, None, cfg, mb)
        return x + _mlp_tp(lp["mlp"], _ln_tp(x, lp["ln2"], mb), cfg, mb)


def _encode_tp(model: Whisper, frames, cfg: ModelConfig, mb: Members):
    """The member's encoded frames (*lead, B, enc_len or its block, d)."""
    cd = cfg.compute_dtype
    mb.check_seq(frames.shape[-2])
    x = mb.row_out(mb.shard_batch(frames).to(cd) + model.enc_pos.to(cd).unsqueeze(mb.k), False)
    layer = maybe_remat(_enc_layer_tp, cfg.remat)
    for lp in model.enc_layers:
        x = layer(lp, x, cfg, mb)
    return _ln_tp(x, model.norms["enc_norm"], mb)


def _dec_layer_tp(lp, x, positions, memory, cfg: ModelConfig, mb: Members):
    """One decoder layer: (x, k after RoPE, v), the last two in the cache
    layout over the whole of S.  ``memory`` is whole on every member."""
    with mb.mesh:
        h = _ln_tp(x, lp["ln1"], mb)
        o, kr, v = attn_mod.self_attention_tp(lp["self_attn"], h, positions, cfg, 0, mb)
        x = x + o
        x = x + attn_mod.unmasked_attention_tp(lp["cross_attn"], _ln_tp(x, lp["ln2"], mb),
                                               memory, cfg, mb)
        return x + _mlp_tp(lp["mlp"], _ln_tp(x, lp["ln3"], mb), cfg, mb), kr, v


def _decoder_tp(model: Whisper, tokens, memory, cfg: ModelConfig, mb: Members, cache=None):
    """The member's normed decoder states (*lead, B, S or its block, d);
    writes each layer's keys and values into ``cache`` at [0, S) when one
    is given."""
    x = vocab_embed(model.dec_embed, tokens, cfg, mb)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layer = _dec_layer_tp if cache is not None else maybe_remat(_dec_layer_tp, cfg.remat)
    at = (slice(None),) * mb.k
    for i, lp in enumerate(model.dec_layers):
        x, kr, v = layer(lp, x, positions, memory, cfg, mb)
        if cache is not None:
            cache.k[at + (i, slice(None), slice(0, S))] = kr
            cache.v[at + (i, slice(None), slice(0, S))] = v
    return _ln_tp(x, model.norms["dec_norm"], mb)


def _prefill_tp(model: Whisper, batch: dict, cfg: ModelConfig, max_len: int, mb: Members):
    """The sharded prefill: the encoder's output gathered once into the
    cache's whole ``memory``, the cache in the layout of :func:`cache_spec`."""
    memory = mb.gather_seq(_encode_tp(model, batch["frames"], cfg, mb))
    kv_s, hd_s = mb.policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    shape = memory.shape[:mb.k + 1] + (max_len, cfg.n_kv_heads // (mb.tp if kv_s else 1),
                                       cfg.head_dim // (mb.tp if hd_s else 1))
    shape = shape[:mb.k] + (cfg.n_layers,) + shape[mb.k:]
    cache = KVCache(k=memory.new_zeros(shape), v=memory.new_zeros(shape))
    x = _decoder_tp(model, batch["tokens"], memory, cfg, mb, cache)
    logits = vocab_logits(last_token(x, mb), model.dec_embed, cfg, mb)
    return logits, WhisperCache(self_kv=cache, memory=memory)


def _decode_tp(model: Whisper, cache: WhisperCache, tokens, pos: int, cfg: ModelConfig,
               mb: Members):
    x = vocab_embed(model.dec_embed, tokens, cfg, mb)
    k, v = cache.self_kv
    for i, lp in enumerate(model.dec_layers):
        o, _ = attn_mod._attention_decode_tp(
            lp["self_attn"], _ln_tp(x, lp["ln1"], mb),
            KVCache(k.select(mb.k, i), v.select(mb.k, i)), pos, cfg, 0, mb)
        x = x + o
        x = x + attn_mod.unmasked_attention_tp(lp["cross_attn"], _ln_tp(x, lp["ln2"], mb),
                                               cache.memory, cfg, mb)
        x = x + _mlp_tp(lp["mlp"], _ln_tp(x, lp["ln3"], mb), cfg, mb)
    x = _ln_tp(x, model.norms["dec_norm"], mb)
    return vocab_logits(x[..., -1, :], model.dec_embed, cfg, mb), cache
