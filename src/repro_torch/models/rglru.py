"""RecurrentGemma / Griffin-style hybrid: RG-LRU recurrent blocks + local attention.

The port's counterpart of ``src/repro/models/rglru.py``.  The block pattern
(2 recurrent : 1 local attention by default) is heterogeneous, so the
layers are a list of per-layer modules, not a stack.  Prefill and
``forward`` run every recurrent layer's linear recurrence
``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)`` through the hand-written
scan kernel (``kernels/rglru.py``; the reference uses an associative scan)
and every attention layer's sliding-window self-attention through the
flash kernel (``models/attention.self_attention``).  Decode is one plain
step of the recurrence and grouped attention over a rolling window-sized
KV cache.  ``loss_fn`` is ``forward`` and the chunked cross-entropy against
the tied ``embed``; ``forward`` recomputes each block in the backward pass
when ``cfg.remat`` (the reference's ``maybe_remat`` per block), and the
scan's gradient is the same kernel run backwards (``kernels/rglru.py``).

Numbers follow the reference: the gates' products and the recurrence in
f32, the recurrent state f32, the conv state in the compute dtype,
``gelu`` in its tanh form (``jax.nn.gelu``'s default), logits from the tied
``embed``.

The rolling cache holds position p in slot ``p % window``, in prefill as in
decode.  The reference's prefill writes the last ``window`` positions to
slots 0..window-1 instead, which equals ``p % window`` only when the prompt
is at most one window long or a whole multiple of it; elsewhere its decode
reads the wrong keys (ROADMAP.md queue 3).  The port equals the reference
wherever the reference is right.  ``decode_step`` writes the KV cache in
place and replaces the recurrent and conv states in the cache's lists.

``param_specs`` (with ``rec_block_specs``) gives each parameter's layout
under a ``ShardingPolicy``, keyed by the port's names
(``layers.<i>.mixer.*`` for the reference's ``layers[i].rec`` or
``.attn``).  Under a sharded policy the passes run the partitioned bodies
of ``models/parallel.py`` on a model laid out for it, as
``models/transformer.py``'s do: every weight of the recurrent block is cut
on the LRU width w, so each member runs the gate, ``x @ w_x``, the conv
and the scan (``rglru_scan`` on the mesh dims and B folded) on its w / tp
channels, gathers the whole conv output once for the two (w, w) gates
(the paper's multicast), and ends in ``w_out``'s row-parallel sum; the
local-attention layers are tensor-parallel attention with the rolling
cache laid out by ``policy.kv_dims``; the embedding and tied head are
vocab-parallel.  Under sequence parallelism S is gathered before each
block.  ``cache_spec`` gives the cache's layout.
"""

from __future__ import annotations

from typing import NamedTuple

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru import rglru_scan
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    REPLICATED,
    ModelConfig,
    ShardingPolicy,
    check_supported,
    chunked_cross_entropy,
    dense_init,
    embed_init,
    maybe_remat,
    param,
    resolve_device,
    rms_norm,
)
from repro_torch.models.parallel import (Members, check_layout, last_token, rms_norm_tp,
                                          vocab_embed, vocab_logits)
from repro_torch.models.rope import apply_rope

_C = 8.0  # the RG-LRU's "c" constant (Griffin paper)


class HybridCache(NamedTuple):
    """Per-layer caches; entries are None where a layer has no such state."""

    rec_h: list   # per layer: (B, lru) f32, or None for attention layers
    conv: list    # per layer: (B, conv_width - 1, lru), or None
    attn: list    # per layer: KVCache of (B, window, n_kv, hd), or None


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def _kinds(cfg: ModelConfig) -> list[str]:
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


class Layer(nn.Module):
    """One layer: a pre-norm recurrent or attention block and a pre-norm MLP."""

    def __init__(self, kind: str, norm1, norm2, mixer: dict, mlp: dict):
        super().__init__()
        if kind not in ("rec", "attn"):
            raise ValueError(f"layer kind {kind!r}")
        self.kind = kind
        self.norm1 = param(norm1)
        self.norm2 = param(norm2)
        self.mixer = nn.ParameterDict({k: param(v) for k, v in mixer.items()})
        self.mlp = nn.ParameterDict({k: param(v) for k, v in mlp.items()})


class Hybrid(nn.Module):
    """The parameters of one model; the passes are the module functions below."""

    def __init__(self, cfg: ModelConfig, embed, layers: list[Layer], final_norm,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        if [layer.kind for layer in layers] != _kinds(cfg):
            raise ValueError(f"layer kinds {[layer.kind for layer in layers]} do not follow "
                             f"the pattern {_kinds(cfg)}")
        self.cfg = cfg
        self.embed = param(embed)
        self.layers = nn.ModuleList(layers)
        self.final_norm = param(final_norm)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_rec_block(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, w, pd = cfg.d_model, _lru_width(cfg), cfg.param_dtype
    return {
        "w_x": dense_init(gen, (d, w), pd, device),
        "w_gate": dense_init(gen, (d, w), pd, device),
        "conv_w": dense_init(gen, (cfg.conv_width, w), pd, device, scale=0.5),
        "lambda": torch.full((w,), 2.0, dtype=torch.float32, device=device),  # softplus ~ 2.1
        "w_input_gate": dense_init(gen, (w, w), pd, device),
        "w_a_gate": dense_init(gen, (w, w), pd, device),
        "w_out": dense_init(gen, (w, d), pd, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device=None,
         trainable: bool = False) -> Hybrid:
    """Random weights drawn from ``gen`` on ``device`` (None means CUDA, and
    raises without a card), requiring gradients when ``trainable``.  Norm
    scales start at zero, as in the reference."""
    device = resolve_device(device)

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device)

    layers = []
    for kind in _kinds(cfg):
        mixer = (init_rec_block(gen, cfg, device) if kind == "rec"
                 else attn_mod.init_attn_params(gen, cfg, device))
        layers.append(Layer(kind, zeros(), zeros(), mixer,
                            mlp_mod.init_mlp_params(gen, cfg, device)))
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    return Hybrid(cfg, embed, layers, zeros(), trainable)


# ---------------------------------------------------------------------------
# The recurrent block
# ---------------------------------------------------------------------------


def rec_block_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    w = _lru_width(cfg)
    return {
        "w_x": policy.w_col(w),
        "w_gate": policy.w_col(w),
        "conv_w": (None, policy._model_if_divisible(w)),
        "lambda": (policy._model_if_divisible(w),),
        "w_input_gate": policy.w_col(w),  # note: (w, w) diag-blockable
        "w_a_gate": policy.w_col(w),
        "w_out": policy.w_row(w),
    }


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each parameter's spec under ``policy``, by the port's name."""
    specs = {"embed": policy.embed(cfg.padded_vocab), "final_norm": (None,)}
    for i, kind in enumerate(_kinds(cfg)):
        mixer = (rec_block_specs(cfg, policy) if kind == "rec"
                 else attn_mod.attn_param_specs(cfg, policy))
        specs.update({f"layers.{i}.norm1": (None,), f"layers.{i}.norm2": (None,)})
        specs.update({f"layers.{i}.mixer.{k}": v for k, v in mixer.items()})
        specs.update({f"layers.{i}.mlp.{k}": v
                      for k, v in mlp_mod.mlp_param_specs(cfg, policy).items()})
    return specs


def _causal_conv(x, conv_w, state=None):
    """Depthwise causal conv along time.  x: (..., B, S, W); conv_w:
    (..., K, W), its leading dims those of x before B (the mesh dims on a
    stacked mesh); state: the previous K - 1 inputs (..., B, K - 1, W) or
    None for zeros.  Returns (out, new state)."""
    K = conv_w.shape[-2]
    if state is None:
        pad = torch.zeros(x.shape[:-2] + (K - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-2)
    S = x.shape[-2]
    out = sum(xp[..., i:i + S, :] * conv_w[..., i, None, None, :] for i in range(K))
    return out, (xp[..., -(K - 1):, :] if K > 1 else None)


def _rg_lru_coeffs(params, xw, cfg: ModelConfig):
    """Returns (a_t, gated input b_t) of the recurrence, both f32."""
    x32 = xw.float()
    r = torch.sigmoid(x32 @ params["w_a_gate"].float())
    i = torch.sigmoid(x32 @ params["w_input_gate"].float())
    log_a = -_C * F.softplus(params["lambda"].float()) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * x32


def _lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over dim 1, through the scan kernel; ``h0``
    is folded into b_0 as the reference folds it."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += a[:, 0] * h0
    return rglru_scan(a.contiguous(), b.contiguous())


def rec_block(params, x, cfg: ModelConfig, state=None, conv_state=None):
    """Griffin recurrent block.  x: (B, S, d) -> (out, (h_last, conv_state))."""
    cd = cfg.compute_dtype
    gate = F.gelu(x @ params["w_gate"].to(cd), approximate="tanh")
    xw = x @ params["w_x"].to(cd)
    xw, new_conv = _causal_conv(xw, params["conv_w"].to(cd), conv_state)
    a, b = _rg_lru_coeffs(params, xw, cfg)
    h = _lru_scan(a, b, state)
    out = (h.to(cd) * gate) @ params["w_out"].to(cd)
    # copies, so that the cache does not hold the whole sequence's h and xw
    return out, (h[:, -1].clone(), None if new_conv is None else new_conv.clone())


def rec_block_decode(params, x, cfg: ModelConfig, state, conv_state):
    """One token of the recurrent block.  x: (B, 1, d)."""
    cd = cfg.compute_dtype
    gate = F.gelu(x @ params["w_gate"].to(cd), approximate="tanh")
    xw = x @ params["w_x"].to(cd)
    xw, new_conv = _causal_conv(xw, params["conv_w"].to(cd), conv_state)
    a, b = _rg_lru_coeffs(params, xw, cfg)
    h = a[:, 0] * state + b[:, 0]
    out = (h[:, None].to(cd) * gate) @ params["w_out"].to(cd)
    return out, (h, new_conv)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _logits(model: Hybrid, x, cfg: ModelConfig) -> torch.Tensor:
    """The last token's logits in f32 over the padded vocab (tied embed)."""
    x = rms_norm(x[:, -1], model.final_norm, cfg.norm_eps)
    return x.float() @ model.embed.float().T


def _block(layer: Layer, x, positions, cfg: ModelConfig):
    h = rms_norm(x, layer.norm1, cfg.norm_eps)
    if layer.kind == "rec":
        h = rec_block(layer.mixer, h, cfg)[0]
    else:
        h = attn_mod.attention(layer.mixer, h, positions, cfg, window=cfg.attn_window)
    x = x + h
    h = rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + mlp_mod.mlp(layer.mlp, h, cfg)


def forward(model: Hybrid, tokens, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """tokens: (B, S) -> (hidden (B, S, d), aux loss)."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x = _forward_tp(model, tokens, cfg, mb)
            return mb.unshard_batch(mb.gather_seq(x)), torch.zeros((), device=x.device)
    B, S = tokens.shape
    x = model.embed[tokens].to(cfg.compute_dtype)
    positions = _positions(B, S, x.device)
    block = maybe_remat(_block, cfg.remat)
    for layer in model.layers:
        x = block(layer, x, positions, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def loss_fn(model: Hybrid, batch: dict, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S));
    under a sharding policy vocab-parallel, as ``transformer.loss_fn``."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x = _forward_tp(model, batch["tokens"], cfg, mb)
            loss = chunked_cross_entropy(mb.gather_seq(x), model.embed,
                                         mb.shard_batch(batch["labels"]), cfg, mb)
            return mb.backward_loss(loss)
    hidden, _ = forward(model, batch["tokens"], cfg)
    return chunked_cross_entropy(hidden, model.embed, batch["labels"], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> HybridCache:
    """Attention layers cache only the local window (O(window), not O(S))."""
    w, cd = _lru_width(cfg), cfg.compute_dtype
    window = max(1, min(cfg.attn_window or max_len, max_len))
    rec_h, conv, attn = [], [], []
    for kind in _kinds(cfg):
        if kind == "rec":
            rec_h.append(torch.zeros((batch, w), dtype=torch.float32, device=device))
            conv.append(torch.zeros((batch, cfg.conv_width - 1, w), dtype=cd, device=device))
            attn.append(None)
        else:
            rec_h.append(None)
            conv.append(None)
            shape = (batch, window, cfg.n_kv_heads, cfg.head_dim)
            attn.append(KVCache(k=torch.zeros(shape, dtype=cd, device=device),
                                v=torch.zeros(shape, dtype=cd, device=device)))
    return HybridCache(rec_h=rec_h, conv=conv, attn=attn)


def prefill(model: Hybrid, tokens, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED,
            max_len: int | None = None):
    """Full-sequence prefill; returns (last-token logits, cache).

    Each attention layer's rolling cache gets the keys (after RoPE) and
    values of the last ``window`` positions, position p in slot
    ``p % window``, where decode looks for it.
    """
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            return _prefill_tp(model, tokens, cfg, max_len or tokens.shape[-1], Members(policy))
    B, S = tokens.shape
    cd = cfg.compute_dtype
    x = model.embed[tokens].to(cd)
    positions = _positions(B, S, x.device)
    cache = init_cache(cfg, B, max_len or S, device=x.device)
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if layer.kind == "rec":
            h, (cache.rec_h[i], cache.conv[i]) = rec_block(layer.mixer, h, cfg)
        else:
            o, kr, v = attn_mod.self_attention(layer.mixer, h, positions, cfg,
                                               window=cfg.attn_window)
            h = o @ layer.mixer["wo"].to(cd)
            kc, vc = cache.attn[i]
            window = kc.shape[1]
            take = min(window, S)
            slots = torch.arange(S - take, S, device=x.device) % window
            kc.index_copy_(1, slots, kr[:, S - take:].to(kc.dtype))
            vc.index_copy_(1, slots, v[:, S - take:].to(vc.dtype))
        x = x + h
        h = rms_norm(x, layer.norm2, cfg.norm_eps)
        x = x + mlp_mod.mlp(layer.mlp, h, cfg)
    return _logits(model, x, cfg), cache


def _attn_decode(params, h, kv: KVCache, pos: int, cfg: ModelConfig):
    """One token of local attention over the rolling cache, written at
    ``pos % window`` in place."""
    B = h.shape[0]
    cd = cfg.compute_dtype
    window = kv.k.shape[1]
    slot = pos % window
    q, k_new, v_new = attn_mod._qkv(params, h, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    kv.k[:, slot] = k_new[:, 0].to(kv.k.dtype)
    kv.v[:, slot] = v_new[:, 0].to(kv.v.dtype)
    # a slot is live if it holds one of the last ``window`` positions
    mask = attn_mod.rolling_valid(torch.arange(window, device=h.device), pos,
                                  window)[None, None, None, :]
    Hkv = kv.k.shape[2]
    q5 = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, cfg.head_dim)
    out = attn_mod._sdpa_block(q5, kv.k.to(cd), kv.v.to(cd), mask, cfg)
    return out @ params["wo"].to(cd)


def decode_step(model: Hybrid, cache: HybridCache, tokens, pos: int, cfg: ModelConfig,
                policy: ShardingPolicy = REPLICATED):
    """One-token decode at position ``pos``.  tokens: (B, 1).  Returns
    (logits, cache)."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            # one token: no sequence to split
            return _decode_tp(model, cache, tokens, pos, cfg,
                              Members(dataclasses.replace(policy, seq_axis=None)))
    x = model.embed[tokens].to(cfg.compute_dtype)
    rec_h, conv = list(cache.rec_h), list(cache.conv)
    for i, layer in enumerate(model.layers):
        h = rms_norm(x, layer.norm1, cfg.norm_eps)
        if layer.kind == "rec":
            h, (rec_h[i], conv[i]) = rec_block_decode(layer.mixer, h, cfg, rec_h[i], conv[i])
        else:
            h = _attn_decode(layer.mixer, h, cache.attn[i], pos, cfg)
        x = x + h
        h = rms_norm(x, layer.norm2, cfg.norm_eps)
        x = x + mlp_mod.mlp(layer.mlp, h, cfg)
    return _logits(model, x, cfg), HybridCache(rec_h=rec_h, conv=conv, attn=cache.attn)


# ---------------------------------------------------------------------------
# Under a sharding policy (models/parallel.py): the member's tensors
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> HybridCache:
    """The layout of each layer's cache entries: ``rec_h`` (B, w) and
    ``conv`` (B, K - 1, w) on the LRU width w, the attention layers' k and v
    (B, window, kv, hd) as ``policy.kv_dims`` says (the reference's
    ``launch/steps.py`` layout)."""
    w_s = policy._model_if_divisible(_lru_width(cfg))
    kv_s, hd_s = policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    b = policy.batch_axes or None
    kv = (b, None, kv_s, hd_s)
    kinds = _kinds(cfg)
    return HybridCache(rec_h=[(b, w_s) if k == "rec" else None for k in kinds],
                       conv=[(b, None, w_s) if k == "rec" else None for k in kinds],
                       attn=[None if k == "rec" else KVCache(kv, kv) for k in kinds])



def _rec_block_tp(params, x, cfg: ModelConfig, mb: Members, state=None, conv_state=None):
    """The recurrent block on the member's block of the LRU width w:
    (out, (h_last, conv_state)), the states on the member's w / tp.

    x: (*lead, B, S, d), or the member's block of S under sequence
    parallelism, gathered first (the scan needs the whole of S).  The
    gate, ``x @ w_x`` and the depthwise conv run on the member's channels;
    the two (w, w) gates, cut by columns, take the whole conv output,
    gathered over the model axis in the compute dtype and cast to f32
    after (the reference computes them in f32); ``w_out``'s rows end in
    ``row_out``.  With ``state`` (decode, one token) the recurrence is one
    plain step, else the scan kernel over the mesh dims and B folded."""
    cd = cfg.compute_dtype
    split = mb.split(rec_block_specs(cfg, mb.policy)["w_x"])
    x = mb.gather_seq(x)
    gate = F.gelu(mb.mm(x, params["w_gate"].to(cd)), approximate="tanh")
    xw = mb.mm(x, params["w_x"].to(cd))
    xw, new_conv = _causal_conv(xw, params["conv_w"].to(cd), conv_state)
    # the paper's multicast; contiguous, so that both mesh kinds hand the
    # gates' products one operand layout (and cuBLAS one kernel)
    x_all = (mb.gather(xw, -1) if split else xw).contiguous().float()
    r = torch.sigmoid(mb.mm(x_all, params["w_a_gate"].float()))
    i = torch.sigmoid(mb.mm(x_all, params["w_input_gate"].float()))
    log_a = -_C * F.softplus(mb.bcast(params["lambda"].float(), r)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * i * xw.float()
    if state is None:
        h = _lru_scan(a.flatten(0, mb.k), b.flatten(0, mb.k)).reshape(a.shape)
    else:
        h = (a[..., 0, :] * state + b[..., 0, :])[..., None, :]
    out = mb.row_out(mb.mm(h.to(cd) * gate, params["w_out"].to(cd)), split)
    return out, (h[..., -1, :].clone(), None if new_conv is None else new_conv.clone())


def _logits_tp(model: Hybrid, x, cfg: ModelConfig, mb: Members):
    """The last token's global logits (B, padded vocab) in f32 (tied embed)."""
    x = last_token(x, mb)
    return vocab_logits(rms_norm_tp(x, model.final_norm, cfg, mb), model.embed, cfg, mb)


def _layer_tp(layer: Layer, x, positions, cfg: ModelConfig, mb: Members):
    """One layer on the member's tensors.  It enters the mesh itself, since
    its remat recompute runs in the backward pass."""
    with mb.mesh:
        h = rms_norm_tp(x, layer.norm1, cfg, mb)
        if layer.kind == "rec":
            h = _rec_block_tp(layer.mixer, h, cfg, mb)[0]
        else:
            h = attn_mod.self_attention_tp(layer.mixer, h, positions, cfg, cfg.attn_window,
                                           mb)[0]
        x = x + h
        return x + mlp_mod.mlp(layer.mlp, rms_norm_tp(x, layer.norm2, cfg, mb), cfg, mb.policy)


def _forward_tp(model: Hybrid, tokens, cfg: ModelConfig, mb: Members):
    """The member's final hidden states (*lead, B, S or its block, d), each
    layer recomputed in the backward pass when ``cfg.remat``."""
    x = vocab_embed(model.embed, tokens, cfg, mb)
    positions = torch.arange(tokens.shape[-1], dtype=torch.int32, device=x.device)
    layer_fn = maybe_remat(_layer_tp, cfg.remat)
    for layer in model.layers:
        x = layer_fn(layer, x, positions, cfg, mb)
    return rms_norm_tp(x, model.final_norm, cfg, mb)


def _prefill_tp(model: Hybrid, tokens, cfg: ModelConfig, max_len: int, mb: Members):
    """The sharded prefill: the cache in the layout of :func:`cache_spec`,
    each attention layer's rolling cache filled at ``p % window``."""
    x = vocab_embed(model.embed, tokens, cfg, mb)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    window = max(1, min(cfg.attn_window or max_len, max_len))
    take = min(window, S)
    slots = torch.arange(S - take, S, device=x.device) % window
    seq = mb.k + 1  # the position dim of (*lead, B, S, kv, hd)
    rec_h, conv, attn = [], [], []
    for layer in model.layers:
        h = rms_norm_tp(x, layer.norm1, cfg, mb)
        if layer.kind == "rec":
            h, (h_last, conv_state) = _rec_block_tp(layer.mixer, h, cfg, mb)
            rec_h.append(h_last)
            conv.append(conv_state)
            attn.append(None)
        else:
            h, kr, v = attn_mod.self_attention_tp(layer.mixer, h, positions, cfg,
                                                  cfg.attn_window, mb)
            shape = kr.shape[:seq] + (window,) + kr.shape[seq + 1:]
            kc, vc = kr.new_zeros(shape), v.new_zeros(shape)
            kc.index_copy_(seq, slots, kr.narrow(seq, S - take, take))
            vc.index_copy_(seq, slots, v.narrow(seq, S - take, take))
            rec_h.append(None)
            conv.append(None)
            attn.append(KVCache(k=kc, v=vc))
        x = x + h
        x = x + mlp_mod.mlp(layer.mlp, rms_norm_tp(x, layer.norm2, cfg, mb), cfg, mb.policy)
    return _logits_tp(model, x, cfg, mb), HybridCache(rec_h=rec_h, conv=conv, attn=attn)


def _decode_tp(model: Hybrid, cache: HybridCache, tokens, pos: int, cfg: ModelConfig,
               mb: Members):
    x = vocab_embed(model.embed, tokens, cfg, mb)
    rec_h, conv = list(cache.rec_h), list(cache.conv)
    for i, layer in enumerate(model.layers):
        h = rms_norm_tp(x, layer.norm1, cfg, mb)
        if layer.kind == "rec":
            h, (rec_h[i], conv[i]) = _rec_block_tp(layer.mixer, h, cfg, mb, rec_h[i], conv[i])
        else:
            h = attn_mod._attention_decode_tp(layer.mixer, h, cache.attn[i], pos, cfg,
                                              cfg.attn_window, mb, rolling=True)[0]
        x = x + h
        x = x + mlp_mod.mlp(layer.mlp, rms_norm_tp(x, layer.norm2, cfg, mb), cfg, mb.policy)
    return _logits_tp(model, x, cfg, mb), HybridCache(rec_h=rec_h, conv=conv, attn=cache.attn)
