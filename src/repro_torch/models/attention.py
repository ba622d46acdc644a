"""Grouped-query attention with causal / sliding-window masks and KV caches.

The port's counterpart of ``src/repro/models/attention.py``:

* causal self-attention over a full sequence (``attention``, and the
  prefill of ``models/transformer.py``) goes through the hand-written
  flash kernel (``kernels/flash_attention.py``), with the layer's sliding
  window when it has one;
* one-token decode (``attention_decode``) stays plain PyTorch: the grouped
  einsum of the reference's ``_sdpa_block`` over the whole cache, under the
  mask of valid positions;
* bidirectional self-attention (``attention(..., bidirectional=True)``,
  whisper's encoder: no RoPE, an all-true mask) and ``cross_attention``
  (whisper's decoder onto the encoder's memory) take the plain path of
  the reference's ``_sdpa_flat``: the flash kernel is causal-only, as the
  Pallas kernel is.

GQA: the reference's flat path repeats K/V with ``jnp.repeat(k, group,
axis=2)``, so query head h reads kv head ``h // group``: that is
``repeat_interleave`` here.  K and V are repeated to H heads, q, k and v
are copied into contiguous (B*H, S, hd) for the kernel, and its output is
copied back: six copies of a (B, S, H, hd) tensor per layer, which a
kernel that reads kv head ``h // group`` in place would mostly save.

Numbers: the reference model casts the probabilities to the compute dtype
before ``P @ V``; the kernel, like the TPU kernel, keeps them in f32.  In
bf16 the port therefore differs from the reference model by one rounding
per layer; in f32 (the CPU tests' smoke configs) the two agree.

``cfg.attn_bf16_logits`` (the reference's lever): the logits are a bf16
product, scaled by the scale rounded to bf16, masked with -3e38 and
softmaxed in bf16 (``_sdpa_block``, ``_sdpa_flat``); causal
self-attention then takes that plain path (``_sdpa`` under the causal,
windowed mask), unsharded and in the ``_tp`` bodies, as the reference
does, since the flash kernel softmaxes in f32.  It writes (B, H, S, S)
scores.

The decode cache is updated in place (``KVCache`` tensors are written at
``pos``), where the reference's ``dynamic_update_slice`` returns a new
array: the returned cache holds the same tensors, and no copy of the cache
is made per step.

Under a sharding policy with a model axis (``models/parallel.py``) Q, K
and V are column-parallel and ``wo`` row-parallel, its product summed over
the model axis (under sequence parallelism: S gathered before QKV, the sum
scattered on S after ``wo``).  Flash attention runs on the member's own query heads,
with the mesh dims folded into the kernel's batch; the unmasked
attentions (whisper's bidirectional encoder and cross-attention,
``unmasked_attention_tp``) take the plain path on the same heads.  Where a weight's spec
splits a head between members (``n_heads`` or ``n_kv_heads`` not a
multiple of the axis), the projections are gathered over the axis first,
and a member whose kv heads do not cover its query heads' groups takes
them from the gathered K and V.  The cache is laid out by
``policy.kv_dims`` (the reference's ``launch/steps.py:_kv_dim_specs``): on
kv heads, else on ``head_dim``, where decode sums the members' partial
logits over the axis.

The long-context decode (``policy.cache_seq_axis``, the transformer's
``long_500k`` cell): the cache's sequence dim is cut over that axis too,
member j holding positions [j S_l, (j + 1) S_l).  The new k and v go into
the member that owns slot ``pos``; each member attends over its block
and the blocks merge by their log-sum-exp: the row maximum by a ``pmax``
over the axis, then a ``psum`` of the denominators and of the weighted
values.
"""

from __future__ import annotations

import math
import struct
from typing import NamedTuple, Optional

import torch

from repro_torch.core import mesh as M
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (REPLICATED, ModelConfig, ShardingPolicy,
                                       dense_init)
from repro_torch.models.parallel import Members, is_sharded
from repro_torch.models.rope import apply_rope

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    k: torch.Tensor  # (..., B, S_max, n_kv, head_dim)
    v: torch.Tensor


def init_attn_params(gen, cfg: ModelConfig, device=None,
                     d_model: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    hd = cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), cfg.param_dtype, device),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), cfg.param_dtype, device),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), cfg.param_dtype, device),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), cfg.param_dtype, device),
    }
    if cfg.qkv_bias:
        dev = device or gen.device
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=cfg.param_dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=cfg.param_dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=cfg.param_dtype, device=dev)
    return p


def attn_param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    hd = cfg.head_dim
    p = {
        "wq": policy.w_col(cfg.n_heads * hd) if cfg.n_heads * hd else policy.none(),
        "wk": policy.w_col(cfg.n_kv_heads * hd),
        "wv": policy.w_col(cfg.n_kv_heads * hd),
        "wo": policy.w_row(cfg.n_heads * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = (policy._model_if_divisible(cfg.n_heads * hd),)
        p["bk"] = (policy._model_if_divisible(cfg.n_kv_heads * hd),)
        p["bv"] = (policy._model_if_divisible(cfg.n_kv_heads * hd),)
    return p


def _qkv(params, x, cfg: ModelConfig):
    B, S, _ = x.shape
    hd, cd = cfg.head_dim, cfg.compute_dtype
    q = x @ params["wq"].to(cd)
    k = x @ params["wk"].to(cd)
    v = x @ params["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cd)
        k = k + params["bk"].to(cd)
        v = v + params["bv"].to(cd)
    return (q.reshape(B, S, cfg.n_heads, hd), k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def _scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


def _bf16(x: float) -> float:
    """``x`` rounded to bfloat16 (to nearest, ties to even), as a float."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


BF16_NEG_INF = -3.0e38  # the reference's mask value of bf16 logits


def _masked_logits(eq: str, q, k, mask, cfg: ModelConfig):
    """``einsum(eq, q, k)`` times the scale, under ``mask``: in f32, or in
    bf16 with the scale rounded to bf16 under ``cfg.attn_bf16_logits``."""
    hd = q.shape[-1]
    if cfg.attn_bf16_logits:
        logits = torch.einsum(eq, q.bfloat16(), k.bfloat16()) * _bf16(_scale(hd))
        return torch.where(mask, logits, BF16_NEG_INF)
    logits = torch.einsum(eq, q.float(), k.float()) * _scale(hd)
    return torch.where(mask, logits, NEG_INF)


def _sdpa_block(q5, k, v, mask, cfg: ModelConfig):
    """Grouped-query attention without repeating K/V (the decode path).

    q5: (B, Sq, Hkv, G, hd); k, v: (B, Sk, Hkv, hd); mask: (B|1, 1, Sq, Sk).
    """
    B, Sq, Hkv, G, hd = q5.shape
    probs = torch.softmax(_masked_logits("bqkgd,bskd->bkgqs", q5, k, mask[:, None], cfg), dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(cfg.compute_dtype), v)
    return out.reshape(B, Sq, Hkv * G * hd)


def _causal_flash(q, k, v, window: int):
    """Causal self-attention through the flash kernel.

    q: (B, S, H, hd); k, v: (B, S, Hkv, hd).  Returns (B, S, H * hd).
    """
    B, S, H, hd = q.shape
    group = H // k.shape[2]

    def heads_first(t):  # (B, S, H, hd) -> contiguous (B * H, S, hd)
        # reshape alone returns a strided view when B == 1
        return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    out = flash_attention(heads_first(q),
                          heads_first(k.repeat_interleave(group, dim=2)),
                          heads_first(v.repeat_interleave(group, dim=2)),
                          window=int(window))
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)


def _sdpa_flat(q, k, v, mask, cfg: ModelConfig):
    """Repeat-KV attention with flat heads, plain (the bidirectional and
    cross-attention path, and causal attention with bf16 logits).
    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd); mask: (B|1, 1, Sq, Sk) bool.
    Returns (B, Sq, H * hd)."""
    B, Sq, H, hd = q.shape
    group = H // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    probs = torch.softmax(_masked_logits("bqhd,bkhd->bhqk", q, k, mask, cfg), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(cfg.compute_dtype), v)
    return out.reshape(B, Sq, H * hd)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """Plain attention as the reference's ``_sdpa`` picks it: the grouped
    path for one query, the flat path for more."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    if Sq == 1:
        return _sdpa_block(q.reshape(B, Sq, Hkv, H // Hkv, hd), k, v, mask, cfg)
    return _sdpa_flat(q, k, v, mask, cfg)


def causal_window_mask(Sq: int, Sk: int, window: int, offset: int = 0, device=None):
    """(1, 1, Sq, Sk) bool; window 0 means unlimited."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    ki = torch.arange(Sk, device=device)[None, :]
    m = ki <= qi
    if window > 0:
        m = m & (ki > qi - window)
    return m[None, None]


def _causal(q, k, v, window: int, cfg: ModelConfig):
    """Causal self-attention (B, S, H * hd): the flash kernel, or with
    ``cfg.attn_bf16_logits`` the plain bf16-logit path under the causal,
    windowed mask, as the reference computes it."""
    if cfg.attn_bf16_logits:
        S = q.shape[1]
        return _sdpa(q, k, v, causal_window_mask(S, S, window, device=q.device), cfg)
    return _causal_flash(q, k, v, window)


def self_attention(params, x, positions, cfg: ModelConfig, *, window: int = 0):
    """Causal self-attention before the output projection.

    Returns (out (B, S, H * hd), k after RoPE, v), the last two for the
    prefill's cache.
    """
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _causal(q, k, v, window, cfg), k, v


def attention(params, x, positions, cfg: ModelConfig, *, window: int = 0,
              policy: ShardingPolicy = REPLICATED, bidirectional: bool = False):
    """Self-attention over a full sequence (training / prefill): causal
    through the flash kernel, or bidirectional on the plain path."""
    if is_sharded(policy):
        mb = Members(policy)
        if bidirectional:
            return unmasked_attention_tp(params, x, None, cfg, mb)
        return self_attention_tp(params, x, positions, cfg, window, mb)[0]
    if bidirectional:
        S = x.shape[1]
        q, k, v = _qkv(params, x, cfg)
        mask = torch.ones((1, 1, S, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
    else:
        out = self_attention(params, x, positions, cfg, window=window)[0]
    return out @ params["wo"].to(cfg.compute_dtype)


def cross_attention(params, x, memory, cfg: ModelConfig,
                    policy: ShardingPolicy = REPLICATED):
    """Decoder cross-attention onto encoder memory (whisper), unmasked."""
    if is_sharded(policy):
        return unmasked_attention_tp(params, x, memory, cfg, Members(policy))
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    hd, cd = cfg.head_dim, cfg.compute_dtype
    q = (x @ params["wq"].to(cd)).reshape(B, Sq, cfg.n_heads, hd)
    k = (memory @ params["wk"].to(cd)).reshape(B, Sk, cfg.n_kv_heads, hd)
    v = (memory @ params["wv"].to(cd)).reshape(B, Sk, cfg.n_kv_heads, hd)
    mask = torch.ones((1, 1, Sq, Sk), dtype=torch.bool, device=x.device)
    return _sdpa(q, k, v, mask, cfg) @ params["wo"].to(cd)


def rolling_valid(ki, pos: int, window: int):
    """The slots ``ki`` of a rolling cache of ``window`` slots (position p
    in slot ``p % window``) that hold one of the last ``window`` positions
    up to ``pos``."""
    slot = pos % window
    abs_idx = torch.where(ki <= slot, pos - slot + ki, pos - slot - window + ki)
    return abs_idx >= max(0, pos - window + 1)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype=None, device=None) -> KVCache:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def attention_decode(params, x, layer_cache: KVCache, pos: int, cfg: ModelConfig, *,
                     window: int = 0, policy: ShardingPolicy = REPLICATED):
    """One-token decode with the cache written at ``pos`` in place.

    x: (B, 1, d); layer_cache k/v: (B, S_max, n_kv, hd).  Returns (out, cache).
    """
    if is_sharded(policy):
        return _attention_decode_tp(params, x, layer_cache, pos, cfg, window, Members(policy))
    B = x.shape[0]
    S_max = layer_cache.k.shape[1]
    q, k_new, v_new = _qkv(params, x, cfg)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_new = apply_rope(k_new, positions, cfg.rope_theta)
    layer_cache.k[:, pos] = k_new[:, 0].to(layer_cache.k.dtype)
    layer_cache.v[:, pos] = v_new[:, 0].to(layer_cache.v.dtype)
    ki = torch.arange(S_max, device=x.device)[None, :]
    valid = ki <= pos
    if window > 0:
        valid = valid & (ki > pos - window)
    mask = valid[:, None, None, :]  # (1, 1, 1, S_max)
    cd = cfg.compute_dtype
    Hkv = layer_cache.k.shape[2]
    q5 = q.reshape(B, 1, Hkv, cfg.n_heads // Hkv, cfg.head_dim)
    out = _sdpa_block(q5, layer_cache.k.to(cd), layer_cache.v.to(cd), mask, cfg)
    return out @ params["wo"].to(cd), layer_cache


# ---------------------------------------------------------------------------
# Under a sharding policy (models/parallel.py)
# ---------------------------------------------------------------------------


def _qkv_tp(params, x, cfg: ModelConfig, mb: Members, memory=None):
    """The member's q, k, v: (*lead, B, S, heads, hd), and whether q and k
    hold the member's own block of heads (else all of them).  K and V are
    projected from ``memory`` when it is given (cross-attention)."""
    cd, hd = cfg.compute_dtype, cfg.head_dim
    specs = attn_param_specs(cfg, mb.policy)

    def proj(w, b, src):
        y = mb.mm(src, params[w].to(cd))
        return y + mb.bcast(params[b].to(cd), y) if cfg.qkv_bias else y

    kv_src = x if memory is None else memory
    q, k, v = proj("wq", "bq", x), proj("wk", "bk", kv_src), proj("wv", "bv", kv_src)
    q_own = mb.split(specs["wq"]) and cfg.n_heads % mb.tp == 0
    kv_own = mb.split(specs["wk"]) and cfg.n_kv_heads % mb.tp == 0
    if mb.split(specs["wq"]) and not q_own:  # heads cut mid-head: all of them
        q = mb.gather(q, -1)
    if mb.split(specs["wk"]) and not kv_own:
        k, v = mb.gather(k, -1), mb.gather(v, -1)
    heads = (lambda t: t.unflatten(-1, (-1, hd)))
    return heads(q), heads(k), heads(v), q_own, kv_own


def _kv_for_q(k, q_own: bool, kv_own: bool, cfg: ModelConfig, mb: Members):
    """K (or V) whose heads serve q's as grouped attention reads them: as
    it is, unless q holds the member's heads and k all of them, when the
    member takes the kv head ``h // group`` of each of its query heads."""
    if not q_own or kv_own:
        return k
    return mb.block(k.repeat_interleave(cfg.q_per_kv, dim=-2), -2)


def _to_cache(t, kv_own: bool, cfg: ModelConfig, mb: Members):
    """K or V in the cache layout of ``policy.kv_dims``."""
    kv_s, hd_s = mb.policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    if kv_s is not None:
        assert kv_own, "kv heads on the model axis come from a split wk"
        return t
    return mb.block(t, -1) if hd_s is not None else t


def _out_tp(o, params, cfg: ModelConfig, mb: Members, q_own: bool):
    """``o @ wo`` for the member's rows of ``wo``, summed over the model axis."""
    spec = attn_param_specs(cfg, mb.policy)["wo"]
    if mb.split(spec) and not q_own:
        o = mb.block(o, -1)
    out = mb.mm(o, params["wo"].to(cfg.compute_dtype))
    return mb.row_out(out, mb.split(spec))


def self_attention_tp(params, x, positions, cfg: ModelConfig, window: int, mb: Members):
    """Causal self-attention of the member's heads through the flash kernel,
    projected by ``wo`` and summed over the model axis.

    x: (*lead, B, S, d), or the member's block of S under sequence
    parallelism, which is gathered before the QKV products and scattered
    again by the reduction after ``wo``.  Returns (out, k after RoPE, v),
    the last two in the cache layout, over the whole of S.
    """
    q, k, v, q_own, kv_own = _qkv_tp(params, mb.gather_seq(x), cfg, mb)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    fold = (lambda t: t.flatten(0, mb.k))  # the mesh dims into the batch
    o = _causal(fold(q), fold(_kv_for_q(k, q_own, kv_own, cfg, mb)),
                fold(_kv_for_q(v, q_own, kv_own, cfg, mb)), window, cfg)
    o = o.reshape(q.shape[:-2] + (-1,))
    out = _out_tp(o, params, cfg, mb, q_own)
    return out, _to_cache(k, kv_own, cfg, mb), _to_cache(v, kv_own, cfg, mb)


def unmasked_attention_tp(params, x, memory, cfg: ModelConfig, mb: Members):
    """Unmasked attention of the member's heads on the plain path, projected
    by ``wo`` and summed over the model axis: bidirectional self-attention
    (``memory`` None: whisper's encoder, no RoPE) or cross-attention onto
    ``memory`` (*lead, B, Sk, d), which every member holds whole.  ``x``
    as in :func:`self_attention_tp`: the member's block of S under sequence
    parallelism is gathered first, and the sum scattered on S after."""
    q, k, v, q_own, kv_own = _qkv_tp(params, mb.gather_seq(x), cfg, mb, memory)
    fold = (lambda t: t.flatten(0, mb.k))  # the mesh dims into the batch
    mask = torch.ones((1, 1, q.shape[-3], k.shape[-3]), dtype=torch.bool, device=x.device)
    o = _sdpa(fold(q), fold(_kv_for_q(k, q_own, kv_own, cfg, mb)),
              fold(_kv_for_q(v, q_own, kv_own, cfg, mb)), mask, cfg)
    return _out_tp(o.reshape(q.shape[:-2] + (-1,)), params, cfg, mb, q_own)


def _attention_decode_tp(params, x, layer_cache: KVCache, pos: int, cfg: ModelConfig,
                         window: int, mb: Members, rolling: bool = False):
    """One-token decode of the member's heads against its cache block.

    x: (*lead, B, 1, d); the cache (*lead, B, S_max, kv, hd) in the layout
    of ``policy.kv_dims``.  On kv heads, each member attends over its own;
    on ``head_dim``, the members' partial logits are summed over the model
    axis and each member's slice of the output gathered; otherwise every
    member attends over the whole cache.  A ``rolling`` cache (the
    hybrid's local attention) holds position p in slot ``p % S_max`` and
    attends over the last ``S_max`` positions.  With
    ``policy.cache_seq_axis`` the cache holds the member's block of the
    positions along that axis (:func:`_seq_split_attend`).
    """
    cd = cfg.compute_dtype
    q, k_new, v_new, q_own, kv_own = _qkv_tp(params, x, cfg, mb)
    at = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k_new = apply_rope(k_new, at, cfg.rope_theta)
    seq = mb.k + 1  # the cache's position dim
    S_max = layer_cache.k.shape[seq]
    ki = torch.arange(S_max, device=x.device)
    split = mb.policy.cache_seq_axis
    k_new, v_new = (_to_cache(t, kv_own, cfg, mb).select(seq, 0) for t in (k_new, v_new))
    if split is not None:  # slot pos on its owner, the others' slots as they are
        if rolling:
            raise NotImplementedError("a rolling cache is not cut on its sequence")
        owner, slot = divmod(pos, S_max)
        mine = M.axis_index(split) == owner
        for cache, new in ((layer_cache.k, k_new), (layer_cache.v, v_new)):
            old = cache.select(seq, slot)
            old.copy_(torch.where(M.lift(mine, old), new, old))
        ki = (M.axis_index(split) * S_max)[..., None] + ki  # global positions
    else:
        slot = pos % S_max if rolling else pos
        layer_cache.k.select(seq, slot).copy_(k_new)
        layer_cache.v.select(seq, slot).copy_(v_new)
    if rolling:
        valid = rolling_valid(ki, pos, S_max)
    else:
        valid = ki <= pos
        if window > 0:
            valid = valid & (ki > pos - window)
    valid = valid.reshape(valid.shape[:-1] + (1, 1, 1, 1) + valid.shape[-1:])  # (*lead, .., S)
    kv_s, hd_s = mb.policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    K, V = layer_cache.k.to(cd), layer_cache.v.to(cd)
    if kv_s is None and q_own:  # the cache holds every kv head: so must q
        q = mb.gather(q, -2)
        q_own = False
    Hkv = K.shape[-2]
    q5 = q.unflatten(-2, (Hkv, -1))  # (*lead, B, 1, Hkv, G, hd)
    eq = "...qkgd,...skd->...kgqs"
    if kv_s is None and hd_s is not None:
        part = torch.einsum(eq, mb.block(q5, -1).float(), K.float())
        logits = mb.psum(part) * _scale(cfg.head_dim)
        if cfg.attn_bf16_logits:
            logits = logits.bfloat16()
        logits = torch.where(valid, logits, BF16_NEG_INF if cfg.attn_bf16_logits else NEG_INF)
    else:
        logits = _masked_logits(eq, q5, K, valid, cfg)
    if split is None:
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("...kgqs,...skd->...qkgd", probs.to(cd), V)
    else:
        o = _seq_split_attend(logits, V, split).to(cd)
    if kv_s is None and hd_s is not None:
        o = mb.gather(o, -1)
    out = _out_tp(o.flatten(-3), params, cfg, mb, q_own)
    return out, layer_cache


def _seq_split_attend(logits, V, axis: str):
    """softmax(logits) @ V over a key dim cut over ``axis``: each member's
    logits (*lead, B, kv, g, 1, S_l) and values (*lead, B, S_l, kv, hd)
    are its block of the keys.  The row maximum is a ``pmax`` over the
    axis, the denominators and the weighted values are ``psum``'d: the
    log-sum-exp merge, in f32.  Returns (*lead, B, 1, kv, g, hd)."""
    shift = M.pmax(logits.detach().amax(-1, keepdim=True), axis)
    p = torch.exp((logits - shift).float())
    den = M.psum(p.sum(-1), axis)                                       # (..., kv, g, 1)
    o = M.psum(torch.einsum("...kgqs,...skd->...qkgd", p, V.float()), axis)
    return o / den.movedim(-1, -3)[..., None]
