"""RWKV-6 "Finch": attention-free time-mix with a data-dependent decay.

The port's counterpart of ``src/repro/models/rwkv6.py``.  The model is an
``nn.Module`` holding one ``ParameterDict`` per layer, run by a Python loop
where the reference scans over the layers stacked on a leading L dim.
Prefill and ``forward`` run each layer's recurrence through the
hand-written WKV kernel (``kernels/rwkv6.py:wkv``, the port of the
reference's ``chunked_wkv``), which reads the (B, S, H, hd) layout in
place, takes any S (``chunked_wkv`` asserts that its chunk divides S) and
returns the final f32 state for decode.
Decode stays the plain single-token recurrence, as in the reference.
``loss_fn`` is ``forward`` and the chunked cross-entropy against
``lm_head``; ``forward`` recomputes each layer in the backward pass when
``cfg.remat``, and ``wkv``'s gradient comes from a chunked plain form
(``kernels/rwkv6.py``).

Numbers follow the reference: r, k, v, g in the compute dtype, the decay's
LoRA and ``logw = -exp(clip(w0 + dd, -20, 2))`` in f32, the state f32; the
per-head ``ln_x`` norm is ``rms_norm(out, ln_x - 1)`` over the whole model
width at the default eps (not ``cfg.norm_eps``).  The number of heads is
``d_model // rwkv_head_size``, not ``n_heads``; ``lm_head`` is separate from
``embed``.  ``decode_step`` writes the cache's state and token shifts in
place (the reference returns new arrays).

``param_specs`` (with ``layer_specs``) gives each parameter's layout
under a ``ShardingPolicy`` by the port's names (``layers.*.<name>``, one
per-layer spec for each stacked reference leaf).  Under a sharded policy
the passes run the partitioned bodies of ``models/parallel.py`` on a
model laid out for it: the time mix is replicated (its 40 heads do not
divide a wide model axis), so every model member runs all of it, ``wkv``
on all heads of its block of the batch; the channel mix is
column-parallel in ``w_ck`` and row-parallel in ``w_cv``, its sum taken
before the replicated gate multiplies it; ``embed`` and ``lm_head`` are
vocab-parallel.  Under sequence parallelism S is gathered before each mix
and the time mix's output cut to the member's block.  The cache's state
and token shifts are whole on every model member (``cache_spec``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rwkv6 import wkv
from repro_torch.models.common import (
    REPLICATED,
    ModelConfig,
    ShardingPolicy,
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

LORA_DIM = 32


class RwkvCache(NamedTuple):
    state: torch.Tensor  # (L, B, H, hd, hd) f32 time-mix state
    shift: torch.Tensor  # (L, B, 2, d) last token for the token shift (tmix, cmix)


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_size
    return cfg.d_model // hd, hd


class Rwkv(nn.Module):
    """The parameters of one model; the passes are the module functions below."""

    def __init__(self, cfg: ModelConfig, embed, layers: list[dict], final_norm, lm_head,
                 trainable: bool = False):
        super().__init__()
        if cfg.family != "rwkv6":
            raise ValueError(f"an rwkv6 model from a {cfg.family!r} config")
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{len(layers)} layers for {cfg.n_layers}")
        self.cfg = cfg
        self.embed = param(embed)
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: param(v) for k, v in lp.items()}) for lp in layers)
        self.final_norm = param(final_norm)
        self.lm_head = param(lm_head)
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """One layer's parameters, with the reference's shapes and dtypes."""
    d, f = cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)
    pd, f32 = cfg.param_dtype, torch.float32

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "norm1": full((d,), 0.0, pd),
        "norm2": full((d,), 0.0, pd),
        "mix_rkvg": full((4, d), 0.5, f32),
        "mix_w": full((d,), 0.5, f32),
        "w_r": dense_init(gen, (d, d), pd, device),
        "w_k": dense_init(gen, (d, d), pd, device),
        "w_v": dense_init(gen, (d, d), pd, device),
        "w_g": dense_init(gen, (d, d), pd, device),
        "w_o": dense_init(gen, (d, d), pd, device),
        "w0": full((d,), -5.0, f32),
        "w_lora_a": dense_init(gen, (d, LORA_DIM), f32, device),
        "w_lora_b": dense_init(gen, (LORA_DIM, d), f32, device, scale=0.1),
        "bonus_u": full((H, hd), 0.0, f32),
        "ln_x": full((d,), 1.0, f32),
        "mix_c": full((2, d), 0.5, f32),
        "w_ck": dense_init(gen, (d, f), pd, device),
        "w_cv": dense_init(gen, (f, d), pd, device),
        "w_cr": dense_init(gen, (d, d), pd, device),
    }


def init(gen: torch.Generator, cfg: ModelConfig, device=None, trainable: bool = False) -> Rwkv:
    """Random weights drawn from ``gen`` on ``device`` (None means CUDA, and
    raises without a card), requiring gradients when ``trainable``."""
    device = resolve_device(device)
    layers = [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)]
    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    lm_head = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    final_norm = torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device)
    return Rwkv(cfg, embed, layers, final_norm, lm_head, trainable)


# ---------------------------------------------------------------------------
# Time mix and channel mix
# ---------------------------------------------------------------------------


def layer_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    f = cfg.d_ff
    rep = (None, None)
    return {
        "norm1": (None,), "norm2": (None,),
        "mix_rkvg": rep, "mix_w": (None,),
        # time-mix replicated: 40 heads % 16 != 0
        "w_r": rep, "w_k": rep, "w_v": rep, "w_g": rep, "w_o": rep,
        "w0": (None,), "w_lora_a": rep, "w_lora_b": rep,
        "bonus_u": rep, "ln_x": (None,),
        "mix_c": rep,
        "w_ck": policy.w_col(f), "w_cv": policy.w_row(f), "w_cr": rep,
    }


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each parameter's spec under ``policy``, by reference leaf."""
    specs = {f"layers.*.{k}": v for k, v in layer_specs(cfg, policy).items()}
    specs.update({"embed": policy.embed(cfg.padded_vocab), "final_norm": (None,),
                  "lm_head": policy.embed(cfg.padded_vocab)})
    return specs


def _token_shift(x, prev):
    """x[t-1] with ``prev`` at t = 0.  x: (..., S, d); prev: (..., d)."""
    return torch.cat([prev[..., None, :], x[..., :-1, :]], dim=-2)


def _tmix_inputs(lp, x, prev, cfg: ModelConfig):
    cd = cfg.compute_dtype
    xs = _token_shift(x, prev)
    mr, mk, mv, mg = lp["mix_rkvg"].to(cd)
    xr = x * mr + xs * (1 - mr)
    xk = x * mk + xs * (1 - mk)
    xv = x * mv + xs * (1 - mv)
    xg = x * mg + xs * (1 - mg)
    mw = lp["mix_w"].to(cd)
    xw = x * mw + xs * (1 - mw)
    r = xr @ lp["w_r"].to(cd)
    k = xk @ lp["w_k"].to(cd)
    v = xv @ lp["w_v"].to(cd)
    g = F.silu(xg @ lp["w_g"].to(cd))
    # the data-dependent decay, in f32
    dd = torch.tanh(xw.float() @ lp["w_lora_a"].float()) @ lp["w_lora_b"].float()
    logw = -torch.exp(torch.clamp(lp["w0"].float() + dd, -20.0, 2.0))  # log(decay) <= 0
    return r, k, v, g, logw


def time_mix(lp, x, prev, state0, cfg: ModelConfig):
    """Returns (out (B, S, d), final state, last input token for the shift)."""
    B, S, d = x.shape
    H, hd = _heads(cfg)
    cd = cfg.compute_dtype
    r, k, v, g, logw = _tmix_inputs(lp, x, prev, cfg)
    out, state = wkv(r.reshape(B, S, H, hd), k.reshape(B, S, H, hd), v.reshape(B, S, H, hd),
                     logw.reshape(B, S, H, hd), lp["bonus_u"], state0)
    out = rms_norm(out.reshape(B, S, d).to(cd), lp["ln_x"].to(cd) - 1.0)
    out = out * g
    return out @ lp["w_o"].to(cd), state, x[:, -1]


def channel_mix(lp, x, prev, cfg: ModelConfig):
    """Returns (out (B, S, d), last input token for the shift)."""
    cd = cfg.compute_dtype
    xs = _token_shift(x, prev)
    mk, mr = lp["mix_c"].to(cd)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    kk = torch.square(F.relu(xk @ lp["w_ck"].to(cd)))
    kv = kk @ lp["w_cv"].to(cd)
    return torch.sigmoid(xr @ lp["w_cr"].to(cd)) * kv, x[:, -1]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _logits(model: Rwkv, x, cfg: ModelConfig) -> torch.Tensor:
    """The last token's logits in f32 over the padded vocab."""
    x = rms_norm(x[:, -1], model.final_norm, cfg.norm_eps)
    return x.float() @ model.lm_head.float().T


def _layer(lp, x, cfg: ModelConfig):
    """One layer from a zero state: (x after the layer, state, shifts)."""
    zeros_prev = torch.zeros((x.shape[0], cfg.d_model), dtype=cfg.compute_dtype,
                             device=x.device)
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    h, state, shift_t = time_mix(lp, h, zeros_prev, None, cfg)
    x = x + h
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    h, shift_c = channel_mix(lp, h, zeros_prev, cfg)
    return x + h, state, torch.stack([shift_t, shift_c], dim=1)


def _layer_out(lp, x, cfg: ModelConfig):
    return _layer(lp, x, cfg)[0]


def forward(model: Rwkv, tokens, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """tokens: (B, S) -> (hidden (B, S, d), aux loss)."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x = _forward_tp(model, tokens, cfg, mb)
            return mb.unshard_batch(mb.gather_seq(x)), torch.zeros((), device=x.device)
    x = model.embed[tokens].to(cfg.compute_dtype)
    layer = maybe_remat(_layer_out, cfg.remat)
    for lp in model.layers:
        x = layer(lp, x, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def loss_fn(model: Rwkv, batch: dict, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S));
    under a sharding policy vocab-parallel, as ``transformer.loss_fn``."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x = _forward_tp(model, batch["tokens"], cfg, mb)
            loss = chunked_cross_entropy(mb.gather_seq(x), model.lm_head,
                                         mb.shard_batch(batch["labels"]), cfg, mb)
            return mb.backward_loss(loss)
    hidden, _ = forward(model, batch["tokens"], cfg)
    return chunked_cross_entropy(hidden, model.lm_head, batch["labels"], cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, device=None) -> RwkvCache:
    H, hd = _heads(cfg)
    return RwkvCache(
        state=torch.zeros((cfg.n_layers, batch, H, hd, hd), dtype=torch.float32, device=device),
        shift=torch.zeros((cfg.n_layers, batch, 2, cfg.d_model), dtype=cfg.compute_dtype,
                          device=device))


def prefill(model: Rwkv, tokens, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED,
            max_len: int | None = None):
    """Full-sequence prefill; returns (last-token logits, cache).  The cache
    is O(1) in the sequence: ``max_len`` is accepted and unused."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            return _prefill_tp(model, tokens, cfg, Members(policy))
    B, _ = tokens.shape
    x = model.embed[tokens].to(cfg.compute_dtype)
    cache = init_cache(cfg, B, device=x.device)
    for i, lp in enumerate(model.layers):
        x, cache.state[i], cache.shift[i] = _layer(lp, x, cfg)
    return _logits(model, x, cfg), cache


def decode_step(model: Rwkv, cache: RwkvCache, tokens, pos: int, cfg: ModelConfig,
                policy: ShardingPolicy = REPLICATED):
    """One decode step, the plain recurrence.  tokens: (B, 1).

    Writes each layer's state and shifts into ``cache`` in place and
    returns (logits, cache).  ``pos`` is not needed by the recurrence.
    """
    del pos
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            # one token: no sequence to split
            return _decode_tp(model, cache, tokens, cfg,
                              Members(dataclasses.replace(policy, seq_axis=None)))
    B = tokens.shape[0]
    H, hd = _heads(cfg)
    cd = cfg.compute_dtype
    x = model.embed[tokens].to(cd)  # (B, 1, d)
    for i, lp in enumerate(model.layers):
        state0, shifts = cache.state[i], cache.shift[i]
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        r, k, v, g, logw = _tmix_inputs(lp, h, shifts[:, 0], cfg)
        rh, kh, vh = (t.reshape(B, H, hd).float() for t in (r, k, v))
        w = torch.exp(logw.reshape(B, H, hd).float())
        kv = kh[..., :, None] * vh[..., None, :]
        out = torch.einsum("bhi,bhij->bhj", rh, state0 + lp["bonus_u"].float()[..., None] * kv)
        state = w[..., None] * state0 + kv
        o = rms_norm(out.reshape(B, 1, -1).to(cd), lp["ln_x"].to(cd) - 1.0)
        x = x + (o * g) @ lp["w_o"].to(cd)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        h2o, shift_c = channel_mix(lp, h2, shifts[:, 1], cfg)
        x = x + h2o
        cache.state[i] = state
        cache.shift[i] = torch.stack([h[:, -1], shift_c], dim=1)
    return _logits(model, x, cfg), cache


# ---------------------------------------------------------------------------
# Under a sharding policy (models/parallel.py): the member's tensors
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> RwkvCache:
    """The cache's layout: ``state`` (L, B, H, hd, hd) whole on each model
    member, as the reference's; ``shift`` (L, B, 2, d) whole too (the
    reference splits d over the model axis, where the port's decode would
    gather it again at once: every member's token shift reads the whole
    previous token)."""
    b = policy.batch_axes or None
    return RwkvCache(state=(None, b, None, None, None), shift=(None, b, None, None))



def _rows(mix, n: int, like, mb: Members):
    """The n rows of a (*lead, n, d) mix parameter, each against ``like``."""
    return [mb.bcast(mix.select(mb.k, j), like) for j in range(n)]


def _tmix_inputs_tp(lp, x, prev, cfg: ModelConfig, mb: Members):
    """``_tmix_inputs`` on the member's tensors: x (*lead, B, S, d), prev
    (*lead, B, d); the whole time mix's weights on every member."""
    cd = cfg.compute_dtype
    xs = _token_shift(x, prev)
    mr, mk, mv, mg = _rows(lp["mix_rkvg"].to(cd), 4, x, mb)
    xr = x * mr + xs * (1 - mr)
    xk = x * mk + xs * (1 - mk)
    xv = x * mv + xs * (1 - mv)
    xg = x * mg + xs * (1 - mg)
    mw = mb.bcast(lp["mix_w"].to(cd), x)
    xw = x * mw + xs * (1 - mw)
    r = mb.mm(xr, lp["w_r"].to(cd))
    k = mb.mm(xk, lp["w_k"].to(cd))
    v = mb.mm(xv, lp["w_v"].to(cd))
    g = F.silu(mb.mm(xg, lp["w_g"].to(cd)))
    dd = mb.mm(torch.tanh(mb.mm(xw.float(), lp["w_lora_a"].float())), lp["w_lora_b"].float())
    logw = -torch.exp(torch.clamp(mb.bcast(lp["w0"].float(), dd) + dd, -20.0, 2.0))
    return r, k, v, g, logw


def _bonus(lp, mb: Members):
    """``bonus_u`` (H, hd) for the ``wkv`` kernel, which takes one for the
    whole batch: on the stacked mesh the first member's copy (the copies
    are equal; the gradient of every member's use lands on it, and
    ``core.mesh.sum_copies`` sums the copies into the global gradient)."""
    u = lp["bonus_u"]
    return u.flatten(0, mb.k - 1)[0] if mb.k else u


def _time_mix_tp(lp, x, cfg: ModelConfig, mb: Members):
    """The whole time mix from a zero state on every member, ``wkv`` over
    the mesh dims and B folded: x (*lead, B, S, d) over the whole of S ->
    (out, final state (*lead, B, H, hd, hd), last input token)."""
    H, hd = _heads(cfg)
    cd = cfg.compute_dtype
    lead = x.shape[:-2]
    prev = torch.zeros(lead + (cfg.d_model,), dtype=cd, device=x.device)
    r, k, v, g, logw = _tmix_inputs_tp(lp, x, prev, cfg, mb)

    def heads(t):  # (*lead, B, S, d) -> (N, S, H, hd), a view
        return t.flatten(0, mb.k).unflatten(-1, (H, hd))

    out, state = wkv(heads(r), heads(k), heads(v), heads(logw), _bonus(lp, mb), None)
    out = rms_norm(out.reshape(x.shape).to(cd), mb.bcast(lp["ln_x"].to(cd), x) - 1.0)
    return mb.mm(out * g, lp["w_o"].to(cd)), state.reshape(lead + state.shape[1:]), x[..., -1, :]


def _channel_mix_tp(lp, x, prev, cfg: ModelConfig, mb: Members):
    """The channel mix of the whole of S (x, prev as in ``_tmix_inputs_tp``):
    ``relu(xk @ w_ck[:, own])^2 @ w_cv[own]`` summed by ``row_out`` before
    the replicated gate multiplies it, as the reference orders it; under
    sequence parallelism the gate and the sum are the member's block of S.
    Returns (out, last input token)."""
    cd = cfg.compute_dtype
    xs = _token_shift(x, prev)
    mk, mr = _rows(lp["mix_c"].to(cd), 2, x, mb)
    xk = x * mk + xs * (1 - mk)
    xr = x * mr + xs * (1 - mr)
    kk = torch.square(F.relu(mb.mm(xk, lp["w_ck"].to(cd))))
    kv = mb.row_out(mb.mm(kk, lp["w_cv"].to(cd)),
                    mb.split(layer_specs(cfg, mb.policy)["w_cv"]))
    gate = torch.sigmoid(mb.mm(mb.row_out(xr, False), lp["w_cr"].to(cd)))
    return gate * kv, x[..., -1, :]


def _layer_tp(lp, x, cfg: ModelConfig, mb: Members):
    """One layer from a zero state on the member's tensors: (x, state,
    shifts (*lead, B, 2, d)).  Under sequence parallelism S is gathered
    before each mix (the shift and the recurrence need it) and the time
    mix's output cut to the member's block.  It enters the mesh itself,
    since its remat recompute runs in the backward pass."""
    with mb.mesh:
        h = mb.gather_seq(rms_norm_tp(x, lp["norm1"], cfg, mb))
        o, state, shift_t = _time_mix_tp(lp, h, cfg, mb)
        x = x + mb.row_out(o, False)
        h = mb.gather_seq(rms_norm_tp(x, lp["norm2"], cfg, mb))
        o, shift_c = _channel_mix_tp(lp, h, torch.zeros_like(shift_t), cfg, mb)
        return x + o, state, torch.stack([shift_t, shift_c], dim=-2)


def _layer_out_tp(lp, x, cfg: ModelConfig, mb: Members):
    return _layer_tp(lp, x, cfg, mb)[0]


def _forward_tp(model: Rwkv, tokens, cfg: ModelConfig, mb: Members):
    x = vocab_embed(model.embed, tokens, cfg, mb)
    layer = maybe_remat(_layer_out_tp, cfg.remat)
    for lp in model.layers:
        x = layer(lp, x, cfg, mb)
    return rms_norm_tp(x, model.final_norm, cfg, mb)


def _logits_tp(model: Rwkv, x, cfg: ModelConfig, mb: Members):
    x = last_token(x, mb)
    return vocab_logits(rms_norm_tp(x, model.final_norm, cfg, mb), model.lm_head, cfg, mb)


def _prefill_tp(model: Rwkv, tokens, cfg: ModelConfig, mb: Members):
    """The sharded prefill: the cache (*lead, L, B / batch, ...) in the
    layout of :func:`cache_spec`."""
    x = vocab_embed(model.embed, tokens, cfg, mb)
    at = (slice(None),) * mb.k
    cache = None
    for i, lp in enumerate(model.layers):
        x, state, shifts = _layer_tp(lp, x, cfg, mb)
        if cache is None:
            lead, L = state.shape[:mb.k], cfg.n_layers
            cache = RwkvCache(state=state.new_zeros(lead + (L,) + state.shape[mb.k:]),
                              shift=shifts.new_zeros(lead + (L,) + shifts.shape[mb.k:]))
        cache.state[at + (i,)] = state
        cache.shift[at + (i,)] = shifts
    return _logits_tp(model, x, cfg, mb), cache


def _decode_tp(model: Rwkv, cache: RwkvCache, tokens, cfg: ModelConfig, mb: Members):
    """One token of the plain recurrence on every member's whole state."""
    H, hd = _heads(cfg)
    cd = cfg.compute_dtype
    at = (slice(None),) * mb.k
    x = vocab_embed(model.embed, tokens, cfg, mb)  # (*lead, B, 1, d)
    for i, lp in enumerate(model.layers):
        state0, shifts = cache.state[at + (i,)], cache.shift[at + (i,)]
        h = rms_norm_tp(x, lp["norm1"], cfg, mb)
        r, k, v, g, logw = _tmix_inputs_tp(lp, h, shifts[..., 0, :], cfg, mb)
        rh, kh, vh = (t[..., 0, :].unflatten(-1, (H, hd)).float() for t in (r, k, v))
        w = torch.exp(logw[..., 0, :].unflatten(-1, (H, hd)).float())
        kv = kh[..., :, None] * vh[..., None, :]
        u = mb.bcast(lp["bonus_u"].float()[..., None], kv)
        out = torch.einsum("...hi,...hij->...hj", rh, state0 + u * kv)
        state = w[..., None] * state0 + kv
        o = rms_norm(out.flatten(-2)[..., None, :].to(cd), mb.bcast(lp["ln_x"].to(cd), x) - 1.0)
        x = x + mb.mm(o * g, lp["w_o"].to(cd))
        h2 = rms_norm_tp(x, lp["norm2"], cfg, mb)
        h2o, shift_c = _channel_mix_tp(lp, h2, shifts[..., 1, :], cfg, mb)
        x = x + h2o
        cache.state[at + (i,)] = state
        cache.shift[at + (i,)] = torch.stack([h[..., -1, :], shift_c], dim=-2)
    return _logits_tp(model, x, cfg, mb), cache
