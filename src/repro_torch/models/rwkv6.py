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
per-layer spec for each stacked reference leaf).  rwkv6's sharded
execution is not ported yet (ROADMAP.md): its passes raise on a sharded
policy.
"""

from __future__ import annotations

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
from repro_torch.models.parallel import model_axis_raise

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
    """x[t-1] with ``prev`` at t = 0.  x: (B, S, d); prev: (B, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


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
    model_axis_raise("rwkv6", policy, model)
    x = model.embed[tokens].to(cfg.compute_dtype)
    layer = maybe_remat(_layer_out, cfg.remat)
    for lp in model.layers:
        x = layer(lp, x, cfg)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, torch.zeros((), device=x.device)


def loss_fn(model: Rwkv, batch: dict, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S))."""
    model_axis_raise("rwkv6", policy, model)
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
    model_axis_raise("rwkv6", policy, model)
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
    model_axis_raise("rwkv6", policy, model)
    del pos
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
