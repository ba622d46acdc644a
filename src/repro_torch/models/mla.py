"""Multi-head latent attention (MLA, DeepSeek-V2 arXiv:2405.04434 §2.1), as
DeepSeek-V3 and Moonlight-16B-A3B publish it with no query compression.

With ``h`` a layer's normed input and H heads:

* ``q = h @ wq``, each head ``qk_nope_head_dim + qk_rope_head_dim`` wide,
  its last ``qk_rope_head_dim`` columns rotated by RoPE;
* ``h @ wkv_a`` gives the latent ``c`` (``kv_lora_rank`` wide, RMS-normed by
  ``kv_norm`` at eps 1e-6, the published module's default) and one rope
  key ``k_pe`` (``qk_rope_head_dim``, rotated) shared by every head;
* ``c @ wkv_b`` gives each head's ``k_nope`` and ``v`` (``v_head_dim``);
  the head's key is ``[k_nope, k_pe]``;
* causal attention at ``1 / sqrt(qk_nope + qk_rope)`` through the flash
  kernel (q and k 192 wide, v 128 at Moonlight's widths), then ``o @ wo``.

RoPE rotates halves (``models/rope.py``), where the published checkpoint
stores its rope columns interleaved: a fixed permutation of those weights'
columns, which random weights do not see.

Under a sharding policy with a model axis (``models/parallel.py``) ``wq``
and ``wkv_b`` split their columns by whole heads and ``wo`` its rows, its
product summed over the axis (under sequence parallelism: S gathered
before the projections, the sum scattered on S after ``wo``); ``wkv_a``
and ``kv_norm`` are replicated, every member projecting the latent of the
whole sequence, and the copies' gradients are summed over the axis
(``core.mesh.sum_copies``).  The whole block is the traced region ``mla``.
Serving (a latent KV cache) is not ported.
"""

from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import REPLICATED, ModelConfig, ShardingPolicy, dense_init, rms_norm
from repro_torch.models.parallel import Members, is_sharded
from repro_torch.models.rope import apply_rope

LATENT_EPS = 1e-6  # the latent norm's eps: the published RMSNorm module's default


def init_mla_params(gen, cfg: ModelConfig, device=None) -> dict:
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dt = cfg.param_dtype
    return {
        "wq": dense_init(gen, (d, H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)), dt, device),
        "wkv_a": dense_init(gen, (d, r + cfg.qk_rope_head_dim), dt, device),
        "kv_norm": torch.zeros((r,), dtype=dt, device=device or gen.device),
        "wkv_b": dense_init(gen, (r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), dt, device),
        "wo": dense_init(gen, (H * cfg.v_head_dim, d), dt, device),
    }


def mla_param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    heads = policy._model_if_divisible(cfg.n_heads)  # whole heads or nothing
    return {"wq": (None, heads), "wkv_a": (None, None), "kv_norm": (None,),
            "wkv_b": (None, heads), "wo": (heads, None)}


def _qkv(params, x, positions, cfg: ModelConfig, mm, norm):
    """q, k (..., S, heads, qk_nope + qk_rope) and v (..., S, heads, v_head_dim) of
    ``x`` (..., S, d), on the heads that ``wq`` / ``wkv_b`` hold; ``mm`` and
    ``norm`` are the products and the latent's RMS norm (per member or
    plain)."""
    cd = cfg.compute_dtype
    nope, rope, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = mm(x, params["wq"].to(cd)).unflatten(-1, (-1, nope + rope))
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)], -1)
    kv_a = mm(x, params["wkv_a"].to(cd))
    k_pe = apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)  # one head, shared
    kv = mm(norm(kv_a[..., :r], params["kv_norm"]), params["wkv_b"].to(cd))
    kv = kv.unflatten(-1, (-1, nope + cfg.v_head_dim))
    k = torch.cat([kv[..., :nope], k_pe.expand(kv.shape[:-1] + (rope,))], -1)
    return q, k, kv[..., nope:]


def _causal(q, k, v):
    """Causal attention through the flash kernel: q, k (B, S, H, dqk), v
    (B, S, H, dv) -> (B, S, H * dv)."""
    B, S, H, _ = q.shape

    def heads_first(t):
        return t.transpose(1, 2).reshape(B * H, S, t.shape[-1]).contiguous()

    out = flash_attention(heads_first(q), heads_first(k), heads_first(v))
    return out.reshape(B, H, S, -1).transpose(1, 2).reshape(B, S, -1)


def attention(params, x, positions, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """MLA over a full sequence (training): the region ``mla``."""
    if cfg.attn_bf16_logits:
        raise NotImplementedError("MLA takes the flash kernel: attn_bf16_logits is not ported")
    if is_sharded(policy):
        return tracing.region("mla", _attention_tp, params, x, positions, cfg, Members(policy))
    return tracing.region("mla", _attention, params, x, positions, cfg)


def _attention(params, x, positions, cfg: ModelConfig):
    q, k, v = _qkv(params, x, positions, cfg, torch.matmul,
                   lambda c, s: rms_norm(c, s, LATENT_EPS))
    return _causal(q, k, v) @ params["wo"].to(cfg.compute_dtype)


def _attention_tp(params, x, positions, cfg: ModelConfig, mb: Members):
    """The member's heads on ``x`` (*lead, B, S or its block, d), projected
    by its rows of ``wo`` and summed over the model axis."""
    q, k, v = _qkv(params, mb.gather_seq(x), positions, cfg, mb.mm,
                   lambda c, s: rms_norm(c, mb.bcast(s, c), LATENT_EPS))
    fold = (lambda t: t.flatten(0, mb.k))  # the mesh dims into the batch
    o = _causal(fold(q), fold(k), fold(v)).reshape(q.shape[:-2] + (-1,))
    out = mb.mm(o, params["wo"].to(cfg.compute_dtype))
    return mb.row_out(out, mb.split(mla_param_specs(cfg, mb.policy)["wo"]))
