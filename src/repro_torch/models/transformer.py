"""Decoder-only transformer LM: the dense / GQA / local-global / MoE archs.

The port's counterpart of ``src/repro/models/transformer.py``.  The model
is an ``nn.Module`` of per-layer blocks, run by a Python loop where the
reference scans over stacked layers; each layer's attention window is a
Python int from ``layer_windows_list`` (gemma3's local:global pattern).
``forward`` gives the hidden states, ``prefill`` the last token's logits
and the KV cache, ``decode_step`` one token's logits with the cache
written in place.  Causal self-attention runs through the flash kernel
(``models/attention.py``).  ``loss_fn`` is ``forward`` and the chunked
cross-entropy against ``embed`` (tied) or ``lm_head``; ``forward``
recomputes each layer in the backward pass when ``cfg.remat``.  With
``cfg.n_experts`` each layer's MLP is the capacity-routed MoE
(``models/mlp.py:moe``): ``forward`` sums its load-balance aux loss over
the layers, and ``prefill`` / ``decode_step`` drop it, as the reference
does.  The port's own DeepSeek-V3 layers (``cfg.kv_lora_rank``,
``cfg.first_k_dense``): each layer's attention is MLA (``models/mla.py``),
the first ``first_k_dense`` layers hold a dense MLP and the rest the MoE
with its shared experts and selection bias (a buffer of the ``Block``);
they train only (``prefill`` and ``decode_step`` raise).

Parameters require gradients only in a model built with ``trainable=True``.

``param_specs`` gives each parameter's layout under a ``ShardingPolicy``,
keyed by the port's names (``models.convert.reference_leaves``: one spec
for each of ``blocks.*.attn.wq``, ...).  ``forward``, ``prefill`` and
``decode_step`` take the reference's ``policy``: with a sharded one, the
model must have been laid out for it (``models.convert.shard_model``) and
the passes run its partitioned bodies under ``with model.mesh:``
(``models/parallel.py``).  They take and return global tensors: the tokens
are split over ``policy.batch_axes``; the embedding is vocab-parallel (a
masked lookup of the member's rows, summed over the model axis); the
head's logits are computed in f32 on the member's vocab slice and gathered
over the model axis.  The KV cache stays sharded on the mesh: (*mesh dims,
L, B / batch, S_max, kv, hd) with kv or hd split as ``policy.kv_dims``
says (``cache_spec``).  With sequence parallelism (``seq_axis``, the model
axis) the activations between blocks hold the member's block of S:
the embedding's sum over the model axis becomes a ``psum_scatter`` on S,
attention and the MLP gather S first and scatter their sums on S after,
and ``decode_step`` (one token) runs as without it.  ``loss_fn`` under a
policy is vocab-parallel and differentiable on both mesh kinds
(``models/parallel.py`` states the gradient convention).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import tracing
from repro_torch.core import mesh as M
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    REPLICATED,
    ModelConfig,
    ShardingPolicy,
    chunked_cross_entropy,
    embed_init,
    maybe_remat,
    param,
    resolve_device,
    rms_norm,
)
from repro_torch.models.parallel import (Members, check_layout, last_token, rms_norm_tp,
                                          vocab_embed, vocab_logits)


def layer_windows_list(cfg: ModelConfig) -> list[int]:
    """Per-layer attention window (0 = full causal)."""
    L = cfg.n_layers
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        return [0 if (i + 1) % (r + 1) == 0 else cfg.attn_window for i in range(L)]
    if cfg.attn_window > 0:
        return [cfg.attn_window] * L
    return [0] * L


class Block(nn.Module):
    """One layer: pre-norm attention (GQA, or MLA's weights with
    ``cfg.kv_lora_rank``) and a pre-norm gated MLP (``mlp``) or MoE
    (``moe``, with its ``shared`` experts' MLP when the config has them),
    both residual.  ``router_bias`` is the MoE's selection bias, a buffer
    (no gradient, not an AdamW leaf) that the trainer moves after each
    step (``mlp.update_router_biases``)."""

    def __init__(self, norm1, norm2, attn: dict, mlp: dict | None = None,
                 moe: dict | None = None, shared: dict | None = None, router_bias=None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block holds either an mlp or a moe")
        self.norm1 = param(norm1)
        self.norm2 = param(norm2)
        self.attn = nn.ParameterDict({k: param(v) for k, v in attn.items()})
        self.mlp = None if mlp is None else nn.ParameterDict(
            {k: param(v) for k, v in mlp.items()})
        self.moe = None if moe is None else nn.ParameterDict(
            {k: param(v) for k, v in moe.items()})
        self.shared = None if shared is None else nn.ParameterDict(
            {k: param(v) for k, v in shared.items()})
        self.register_buffer("router_bias", router_bias)

    def attention(self, h, positions, window: int, cfg: ModelConfig,
                  policy: ShardingPolicy = REPLICATED):
        """Self-attention on the normed ``h``, projected: MLA or GQA."""
        if cfg.kv_lora_rank:
            return mla_mod.attention(self.attn, h, positions, cfg, policy)
        return attn_mod.attention(self.attn, h, positions, cfg, window=window, policy=policy)

    def ffn(self, h, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
        """The MLP or MoE on the normed ``h``: (out, aux loss or None)."""
        if self.moe is not None:
            return mlp_mod.moe(self.moe, h, cfg, policy, self.router_bias, self.shared)
        return mlp_mod.mlp(self.mlp, h, cfg, policy), None


class Transformer(nn.Module):
    """The parameters of one model; the passes are the module functions below."""

    def __init__(self, cfg: ModelConfig, embed, blocks: list[Block], final_norm,
                 lm_head=None, trainable: bool = False):
        super().__init__()
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{len(blocks)} blocks for {cfg.n_layers} layers")
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given iff the embeddings are not tied")
        self.cfg = cfg
        self.embed = param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = param(final_norm)
        self.lm_head = None if lm_head is None else param(lm_head)
        self.requires_grad_(trainable)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init(gen: torch.Generator, cfg: ModelConfig, device=None,
         trainable: bool = False) -> Transformer:
    """Random weights drawn from ``gen`` on ``device`` (None means CUDA,
    and raises without a card), requiring gradients when ``trainable``.
    Norm scales start at zero, as in the reference (the norm scales by
    ``1 + scale``)."""
    device = resolve_device(device)

    def zeros():
        return torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=device)

    embed = embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)

    def attn():
        if cfg.kv_lora_rank:
            return mla_mod.init_mla_params(gen, cfg, device)
        return attn_mod.init_attn_params(gen, cfg, device)

    def ffn(i):
        if not cfg.is_moe_layer(i):
            return {"mlp": mlp_mod.init_mlp_params(gen, cfg, device)}
        out = {"moe": mlp_mod.init_moe_params(gen, cfg, device),
               "router_bias": _router_bias(cfg, i, device)}
        if cfg.n_shared_experts:
            out["shared"] = mlp_mod.init_mlp_params(gen, cfg, device, d_ff=cfg.shared_ff)
        return out

    blocks = [Block(zeros(), zeros(), attn(), **ffn(i)) for i in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else embed_init(
        gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    return Transformer(cfg, embed, blocks, zeros(), lm_head, trainable)


def from_named(cfg: ModelConfig, tensors: dict, trainable: bool = False) -> Transformer:
    """A model holding ``tensors`` by parameter name (as ``named_parameters``
    names them: ``blocks.3.attn.wq``, ...), the selection biases at zero."""
    def group(i, name):
        head = f"blocks.{i}.{name}."
        found = {k[len(head):]: t for k, t in tensors.items() if k.startswith(head)}
        return found or None

    embed = tensors["embed"]
    blocks = [Block(tensors[f"blocks.{i}.norm1"], tensors[f"blocks.{i}.norm2"], group(i, "attn"),
                    mlp=group(i, "mlp"), moe=group(i, "moe"), shared=group(i, "shared"),
                    router_bias=_router_bias(cfg, i, embed.device))
              for i in range(cfg.n_layers)]
    return Transformer(cfg, embed, blocks, tensors["final_norm"], tensors.get("lm_head"),
                       trainable)


def _router_bias(cfg: ModelConfig, i: int, device):
    """Layer ``i``'s selection bias, zero, where the config moves one; else None."""
    if cfg.is_moe_layer(i) and cfg.router_bias_rate:
        return torch.zeros((cfg.n_experts,), dtype=torch.float32, device=device)
    return None


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Each parameter's spec under ``policy``, by reference leaf: a
    per-layer spec for ``blocks.*.<name>`` (the reference's stacked spec
    without its leading layer dim)."""
    ffns = []
    if cfg.n_experts:
        ffns.append(("moe", mlp_mod.moe_param_specs(cfg, policy)))
        if cfg.n_shared_experts:
            ffns.append(("shared", mlp_mod.mlp_param_specs(mlp_mod.shared_cfg(cfg), policy)))
    if not cfg.n_experts or cfg.first_k_dense:
        ffns.append(("mlp", mlp_mod.mlp_param_specs(cfg, policy)))
    attn_specs = (mla_mod.mla_param_specs if cfg.kv_lora_rank else attn_mod.attn_param_specs)
    specs = {"embed": policy.embed(cfg.padded_vocab), "final_norm": (None,),
             "blocks.*.norm1": (None,), "blocks.*.norm2": (None,)}
    specs.update({f"blocks.*.attn.{k}": v for k, v in attn_specs(cfg, policy).items()})
    for ffn, ffn_specs in ffns:
        specs.update({f"blocks.*.{ffn}.{k}": v for k, v in ffn_specs.items()})
    if not cfg.tie_embeddings:
        specs["lm_head"] = policy.embed(cfg.padded_vocab)
    return specs


def cache_spec(cfg: ModelConfig, policy: ShardingPolicy) -> tuple:
    """The layout of the KV cache's k and v, (L, B, S_max, kv, hd): the
    sequence over ``policy.cache_seq_axis`` (the long-context decode)."""
    kv_s, hd_s = policy.kv_dims(cfg.n_kv_heads, cfg.head_dim)
    return (None, policy.batch_axes or None, policy.cache_seq_axis, kv_s, hd_s)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _serves(cfg: ModelConfig):
    """MLA trains only: its latent KV cache is not ported."""
    if cfg.kv_lora_rank:
        raise NotImplementedError(f"{cfg.name}: serving MLA (a latent KV cache) is not ported")


def _logits(model: Transformer, x, cfg: ModelConfig) -> torch.Tensor:
    """The last token's logits in f32 over the padded vocab."""
    x = rms_norm(x[:, -1], model.final_norm, cfg.norm_eps)
    return x.float() @ model.head.float().T


def _layer(blk: Block, x, positions, window: int, cfg: ModelConfig):
    """One layer: (x, aux loss), the aux zero without the MoE."""
    h = rms_norm(x, blk.norm1, cfg.norm_eps)
    x = x + blk.attention(h, positions, window, cfg)
    h = rms_norm(x, blk.norm2, cfg.norm_eps)
    h, aux = blk.ffn(h, cfg)
    return x + h, torch.zeros((), device=x.device) if aux is None else aux


def forward(model: Transformer, tokens, cfg: ModelConfig,
            policy: ShardingPolicy = REPLICATED):
    """tokens: (B, S) -> (hidden (B, S, d), aux loss summed over layers)."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x, aux = _forward_tp(model, tokens, cfg, mb)
            return mb.unshard_batch(mb.gather_seq(x)), mb.first(aux)
    B, S = tokens.shape
    x = model.embed[tokens].to(cfg.compute_dtype)
    return tracing.region("blocks", _blocks, model, x, _positions(B, S, x.device), cfg)


def _blocks(model: Transformer, x, positions, cfg: ModelConfig):
    """The layers and the final norm on the embedded ``x``: (hidden, aux
    loss summed over the layers)."""
    layer = maybe_remat(_layer, cfg.remat)
    aux = torch.zeros((), device=x.device)
    for blk, window in zip(model.blocks, layer_windows_list(cfg)):
        x, a = layer(blk, x, positions, window, cfg)
        aux = aux + a
    return rms_norm(x, model.final_norm, cfg.norm_eps), aux


def loss_fn(model: Transformer, batch: dict, cfg: ModelConfig,
            policy: ShardingPolicy = REPLICATED):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S))
    plus ``cfg.aux_loss_coef`` (0.01 by default) of the MoE's aux loss
    (zero without the MoE).

    Under a sharding policy the loss is vocab-parallel
    (``chunked_cross_entropy`` on the member's rows of the head) and the
    value is the global loss, set up for the backward as
    ``Members.backward_loss`` says: the gradients of the laid-out
    parameters are each copy's share, which ``core.mesh.sum_copies`` sums
    into the global gradient."""
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            mb = Members(policy)
            x, aux = _forward_tp(model, batch["tokens"], cfg, mb)
            loss = chunked_cross_entropy(mb.gather_seq(x), model.head,
                                         mb.shard_batch(batch["labels"]), cfg, mb)
            return mb.backward_loss(loss + cfg.aux_loss_coef * aux)
    hidden, aux = forward(model, batch["tokens"], cfg)
    loss = chunked_cross_entropy(hidden, model.head, batch["labels"], cfg)
    return loss + cfg.aux_loss_coef * aux


def prefill(model: Transformer, tokens, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED,
            max_len: int | None = None):
    """Full-sequence prefill; returns (last-token logits, KV cache).

    The cache holds the keys after RoPE and the values for positions
    ``[0, S)``, zero up to ``max_len``.
    """
    _serves(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            return _prefill_tp(model, tokens, cfg, max_len, Members(policy))
    cd = cfg.compute_dtype
    x = model.embed[tokens].to(cd)
    positions = _positions(B, S, x.device)
    cache = attn_mod.init_cache(cfg, B, max_len, cfg.n_layers, device=x.device)
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows_list(cfg))):
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        o, kr, v = attn_mod.self_attention(blk.attn, h, positions, cfg, window=window)
        x = x + o @ blk.attn["wo"].to(cd)
        h = rms_norm(x, blk.norm2, cfg.norm_eps)
        x = x + blk.ffn(h, cfg)[0]
        cache.k[i, :, :S] = kr
        cache.v[i, :, :S] = v
    return _logits(model, x, cfg), cache


def decode_step(model: Transformer, cache: KVCache, tokens, pos: int, cfg: ModelConfig,
                policy: ShardingPolicy = REPLICATED):
    """One decode step.  tokens: (B, 1); pos: the current position.

    Writes the new keys and values into ``cache`` at ``pos`` and returns
    (logits, cache).
    """
    _serves(cfg)
    mesh = check_layout(model, policy)
    if mesh is not None:
        with mesh:
            # one token: no sequence to split
            return _decode_tp(model, cache, tokens, pos, cfg,
                              Members(dataclasses.replace(policy, seq_axis=None)))
    x = model.embed[tokens].to(cfg.compute_dtype)
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows_list(cfg))):
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        o, _ = attn_mod.attention_decode(blk.attn, h, KVCache(cache.k[i], cache.v[i]),
                                         pos, cfg, window=window)
        x = x + o
        h = rms_norm(x, blk.norm2, cfg.norm_eps)
        x = x + blk.ffn(h, cfg)[0]
    return _logits(model, x, cfg), cache


# ---------------------------------------------------------------------------
# Under a sharding policy (models/parallel.py): the member's tensors
# ---------------------------------------------------------------------------


def _logits_tp(model: Transformer, x, cfg: ModelConfig, mb: Members):
    """The last token's global logits (B, padded vocab) in f32."""
    x = last_token(x, mb)
    return vocab_logits(rms_norm_tp(x, model.final_norm, cfg, mb), model.head, cfg, mb)


def _layer_tp(blk: Block, x, positions, window: int, cfg: ModelConfig, mb: Members):
    """One layer on the member's tensors: (x, aux (*lead)).  It enters the
    mesh itself, since its remat recompute runs in the backward pass."""
    with mb.mesh:
        h = rms_norm_tp(x, blk.norm1, cfg, mb)
        x = x + blk.attention(h, positions, window, cfg, mb.policy)
        h, a = blk.ffn(rms_norm_tp(x, blk.norm2, cfg, mb), cfg, mb.policy)
        return x + h, torch.zeros(x.shape[:mb.k], device=x.device) if a is None else a


def _forward_tp(model: Transformer, tokens, cfg: ModelConfig, mb: Members):
    """The member's final hidden states (*lead, B, S or its block, d) and
    aux loss (*lead), each layer recomputed in the backward pass when
    ``cfg.remat``."""
    x = vocab_embed(model.embed, tokens, cfg, mb)
    positions = torch.arange(tokens.shape[-1], dtype=torch.int32, device=x.device)
    return tracing.region("blocks", _blocks_tp, model, x, positions, cfg, mb)


def _blocks_tp(model: Transformer, x, positions, cfg: ModelConfig, mb: Members):
    """The layers and the final norm on the member's embedded ``x``."""
    layer = maybe_remat(_layer_tp, cfg.remat)
    aux = torch.zeros(x.shape[:mb.k], device=x.device)
    for blk, window in zip(model.blocks, layer_windows_list(cfg)):
        x, a = layer(blk, x, positions, window, cfg, mb)
        aux = aux + a
    return rms_norm_tp(x, model.final_norm, cfg, mb), aux


def _prefill_tp(model: Transformer, tokens, cfg: ModelConfig, max_len: int, mb: Members):
    x = vocab_embed(model.embed, tokens, cfg, mb)
    S = tokens.shape[-1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    split = mb.policy.cache_seq_axis
    cache = None
    at = (slice(None),) * mb.k
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows_list(cfg))):
        h = rms_norm_tp(x, blk.norm1, cfg, mb)
        o, kr, v = attn_mod.self_attention_tp(blk.attn, h, positions, cfg, window, mb)
        x = x + o
        x = x + blk.ffn(rms_norm_tp(x, blk.norm2, cfg, mb), cfg, mb.policy)[0]
        if split is not None:  # the member's block of [0, max_len) along ``split``
            kr, v = (M.block_of(_pad_seq(t, max_len), (split,), 1) for t in (kr, v))
        if cache is None:  # (*lead, L, B, S_l, kv, hd), kv or hd the member's
            shape = kr.shape[:mb.k] + (cfg.n_layers, kr.shape[mb.k], max_len) + kr.shape[-2:]
            if split is not None:
                shape = shape[:-3] + kr.shape[-3:]
            cache = KVCache(k=kr.new_zeros(shape), v=v.new_zeros(shape))
        end = kr.shape[-3]
        cache.k[at + (i, slice(None), slice(0, end))] = kr
        cache.v[at + (i, slice(None), slice(0, end))] = v
    return _logits_tp(model, x, cfg, mb), cache


def _pad_seq(t, length: int):
    """(*lead, B, S, kv, hd) zero-padded on S to ``length``."""
    return torch.cat([t, t.new_zeros(t.shape[:-3] + (length - t.shape[-3],) + t.shape[-2:])],
                     dim=-3)


def _decode_tp(model: Transformer, cache: KVCache, tokens, pos: int, cfg: ModelConfig,
               mb: Members):
    x = vocab_embed(model.embed, tokens, cfg, mb)
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows_list(cfg))):
        h = rms_norm_tp(x, blk.norm1, cfg, mb)
        o, _ = attn_mod.attention_decode(
            blk.attn, h, KVCache(cache.k.select(mb.k, i), cache.v.select(mb.k, i)), pos, cfg,
            window=window, policy=mb.policy)
        x = x + o
        x = x + blk.ffn(rms_norm_tp(x, blk.norm2, cfg, mb), cfg, mb.policy)[0]
    return _logits_tp(model, x, cfg, mb), cache
