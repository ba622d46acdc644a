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
does.

Parameters require gradients only in a model built with ``trainable=True``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (
    ModelConfig,
    check_supported,
    chunked_cross_entropy,
    embed_init,
    maybe_remat,
    param,
    resolve_device,
    rms_norm,
)


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
    """One layer: pre-norm attention and a pre-norm gated MLP (``mlp``) or
    MoE (``moe``), both residual."""

    def __init__(self, norm1, norm2, attn: dict, mlp: dict | None = None,
                 moe: dict | None = None):
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

    def ffn(self, h, cfg: ModelConfig):
        """The MLP or MoE on the normed ``h``: (out, aux loss or None)."""
        if self.moe is not None:
            return mlp_mod.moe(self.moe, h, cfg)
        return mlp_mod.mlp(self.mlp, h, cfg), None


class Transformer(nn.Module):
    """The parameters of one model; the passes are the module functions below."""

    def __init__(self, cfg: ModelConfig, embed, blocks: list[Block], final_norm,
                 lm_head=None, trainable: bool = False):
        super().__init__()
        check_supported(cfg)
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

    def ffn():
        if cfg.n_experts:
            return {"moe": mlp_mod.init_moe_params(gen, cfg, device)}
        return {"mlp": mlp_mod.init_mlp_params(gen, cfg, device)}

    blocks = [Block(zeros(), zeros(), attn_mod.init_attn_params(gen, cfg, device), **ffn())
              for _ in range(cfg.n_layers)]
    lm_head = None if cfg.tie_embeddings else embed_init(
        gen, cfg.padded_vocab, cfg.d_model, cfg.param_dtype, device)
    return Transformer(cfg, embed, blocks, zeros(), lm_head, trainable)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _logits(model: Transformer, x, cfg: ModelConfig) -> torch.Tensor:
    """The last token's logits in f32 over the padded vocab."""
    x = rms_norm(x[:, -1], model.final_norm, cfg.norm_eps)
    return x.float() @ model.head.float().T


def _layer(blk: Block, x, positions, window: int, cfg: ModelConfig):
    """One layer: (x, aux loss), the aux zero without the MoE."""
    h = rms_norm(x, blk.norm1, cfg.norm_eps)
    x = x + attn_mod.attention(blk.attn, h, positions, cfg, window=window)
    h = rms_norm(x, blk.norm2, cfg.norm_eps)
    h, aux = blk.ffn(h, cfg)
    return x + h, torch.zeros((), device=x.device) if aux is None else aux


def forward(model: Transformer, tokens, cfg: ModelConfig):
    """tokens: (B, S) -> (hidden (B, S, d), aux loss summed over layers)."""
    B, S = tokens.shape
    x = model.embed[tokens].to(cfg.compute_dtype)
    positions = _positions(B, S, x.device)
    layer = maybe_remat(_layer, cfg.remat)
    aux = torch.zeros((), device=x.device)
    for blk, window in zip(model.blocks, layer_windows_list(cfg)):
        x, a = layer(blk, x, positions, window, cfg)
        aux = aux + a
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, aux


def loss_fn(model: Transformer, batch: dict, cfg: ModelConfig):
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S))
    plus 0.01 of the MoE's aux loss (zero without the MoE)."""
    hidden, aux = forward(model, batch["tokens"], cfg)
    loss = chunked_cross_entropy(hidden, model.head, batch["labels"], cfg)
    return loss + 0.01 * aux


def prefill(model: Transformer, tokens, cfg: ModelConfig, max_len: int | None = None):
    """Full-sequence prefill; returns (last-token logits, KV cache).

    The cache holds the keys after RoPE and the values for positions
    ``[0, S)``, zero up to ``max_len``.
    """
    B, S = tokens.shape
    max_len = max_len or S
    if S > max_len:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
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


def decode_step(model: Transformer, cache: KVCache, tokens, pos: int, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1); pos: the current position.

    Writes the new keys and values into ``cache`` at ``pos`` and returns
    (logits, cache).
    """
    x = model.embed[tokens].to(cfg.compute_dtype)
    for i, (blk, window) in enumerate(zip(model.blocks, layer_windows_list(cfg))):
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        o, _ = attn_mod.attention_decode(blk.attn, h, KVCache(cache.k[i], cache.v[i]),
                                         pos, cfg, window=window)
        x = x + o
        h = rms_norm(x, blk.norm2, cfg.norm_eps)
        x = x + blk.ffn(h, cfg)[0]
    return _logits(model, x, cfg), cache
