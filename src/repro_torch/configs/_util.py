"""Helpers shared by the architecture config modules."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import ModelConfig


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Same-family reduced config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else cfg.n_kv_heads,
        head_dim=16,
        d_ff=128,
        vocab=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        attn_window=min(cfg.attn_window, 8) if cfg.attn_window else 0,
        lru_width=64 if cfg.lru_width else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        encoder_len=16 if cfg.encoder_layers else cfg.encoder_len,
        rwkv_head_size=16,
        param_dtype=torch.float32,
        compute_dtype=torch.float32,
        loss_chunk=16,
        remat=False,
    )
    if cfg.family == "rglru_hybrid":
        base["n_layers"] = 3  # one full (rec, rec, attn) pattern
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
