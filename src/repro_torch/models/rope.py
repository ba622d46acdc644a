"""Rotary position embeddings (``src/repro/models/rope.py``): halves, not
interleaved, with the angles in f32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)          # (half,)
    angles = positions[..., None].to(torch.float32) * freqs          # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                            # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
