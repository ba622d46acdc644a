"""Plain PyTorch oracles for the ported kernels (``repro.kernels.ref`` in torch).

They are also the kernels' plain versions: a wrapper runs them for a tensor
that lies on the CPU.
"""

from __future__ import annotations

import torch


def gemm_ref(a, b, c=None, accumulate: bool = False):
    out = a.float() @ b.float()
    if accumulate and c is not None:
        out = out + c.float()
    return out.to(a.dtype)


def reduce_nway_ref(x, op: str = "add", dim: int = 0):
    if op == "add":
        return x.float().sum(dim).to(x.dtype)
    if op == "max":
        return x.amax(dim)
    if op == "and":
        out = x.select(dim, 0)
        for i in range(1, x.shape[dim]):
            out = out & x.select(dim, i)
        return out
    raise ValueError(op)


def flash_attention_ref(q, k, v, window: int = 0):
    BH, S, d = q.shape
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s = torch.where(mask[None], s, -2.0e38)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def rglru_scan_ref(a, b):
    """Sequential h_t = a_t h_{t-1} + b_t over dim 1 of (B, S, W), in f32,
    from h_{-1} = 0; the output in a's dtype."""
    a32, b32 = a.float(), b.float()
    out = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out[:, t] = h
    return out.to(a.dtype)


def wkv_ref(r, k, v, logw, u, state0=None):
    """Sequential RWKV-6 recurrence over (B, S, H, hd), in f32.

    Per token, with ``kv = k_t v_t^T`` (key index i, value index j):
    ``out_t = r_t (state + u kv)`` and ``state = exp(logw_t) state + kv``,
    the decay acting on the key index.  u: (H, hd); state0: (B, H, hd, hd)
    or None for zeros.  Returns (out in r's dtype, final f32 state).
    """
    B, S, H, hd = r.shape
    r32, k32, v32 = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    u = u.float()[..., None]  # (H, hd, 1)
    state = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
             if state0 is None else state0.float().clone())
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        out[:, t] = torch.einsum("bhi,bhij->bhj", r32[:, t], state + u * kv)
        state = w[:, t, :, :, None] * state + kv
    return out.to(r.dtype), state
