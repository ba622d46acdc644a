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
