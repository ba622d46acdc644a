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
