"""Plain PyTorch oracles for the ported kernels (``repro.kernels.ref`` in torch).

They are also the kernels' plain versions: a wrapper runs them for a tensor
that lies on the CPU.  Each computes in f32, or in f64 for f64 inputs (the
gradient checks take f64).  ``wkv_chunked_ref`` is the form that ``wkv``'s
backward differentiates.
"""

from __future__ import annotations

import torch


def wide(x):
    """x in f32, or in f64 when it is f64."""
    return x if x.dtype == torch.float64 else x.float()


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
    s = torch.einsum("bqd,bkd->bqk", wide(q), wide(k)) * scale
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = ki <= qi
    if window > 0:
        mask &= ki > qi - window
    s = torch.where(mask[None], s, -2.0e38)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, wide(v)).to(q.dtype)


def rglru_scan_ref(a, b):
    """Sequential h_t = a_t h_{t-1} + b_t over dim 1 of (B, S, W), in f32,
    from h_{-1} = 0; the output in a's dtype."""
    a32, b32 = wide(a), wide(b)
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
    r32, k32, v32 = wide(r), wide(k), wide(v)
    w = torch.exp(wide(logw))
    u = wide(u)[..., None]  # (H, hd, 1)
    state = (torch.zeros((B, H, hd, hd), dtype=r32.dtype, device=r.device)
             if state0 is None else wide(state0).clone())
    out = torch.empty((B, S, H, hd), dtype=r32.dtype, device=r.device)
    for t in range(S):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]
        out[:, t] = torch.einsum("bhi,bhij->bhj", r32[:, t], state + u * kv)
        state = w[:, t, :, :, None] * state + kv
    return out.to(r.dtype), state


WKV_CHUNK = 16  # tokens a chunk of ``wkv_chunked_ref``: (B, H, S, 16, hd) pair tensors


def wkv_chunked_ref(r, k, v, logw, u, state0=None):
    """The recurrence of :func:`wkv_ref` in chunks of ``WKV_CHUNK`` tokens.

    Every decay is ``exp`` of a sum of log-decays, so <= 0: over the tokens
    strictly between s and t for a pair s < t inside a chunk, after s for
    the state's growth, before t for the incoming state.  Each sum is a
    product with a 0/1 matrix, not a difference of cumulative sums, so the
    forward stays finite over the model's whole decay range (where the
    reference's ``k * exp(-cum)`` overflows) and the gradient of ``logw``
    sums only the pairs that a token lies between (a difference of
    cumulative sums would add and cancel the large terms of adjacent
    pairs).  Within a chunk the (t, s) pairs are one batched product; the
    state passes between chunks in a loop of S / chunk steps.  S is padded
    to a whole chunk with k = v = 0 and logw = 0, which leave the state as
    it is.  Returns (out in r's dtype, final state in f32, or f64 for f64
    inputs).
    """
    B, S, H, hd = r.shape
    chunk = WKV_CHUNK
    n = -(-S // chunk)
    pad = n * chunk - S

    def blocks(x):  # (B, S, H, hd) -> (B, H, n, chunk, hd)
        x = torch.nn.functional.pad(wide(x), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)

    rs, ks, vs, lw = blocks(r), blocks(k), blocks(v), blocks(logw)
    i = torch.arange(chunk, device=r.device)
    before = (i[None, :] < i[:, None]).to(lw.dtype)   # [t, u]: u < t
    after = (i[None, :] > i[:, None]).to(lw.dtype)    # [s, u]: u > s
    between = before[:, None, :] * after[None, :, :]  # [t, s, u]: s < u < t
    seg = torch.einsum("tsu,bhnui->bhntsi", between, lw)
    decay = torch.exp(torch.where(before.bool()[..., None], seg, float("-inf")))
    att = ((rs[..., :, None, :] * decay) * ks[..., None, :, :]).sum(-1)
    bonus = (rs * wide(u)[None, :, None, None, :] * ks).sum(-1, keepdim=True)
    out = att @ vs + bonus * vs
    # the state entering each chunk
    grow = (ks * torch.exp(after @ lw)).transpose(-1, -2) @ vs       # (B, H, n, hd, hd)
    total = lw.sum(-2)                                               # (B, H, n, hd)
    state = (torch.zeros((B, H, hd, hd), dtype=rs.dtype, device=r.device)
             if state0 is None else wide(state0))
    entering = []
    for c in range(n):
        entering.append(state)
        state = torch.exp(total[:, :, c])[..., None] * state + grow[:, :, c]
    out = out + (rs * torch.exp(before @ lw)) @ torch.stack(entering, 2)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, hd)[:, :S]
    return out.to(r.dtype), state
