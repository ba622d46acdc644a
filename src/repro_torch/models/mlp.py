"""Gated MLPs and the capacity-based top-k Mixture-of-Experts
(``src/repro/models/mlp.py``).

The dense MLP is ``silu(x @ W_gate) * (x @ W_up) @ W_down`` in the compute
dtype.  The MoE is the reference's scatter formulation on one device
(``_moe_local``): the router in f32 picks each token's ``top_k`` experts,
the (token, choice) pairs are ranked within their expert in the
token-major order of ``gate_idx``, the reference's cumulative one-hot
rank (so the same pair is dropped at the capacity boundary), the kept rows
are scattered into a capacity-padded (E, C, d) buffer, each expert runs
its gated FFN, and the outputs are gathered back and summed with their
gate weights.  The products are plain ``torch.matmul`` / ``torch.bmm``, as
the reference leaves them to XLA (``jnp.einsum``); routing, dispatch and
combine are plain PyTorch.

Determinism on the card (two serves must give equal tokens), with no
float atomics:

* the dispatch ``buf.at[e_idx, c_idx].add(src)`` is a plain scatter of
  the rows: the kept (expert, slot) pairs are unique, and the dropped rows
  (which add zeros to slot (0, 0) in the reference) go to one spare row
  past the buffer's end, which is thrown away;
* the combine ``combined.at[tok_idx].add(...)`` is a sum over the K axis
  of a (T, K, d) view, since ``tok_idx = repeat(arange(T), K)``;
* the load-balance count ``ce`` is a bincount, taken as the column sums
  of the one-hot choices: ``torch.bincount`` reads its input's maximum on
  the host, which would stall the card once a layer.

No step of the MoE waits for the card: the capacity is a Python int of
the token count, and every index is computed on the device.

``torch.topk`` promises no order among equal values; the reference's
``jax.lax.top_k`` puts the lower index first.  The port takes the top K
of a stable descending sort, which does the same.

The expert-parallel path (``_moe_ep``: a shard_map with two
``all_to_all`` token exchanges over the model axis) waits for the
``torch.distributed`` mesh backend (ROADMAP.md): on one card every
expert is local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def init_mlp_params(gen, cfg: ModelConfig, device=None, d_model: int | None = None,
                    d_ff: int | None = None) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), cfg.param_dtype, device),
        "w_up": dense_init(gen, (d, f), cfg.param_dtype, device),
        "w_down": dense_init(gen, (f, d), cfg.param_dtype, device),
    }


def mlp(params, x, cfg: ModelConfig):
    cd = cfg.compute_dtype
    h = F.silu(x @ params["w_gate"].to(cd))
    h = h * (x @ params["w_up"].to(cd))
    return h @ params["w_down"].to(cd)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def init_moe_params(gen, cfg: ModelConfig, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "w_gate": dense_init(gen, (e, d, f), cfg.param_dtype, device),
        "w_up": dense_init(gen, (e, d, f), cfg.param_dtype, device),
        "w_down": dense_init(gen, (e, f, d), cfg.param_dtype, device),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    per_expert = (n_tokens * cfg.top_k + cfg.n_experts - 1) // cfg.n_experts
    cap = int(per_expert * cfg.capacity_factor) + 1
    return min(cap, n_tokens)


def _route(params, xf, cfg: ModelConfig):
    """Router: returns (gate_vals (T, K), gate_idx (T, K), aux scalar)."""
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[0]
    logits = xf.float() @ params["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # top K with the lower index first among equal values (jax.lax.top_k)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # auxiliary load-balancing loss (Switch-style)
    me = probs.mean(0)
    ce = F.one_hot(gate_idx.reshape(-1), E).sum(0).float() / (T * K)
    aux = E * torch.sum(me * ce)
    return gate_vals, gate_idx, aux


def _dispatch_indices(gate_idx, E: int, C: int):
    """Capacity-ranked scatter indices. Returns (tok_idx, e_idx, c_idx, keep)."""
    T, K = gate_idx.shape
    flat_expert = gate_idx.reshape(-1)                          # (T*K,) token-major
    # Rank within expert: the pairs before this one (token-major) that chose
    # the same expert, the reference's cumulative one-hot.  A stable sort
    # keeps those pairs in order, so the rank is the distance from the start
    # of the expert's run.  (A cumsum down a (T*K, E) one-hot scans its long
    # outer dim on the card: 12 ms a layer at T*K = 49152.)
    sorted_e, order = torch.sort(flat_expert, stable=True)
    run_start = torch.searchsorted(sorted_e, sorted_e)
    rank = torch.arange(T * K, device=gate_idx.device) - run_start
    pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos < C
    tok_idx = torch.arange(T * K, device=gate_idx.device) // K  # repeat(arange(T), K)
    e_idx = torch.where(keep, flat_expert, 0)
    c_idx = torch.where(keep, pos, 0)
    return tok_idx, e_idx, c_idx, keep


def _expert_ffn(params, buf, cfg: ModelConfig):
    """buf: (E, C, d) -> (E, C, d) through the per-expert gated FFN."""
    cd = cfg.compute_dtype
    h = F.silu(torch.bmm(buf, params["w_gate"].to(cd)))
    h = h * torch.bmm(buf, params["w_up"].to(cd))
    return torch.bmm(h, params["w_down"].to(cd))


def _moe_local(params, xf, cfg: ModelConfig):
    """Single-device MoE body: route, dispatch, expert FFN, combine."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    cd = cfg.compute_dtype
    C = moe_capacity(cfg, T)
    gate_vals, gate_idx, aux = _route(params, xf, cfg)
    tok_idx, e_idx, c_idx, keep = _dispatch_indices(gate_idx, E, C)
    # kept rows to their unique (expert, slot); dropped rows to the spare row E * C
    slot = torch.where(keep, e_idx * C + c_idx, E * C)
    buf = xf.new_zeros((E * C + 1, d), dtype=cd).index_put((slot,), xf[tok_idx].to(cd))
    out_buf = _expert_ffn(params, buf[:E * C].view(E, C, d), cfg)
    gathered = out_buf[e_idx, c_idx]
    gathered = torch.where(keep[:, None], gathered, 0)
    weighted = gathered * gate_vals.reshape(-1)[:, None].to(cd)
    return weighted.view(T, K, d).sum(1), aux


def moe(params, x, cfg: ModelConfig):
    """Token-choice top-k MoE with capacity dropping, on one device.

    x: (B, S, d) -> ((B, S, d), aux load-balance loss).  In the paper's
    terms the dispatch is a fabric many-to-many (multicast of tokens to
    expert owners) and the combine the mirrored reduction; on one card
    both are local gathers and scatters.
    """
    B, S, d = x.shape
    out, aux = _moe_local(params, x.reshape(B * S, d), cfg)
    return out.reshape(B, S, d), aux
