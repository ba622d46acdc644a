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

Every step of the MoE takes leading dims before the tokens, one per mesh
dim of the stacked mesh (``models/parallel.py``): each member routes and
dispatches its own tokens.  Under a policy whose model axis is wider than
1 and divides ``n_experts``, ``moe`` takes the expert-parallel path
(``_moe_ep``, the reference's shard_map over the batch and model axes):
each member routes its tokens (its slice of the sequence over the model
axis when ``moe_token_shard`` is set and the axis divides S, or under
sequence parallelism, where the slice is what the member holds; otherwise
every member routes the same tokens),
at a capacity of its own token count; a tiled ``all_to_all`` carries each
expert's rows to the member that owns it (the fabric's many-to-many), the
member runs its experts, and the mirrored ``all_to_all`` brings the rows
back to be combined; the aux loss is averaged over the batch axes, and
over the model axis when the tokens were sliced, whose slices are then
gathered back.  Under any other policy each member runs the local MoE, its
products summed over the model axis where the spec splits ``d_ff``.

DeepSeek-V3's MoE (``router_scoring="sigmoid"``, the port's own; Moonlight,
``configs/moonlight_16b_a3b.py``) keeps the capacity rule and the dispatch
above and changes the router (``_route_biased``: sigmoid scores, the
choice by score plus a selection bias, the chosen scores normalised and
times ``routed_scaling``), adds the shared experts' gated MLP beside the
routed ones, and replaces the Switch aux loss by the sequence-wise
balance loss (``_sequence_loss``), whose per-sequence statistics are
summed over the members that hold a sequence's blocks before they are
multiplied.  The bias is no parameter: the forward passes that run inside
``tally_loads`` add their loads, and ``update_router_biases`` moves the
bias after the optimizer's step (``runtime/trainer.py``).  The routed
experts' width is ``cfg.expert_ff``.  The whole MoE is the traced region
``moe``; while a profiler records it counts its routed and dropped
(token, choice) pairs on the card (``tracing.count``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core import mesh as M
from repro_torch.models.common import REPLICATED, ModelConfig, ShardingPolicy, dense_init
from repro_torch.models.parallel import Members, is_sharded


def init_mlp_params(gen, cfg: ModelConfig, device=None, d_model: int | None = None,
                    d_ff: int | None = None) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), cfg.param_dtype, device),
        "w_up": dense_init(gen, (d, f), cfg.param_dtype, device),
        "w_down": dense_init(gen, (f, d), cfg.param_dtype, device),
    }


def mlp_param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    return {
        "w_gate": policy.w_col(cfg.d_ff),
        "w_up": policy.w_col(cfg.d_ff),
        "w_down": policy.w_row(cfg.d_ff),
    }


def mlp(params, x, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED):
    """The gated MLP; under a policy, column-parallel ``w_gate`` / ``w_up``
    and row-parallel ``w_down`` summed over the model axis (under sequence
    parallelism: S gathered before the first products, the sum scattered
    on S after ``w_down``)."""
    cd = cfg.compute_dtype
    if is_sharded(policy):
        mb = Members(policy)
        x = mb.gather_seq(x)
        h = F.silu(mb.mm(x, params["w_gate"].to(cd))) * mb.mm(x, params["w_up"].to(cd))
        out = mb.mm(h, params["w_down"].to(cd))
        return mb.row_out(out, mb.split(mlp_param_specs(cfg, policy)["w_down"]))
    h = F.silu(x @ params["w_gate"].to(cd))
    h = h * (x @ params["w_up"].to(cd))
    return h @ params["w_down"].to(cd)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The config whose gated MLP is the shared experts' (``d_ff`` their width)."""
    return dataclasses.replace(cfg, d_ff=cfg.shared_ff)


def init_moe_params(gen, cfg: ModelConfig, device=None) -> dict:
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (d, e), torch.float32, device),
        "w_gate": dense_init(gen, (e, d, f), cfg.param_dtype, device),
        "w_up": dense_init(gen, (e, d, f), cfg.param_dtype, device),
        "w_down": dense_init(gen, (e, f, d), cfg.param_dtype, device),
    }


def moe_param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    e, f = cfg.n_experts, cfg.expert_ff
    return {
        "router": (None, None),
        "w_gate": policy.w_expert_col(e, f),
        "w_up": policy.w_expert_col(e, f),
        "w_down": policy.w_expert_row(e, f),
    }


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    per_expert = (n_tokens * cfg.top_k + cfg.n_experts - 1) // cfg.n_experts
    cap = int(per_expert * cfg.capacity_factor) + 1
    return min(cap, n_tokens)


def _route(params, xf, cfg: ModelConfig):
    """Router: returns (gate_vals (..., T, K), gate_idx (..., T, K), aux (...))
    for xf (..., T, d) and a router (..., d, E)."""
    E, K = cfg.n_experts, cfg.top_k
    T = xf.shape[-2]
    logits = xf.float() @ params["router"]                      # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    # top K with the lower index first among equal values (jax.lax.top_k)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    # auxiliary load-balancing loss (Switch-style)
    me = probs.mean(-2)
    ce = F.one_hot(gate_idx, E).sum((-3, -2)).float() / (T * K)
    aux = E * torch.sum(me * ce, dim=-1)
    return gate_vals, gate_idx, aux


def _route_biased(params, xf, cfg: ModelConfig, bias):
    """DeepSeek-V3's router (``noaux_tc`` with one group): sigmoid scores in
    f32; each token's ``top_k`` experts by score plus the selection ``bias``
    (which moves the choice, not the gates; None for none), the lower index
    first among equal values; the chosen scores normalised and times
    ``routed_scaling``.  Returns (gate_vals, gate_idx (..., T, K), scores
    (..., T, E))."""
    scores = torch.sigmoid(xf.float() @ params["router"])       # (..., T, E)
    choice = scores if bias is None else scores + bias
    gate_idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][..., :cfg.top_k]
    gate_vals = torch.gather(scores, -1, gate_idx)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scaling
    return gate_vals, gate_idx, scores


def _sequence_stats(gate_idx, scores, seqs: int):
    """Per sequence of the ``seqs`` that the tokens hold in order: how many of
    its tokens chose each expert (no gradient), and the sum over its tokens
    of each expert's score normalised over the experts.  Each (..., seqs, E)."""
    E, T = scores.shape[-1], scores.shape[-2]
    chosen = F.one_hot(gate_idx, E).sum(-2)                     # (..., T, E)
    share = scores / scores.sum(-1, keepdim=True)

    def per_seq(t):
        return t.unflatten(-2, (seqs, T // seqs)).sum(-2)
    return per_seq(chosen).float(), per_seq(share)


def _sequence_loss(counts, shares, S: int, cfg: ModelConfig):
    """DeepSeek-V3's sequence-wise balance loss (arXiv:2412.19437 §2.1.2),
    sum_i f_i P_i with f_i = E / (K S) count_i and P_i = share_i / S over a
    sequence of S tokens, meaned over the sequences: (...)."""
    E, K = cfg.n_experts, cfg.top_k
    return torch.sum(counts * shares, -1).mean(-1) * (E / (K * S * S))


# The selection biases' loads of the step's forward passes, while
# ``tally_loads`` is open: {id(bias): (bias, loads summed over the passes)}.
_TALLY: dict | None = None


@contextlib.contextmanager
def tally_loads(into: dict):
    """While open, each forward of an MoE with a selection bias adds the
    (token, choice) pairs that chose each expert, a member's share, to
    ``into``.  Open it around the loss's forward only: a remat recompute in
    the backward pass routes the same tokens again."""
    global _TALLY
    prev, _TALLY = _TALLY, into
    try:
        yield into
    finally:
        _TALLY = prev


def _tally(bias, counts, copies: int):
    """Add a member's loads (its counts (..., seqs, E) over the ``copies``
    members that route the same tokens) to the open tally."""
    if _TALLY is None or bias is None:
        return
    load = counts.detach().sum(-2) / copies
    key = id(bias)
    _TALLY[key] = (bias, load if key not in _TALLY else _TALLY[key][1] + load)


def update_router_biases(tally: dict, rate: float, mesh=None):
    """DeepSeek-V3's auxiliary-loss-free balancing: ``b_i += rate * sign(mean
    load - load_i)`` for each bias of ``tally``, its loads summed over the
    members of ``mesh`` (the stacked mesh's leading dims, or every axis of a
    rank mesh), so that the bias stays equal on every member.  In place,
    outside autograd."""
    with torch.no_grad():
        for bias, load in tally.values():
            if isinstance(mesh, M.RankMesh):
                with mesh:
                    for axis in mesh.axis_names:
                        load = M.psum(load, axis)
            elif mesh is not None:
                load = load.sum(tuple(range(mesh.stacked)))
            bias.add_(rate * torch.sign(load.mean() - load))


# The routers' choices of the forward passes while ``record_choices`` is
# open: gate_idx tensors in call order.
_CHOICES: list | None = None


@contextlib.contextmanager
def record_choices(into: list):
    """While open, each MoE forward outside a backward pass (so not a remat
    recompute) appends its routers' choices, gate_idx (..., T, K) as int16,
    to ``into``: what a comparison with a plain reference needs to tell a
    routing flip at a near-tie from a wrong choice."""
    global _CHOICES
    prev, _CHOICES = _CHOICES, into
    try:
        yield into
    finally:
        _CHOICES = prev


def _count_pairs(keep):
    """The routed and the dropped (token, choice) pairs, on the card, while a
    profiler records (``tracing.count``)."""
    if tracing.counting():
        tracing.count("moe.routed_pairs", keep.numel(), keep.device)
        tracing.count("moe.dropped_pairs", (~keep).sum())


def _dispatch_indices(gate_idx, E: int, C: int):
    """Capacity-ranked scatter indices. Returns (tok_idx (T*K,), and e_idx,
    c_idx, keep (..., T*K)) for gate_idx (..., T, K)."""
    T, K = gate_idx.shape[-2:]
    flat_expert = gate_idx.flatten(-2)                          # (..., T*K) token-major
    # Rank within expert: the pairs before this one (token-major) that chose
    # the same expert, the reference's cumulative one-hot.  A stable sort
    # keeps those pairs in order, so the rank is the distance from the start
    # of the expert's run.  (A cumsum down a (T*K, E) one-hot scans its long
    # outer dim on the card: 12 ms a layer at T*K = 49152.)
    sorted_e, order = torch.sort(flat_expert, dim=-1, stable=True)
    run_start = torch.searchsorted(sorted_e, sorted_e)
    rank = torch.arange(T * K, device=gate_idx.device) - run_start
    pos = torch.empty_like(rank).scatter_(-1, order, rank)
    keep = pos < C
    tok_idx = torch.arange(T * K, device=gate_idx.device) // K  # repeat(arange(T), K)
    e_idx = torch.where(keep, flat_expert, 0)
    c_idx = torch.where(keep, pos, 0)
    return tok_idx, e_idx, c_idx, keep


def _bmm(a, b):
    """Per-expert products over any leading dims: (..., C, n) @ (..., n, m)."""
    out = torch.bmm(a.reshape((-1,) + a.shape[-2:]), b.reshape((-1,) + b.shape[-2:]))
    return out.reshape(a.shape[:-1] + b.shape[-1:])


def _expert_ffn(params, buf, cfg: ModelConfig):
    """buf: (..., E, C, d) -> (..., E, C, d) through the per-expert gated FFN."""
    cd = cfg.compute_dtype
    h = F.silu(_bmm(buf, params["w_gate"].to(cd)))
    h = h * _bmm(buf, params["w_up"].to(cd))
    return _bmm(h, params["w_down"].to(cd))


def _moe_body(params, xf, cfg: ModelConfig, C: int, exchange=None, reduce=None,
              bias=None, seqs: int = 1):
    """Route, dispatch, the experts' FFN, combine.

    xf: (..., T, d), one leading dim per mesh dim on the stacked mesh, the
    tokens of ``seqs`` sequences in order.
    ``exchange(buf, split, concat)`` carries the (..., E, C, d) buffer to
    the experts' owners and back (the expert-parallel ``all_to_all``);
    ``reduce`` sums the FFN's output over the members that split ``d_ff``.
    Each large temporary is dropped as soon as the next exists.  Returns
    (combined (..., T, d), aux): the Switch aux loss (...), or with the
    sigmoid router the sequences' balance statistics (``_sequence_stats``).
    """
    T, d = xf.shape[-2:]
    lead = xf.shape[:-2]
    L = xf[..., 0, 0].numel()  # members
    E, K = cfg.n_experts, cfg.top_k
    cd = cfg.compute_dtype
    if cfg.router_scoring == "sigmoid":
        gate_vals, gate_idx, scores = _route_biased(params, xf, cfg, bias)
        aux = _sequence_stats(gate_idx, scores, seqs)
        del scores
    else:
        gate_vals, gate_idx, aux = _route(params, xf, cfg)
    if _CHOICES is not None and not tracing.in_backward():
        _CHOICES.append(gate_idx.detach().to(torch.int16))
    tok_idx, e_idx, c_idx, keep = _dispatch_indices(gate_idx, E, C)
    _count_pairs(keep)
    # each member's kept rows to their unique (expert, slot) of its block of
    # the buffer; dropped rows to the spare row L * E * C
    base = (torch.arange(L, device=xf.device) * (E * C)).reshape(lead + (1,))
    slot = base + e_idx * C + c_idx
    buf = xf.new_zeros((L * E * C + 1, d), dtype=cd).index_put(
        (torch.where(keep, slot, L * E * C).reshape(-1),),
        xf.reshape(L, T, d)[:, tok_idx].to(cd).reshape(-1, d))
    buf = buf[:L * E * C].view(lead + (E, C, d))
    if exchange is not None:
        buf = exchange(buf, 0, 1)
    buf = _expert_ffn(params, buf, cfg)
    if reduce is not None:
        buf = reduce(buf)
    if exchange is not None:
        buf = exchange(buf, 1, 0)
    rows = buf.reshape(L * E * C, d)[slot.reshape(-1)].view(lead + (T * K, d))
    del buf
    rows = torch.where(keep[..., None], rows, 0)
    rows = rows * gate_vals.reshape(lead + (T * K, 1)).to(cd)
    return rows.view(lead + (T, K, d)).sum(-2), aux


def _moe_local(params, xf, cfg: ModelConfig):
    """Single-device MoE body: route, dispatch, expert FFN, combine."""
    return _moe_body(params, xf, cfg, moe_capacity(cfg, xf.shape[-2]))


def moe(params, x, cfg: ModelConfig, policy: ShardingPolicy = REPLICATED, bias=None,
        shared=None):
    """Token-choice top-k MoE with capacity dropping: the region ``moe``.

    x: (B, S, d) -> ((B, S, d), aux load-balance loss).  Under a policy,
    x is the member's (*lead, B, S, d) and the aux is per member; the
    expert-parallel path is taken, as in the reference, whenever the model
    axis is wider than 1 and divides ``n_experts``.  With the sigmoid
    router, ``bias`` is the selection bias (E,) (a buffer, or None) and the
    aux is the sequence-wise balance loss; ``shared`` (the shared experts'
    gated MLP, or None) adds its output to the routed experts'.
    """
    return tracing.region("moe", _moe, params, x, cfg, policy, bias, shared)


def _moe(params, x, cfg: ModelConfig, policy: ShardingPolicy, bias, shared):
    if not is_sharded(policy):
        out, aux = _moe_unsharded(params, x, cfg, bias)
    else:
        esize = policy.mesh_axis_sizes.get(policy.model_axis or "", 1)
        if policy.model_axis is None or esize <= 1 or cfg.n_experts % esize != 0:
            out, aux = _moe_tp_local(params, x, cfg, Members(policy), bias)
        else:
            out, aux = _moe_ep(params, x, cfg, policy, esize, bias)
    if shared is not None:
        out = out + mlp(shared, x, shared_cfg(cfg), policy)
    return out, aux


def _moe_unsharded(params, x, cfg: ModelConfig, bias):
    B, S, d = x.shape[-3:]
    if cfg.router_scoring != "sigmoid":
        out, aux = _moe_local(params, x.reshape(B * S, d), cfg)
        return out.reshape(B, S, d), aux
    out, (counts, shares) = _moe_body(params, x.reshape(B * S, d), cfg,
                                      moe_capacity(cfg, B * S), bias=bias, seqs=B)
    _tally(bias, counts, 1)
    return out.reshape(B, S, d), _sequence_loss(counts, shares, S, cfg)


def _moe_tp_local(params, x, cfg: ModelConfig, mb: Members, bias=None):
    """Each member's local MoE over its tokens; where the spec splits
    ``d_ff`` (experts that the model axis does not divide), each expert's
    product is summed over the model axis.  Under sequence parallelism the
    member routes the whole of S and keeps its block of the output."""
    x = mb.gather_seq(x)
    B, S, d = x.shape[-3:]
    split_f = moe_param_specs(cfg, mb.policy)["w_down"][1] is not None
    xf = x.reshape(x.shape[:-3] + (B * S, d))
    out, aux = _moe_body(params, xf, cfg, moe_capacity(cfg, B * S),
                         reduce=mb.psum if split_f else None, bias=bias, seqs=B)
    if cfg.router_scoring == "sigmoid":
        _tally(bias, aux[0], mb.tp)  # every member of the model axis routes the same tokens
        aux = _sequence_loss(*aux, S, cfg)
    return mb.row_out(out.reshape(x.shape), False), aux


def _moe_ep(params, x, cfg: ModelConfig, policy: ShardingPolicy, esize: int, bias=None):
    """Expert-parallel MoE over the batch and model axes (the reference's
    shard_map): x (*lead, B, S, d), whole over the model axis, in and out;
    under sequence parallelism the member's block of S, in and out.  The
    sequence-wise loss sums each sequence's statistics over the members that
    hold its blocks (a ``psum`` over the model axis) before it multiplies
    them."""
    mb = Members(policy)
    axis = policy.model_axis
    B, S, d = x.shape[-3:]
    if mb.seq:  # the member's tokens already: the reference's seq_axis == axis
        seq, xs = True, x
    else:
        seq = cfg.moe_token_shard and S % esize == 0
        xs = mb.block(x, -2) if seq else x      # the member's tokens
    Tl = B * xs.shape[-2]

    def exchange(buf, split, concat):
        # dispatch (split 0, concat 1): experts travel to their owners, the
        # many-to-many multicast, (E, C, d) -> (E/esize, C*esize, d); the
        # combine (split 1, concat 0) is the mirrored reduction back
        return M.all_to_all(buf, axis, split_axis=split, concat_axis=concat)

    combined, aux = _moe_body(params, xs.reshape(xs.shape[:-3] + (Tl, d)), cfg,
                              moe_capacity(cfg, Tl), exchange=exchange, bias=bias, seqs=B)
    if cfg.router_scoring == "sigmoid":
        counts, shares = aux
        _tally(bias, counts, 1 if seq else esize)
        if seq:
            counts, shares = M.psum(counts, axis), M.psum(shares, axis)
        aux = _sequence_loss(counts, shares, xs.shape[-2] * (esize if seq else 1), cfg)
        for a in policy.batch_axes:
            aux = M.psum(aux, a) / M.axis_size(a)
    else:
        for a in tuple(policy.batch_axes) + ((axis,) if seq else ()):
            aux = M.psum(aux, a) / M.axis_size(a)
    out = combined.reshape(xs.shape)
    return (mb.gather(out, -2) if seq and not mb.seq else out), aux
