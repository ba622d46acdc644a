"""The plain reference of Moonlight-16B-A3B (DeepSeek-V3's architecture,
``model_type`` deepseek_v3) in training: the forward pass, the loss and its
gradients, AdamW and the routers' bias update, in plain ``torch`` and f32
with TF32 off.  Imports nothing of the program and nothing of JAX.

``cfg`` holds the published config's keys (``hidden_size``,
``kv_lora_rank``, ``n_routed_experts``, ...) and three that it lacks:
``aux_loss_alpha`` (the sequence-wise balance loss's weight),
``bias_update_speed`` (the bias rate gamma) and ``capacity_factor``.
Weights are named as the program names its parameters (``embed``,
``blocks.<i>.attn.wq``, ``blocks.<i>.moe.router``, ...).

The model: the embedding looked up; each layer a pre-norm residual MLA and
a pre-norm residual FFN; a final norm; the untied head; the mean
next-token cross-entropy plus ``aux_loss_alpha`` times the MoE layers'
balance losses, summed.

* RMSNorm: ``x / sqrt(mean(x^2) + eps) * (1 + scale)``, eps ``rms_norm_eps``
  (the latent's 1e-6, the published module's default).
* MLA (DeepSeek-V2, arXiv:2405.04434 §2.1; ``q_lora_rank`` null): ``q = h
  wq`` per head ``[q_nope (qk_nope_head_dim), q_pe (qk_rope_head_dim)]``;
  ``[c, k_pe] = h wkv_a``; ``[k_nope, v] = rms(c) wkv_b`` per head; the
  head's key ``[k_nope, rope(k_pe)]`` with ``k_pe`` one head shared by all;
  causal softmax at ``1 / sqrt(qk_nope + qk_rope)``; ``o wo``.
* The dense layers (``first_k_dense_replace``): ``silu(h wg) * (h wu) wd``
  of width ``intermediate_size``.
* The MoE layers (DeepSeek-V3, arXiv:2412.19437 §2.1): scores
  ``s = sigmoid(h router)``; each token's ``num_experts_per_tok`` experts by
  ``s + bias`` (the lower index first among equal values); gates ``s`` of
  those, over their sum, times ``routed_scaling_factor``; each routed
  expert a SwiGLU of width ``moe_intermediate_size``; plus the shared
  experts, one SwiGLU of ``n_shared_experts`` times that width.
* The sequence-wise balance loss, per sequence of S tokens: ``sum_i f_i
  P_i``, ``f_i = E / (K S) * (tokens choosing i)``, ``P_i = mean_t s_i,t /
  sum_j s_j,t``; meaned over the sequences.
* The bias update after each step: ``b_i += gamma * sign(mean load - load_i)``
  with ``load_i`` the (token, choice) pairs that chose expert i in the
  step's forward pass.
* AdamW: the gradient clipped by its global norm, bias-corrected moments,
  decoupled weight decay on every leaf, a linear warm-up and a cosine; the
  parameters held in their stated dtypes between steps, every product and
  sum in f32.

Departures from the published description, each the program's:

* Capacity.  DeepSeek-V3 drops no tokens in training.  Here, as in the
  program, the tokens are cut into ``members`` blocks, the expert-parallel
  group's members (under sequence parallelism member j holds positions
  ``[j S / m, (j + 1) S / m)`` of every sequence), and each member keeps,
  for each expert, its first ``C = min(int(ceil(T K / E) *
  capacity_factor) + 1, T)`` pairs in its token-major order (T its tokens):
  the device-level dropping of DeepSeek-V2's training (arXiv:2405.04434
  §2.2).  A dropped pair adds nothing.
* RoPE rotates halves; the published checkpoint stores its rope columns
  interleaved, a fixed permutation of random weights' columns.
* AdamW in place of Muon (arXiv:2502.16982), with which Moonlight was
  trained.
* Norm scales are ``1 + scale``, initialised to zero, as the program
  parameterises them.

Routing flips.  A run in another precision (the program in bf16, or the
fp8 control) picks another set of experts for a token wherever two of its
experts' scores lie closer than that run's rounding moves them, and a
flipped choice moves the token's whole share of the gradient from one
expert to another: against the f32 reference that is a gap of about 10 %
in each expert weight's gradient, at every precision.  ``pinned`` hands
the reference the other run's choices, and the reference takes them for
each token where every expert they name lies within ``PIN_MARGIN`` of its
own K-th largest choice value (``pin``): a near-tie, as far as bf16's
rounding of the scores reaches.  A choice farther from the reference's
than that stays the reference's own, so a router that chooses wrongly
still shows in the gradients.  Each step's routing is compared besides
(``compare``): ``route_gap``, the share of (token, MoE layer) pairs whose
set of experts differs from the reference's own choice, pinned or not,
and ``bias_gap``, the selection biases after the steps against the
reference's, in units of the rate gamma.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (one scale a tensor, from its largest magnitude) in the
forward, the nearest precision below the bf16 that the configuration
states.  ``train_readings`` computes in blocks so that the published
widths fit one card beside nothing else: each layer, each attention block
of ``HEAD_CHUNK`` heads and each slab of ``LOSS_CHUNK`` positions of the
loss recomputed in the backward pass, and AdamW's moments kept on
``moments_device`` (the host at full size) between steps.
"""

from __future__ import annotations

import math
import statistics

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
LATENT_EPS = 1e-6
# The near-ties that rounding upstream may settle either way: a token's
# choice is taken from the other run where every expert it names lies
# within this of the reference's K-th choice value.  The program in bf16
# at the published widths routes another set than the reference for 8 %
# of (token, MoE layer) pairs, the farthest of them 0.0200 below the K-th
# value (5 seeds, 3 steps, 196k flips); this is 1.25 times that.
PIN_MARGIN = 0.026
HEAD_CHUNK = 4    # heads of one checkpointed attention block
LOSS_CHUNK = 1024  # positions of one checkpointed slab of the loss


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (forward only: the
    gradient passes through)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _keep(x):
    return x


def widths(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
            "vd": cfg["v_head_dim"], "r": cfg["kv_lora_rank"], "f": cfg["intermediate_size"],
            "fe": cfg["moe_intermediate_size"], "E": cfg["n_routed_experts"],
            "K": cfg["num_experts_per_tok"], "dense": cfg["first_k_dense_replace"],
            "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"]}


def rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, theta: float):
    """x (B, S, heads, n): rotate halves by position * theta^(-i / half)."""
    S, n = x.shape[1], x.shape[-1]
    half = n // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, wg, wu, wd, q8):
    return q8(F.silu(q8(x) @ q8(wg)) * (q8(x) @ q8(wu))) @ q8(wd)


def _attend(q, k, v, q8):
    """Causal attention of one block of heads: q, k (heads, S, dqk), v
    (heads, S, dv), at 1 / sqrt(dqk)."""
    S = q.shape[1]
    scores = (q8(q) @ q8(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return q8(probs) @ q8(v)


def mla(h, p, cfg: dict, q8=_keep):
    """Latent attention of the normed ``h`` (B, S, d), projected by ``wo``."""
    w = widths(cfg)
    B, S, _ = h.shape
    H, nope, rp, r = w["H"], w["nope"], w["rope"], w["r"]
    q = (q8(h) @ q8(p["attn.wq"])).view(B, S, H, nope + rp)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], -1)
    kv_a = q8(h) @ q8(p["attn.wkv_a"])
    k_pe = rope(kv_a[..., None, r:], cfg["rope_theta"]).expand(B, S, H, rp)
    kv = (q8(rms(kv_a[..., :r], p["attn.kv_norm"], LATENT_EPS)) @ q8(p["attn.wkv_b"]))
    kv = kv.view(B, S, H, nope + w["vd"])
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    out = []
    for b in range(B):
        qb, kb, vb = (t[b].transpose(0, 1) for t in (q, k, v))  # (H, S, n)
        out.append(torch.cat([
            checkpoint(_attend, qb[i:i + HEAD_CHUNK], kb[i:i + HEAD_CHUNK], vb[i:i + HEAD_CHUNK],
                       q8, use_reentrant=False)
            for i in range(0, H, HEAD_CHUNK)]).transpose(0, 1).reshape(S, -1))
    return q8(torch.stack(out)) @ q8(p["attn.wo"])


def pin(choice, idx, theirs, margin: float | None = None):
    """Another run's chosen experts ``theirs`` (..., K) in place of ``idx``,
    the top K of ``choice``, for each token whose every expert in
    ``theirs`` has a ``choice`` within ``margin`` (``PIN_MARGIN``) of the
    K-th largest: where the two runs' choices differ only at a near-tie, as
    rounding upstream makes them.  Returns (the choices, the routing's
    tally: tokens whose sets differ, tokens that took the other set, and
    the largest distance below the K-th value of a differing token's
    choices)."""
    margin = PIN_MARGIN if margin is None else margin
    kth = torch.gather(choice, -1, idx[..., -1:])
    below = (kth - torch.gather(choice, -1, theirs)).amax(-1, keepdim=True)
    differ = ~(torch.sort(theirs, -1)[0] == torch.sort(idx, -1)[0]).all(-1, keepdim=True)
    near = below <= margin
    tally = torch.stack([differ.sum().float(), (near & differ).sum().float(),
                         torch.where(differ, below, 0.0).amax().float()])
    return torch.where(near, theirs, idx), tally


def route(h, router, bias, cfg: dict, q8=_keep, pinned=None):
    """(scores (B, S, E), chosen experts (B, S, K), gates (B, S, K), the
    routing's tally): with ``pinned`` (another run's choices) the near-ties
    go its way (``pin``); without, the tally is zeros."""
    K = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(q8(h) @ q8(router))
    choice = scores.detach() + bias
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][..., :K]
    tally = choice.new_zeros(3)
    if pinned is not None:
        idx, tally = pin(choice, idx, pinned.to(idx.dtype))
    gates = torch.gather(scores, -1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    return scores, idx, gates, tally


def capacity(cfg: dict, T: int) -> int:
    E, K = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    return min(int(-(-T * K // E) * cfg["capacity_factor"]) + 1, T)


def kept(idx, E: int, C: int):
    """Of one member's pairs (T, K) in token-major order, those within the
    first ``C`` of their expert's."""
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    return (rank < C).view(idx.shape)


def moe(h, p, bias, cfg: dict, members: int, q8=_keep, pinned=None):
    """(routed + shared experts' output, balance loss, loads (E,), chosen
    experts (B, S, K), the routing's tally (``pin``))."""
    w = widths(cfg)
    B, S, d = h.shape
    E, K = w["E"], w["K"]
    scores, idx, gates, tally = route(h, p["moe.router"], bias, cfg, q8, pinned)
    chosen = F.one_hot(idx, E).sum(-2).float()                 # (B, S, E)
    f = E / (K * S) * chosen.sum(1)                            # (B, E)
    P = (scores / scores.sum(-1, keepdim=True)).mean(1)        # (B, E)
    balance = (f * P).sum(-1).mean()
    parts, span = [], S // members
    for j in range(members):
        xs = h[:, j * span:(j + 1) * span].reshape(-1, d)      # the member's tokens, in order
        ids, gs = idx[:, j * span:(j + 1) * span].reshape(-1, K), gates[:, j * span:(j + 1) * span]
        keep = kept(ids, E, capacity(cfg, xs.shape[0]))
        part = torch.zeros_like(xs)
        for e in range(E):
            tok, slot = torch.nonzero((ids == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = swiglu(xs[tok], p["moe.w_gate"][e], p["moe.w_up"][e], p["moe.w_down"][e], q8)
            part = part.index_add(0, tok, y * gs.reshape(-1, K)[tok, slot, None])
        parts.append(part.view(B, span, d))
    shared = swiglu(h, p["shared.w_gate"], p["shared.w_up"], p["shared.w_down"], q8)
    out = torch.cat(parts, 1) + shared
    return out, balance, chosen.sum((0, 1)).detach(), idx, tally


def _layer(x, p, bias, i, cfg, members, q8, pinned=None):
    """One layer: (x, balance loss, loads, chosen experts, the routing's
    tally), for a dense layer zero, zeros, None and zeros."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(rms(x, p["norm1"], eps), p, cfg, q8)
    h = rms(x, p["norm2"], eps)
    if i < cfg["first_k_dense_replace"]:
        zero = x.new_zeros(())
        return x + swiglu(h, p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"], q8), zero, \
            x.new_zeros((cfg["n_routed_experts"],)), None, x.new_zeros(3)
    out, balance, loads, idx, tally = moe(h, p, bias, cfg, members, q8, pinned)
    return x + out, balance, loads, idx, tally


def _slab_loss(x, head, y, q8):
    logits = q8(x) @ q8(head).T
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1), reduction="sum")


def loss_of(params: dict, biases: dict, batch: dict, cfg: dict, members: int = 1, q8=_keep,
            pinned=None):
    """(the loss, and by MoE layer index the loads, the chosen experts and
    the routing's tally) of ``batch`` under ``params`` and the selection
    ``biases`` (by layer index); ``pinned`` (another run's choices by layer
    index, or None) settles the near-ties (``pin``)."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"][batch["tokens"]]
    balance, loads, choices, tallies = x.new_zeros(()), {}, {}, {}
    for i in range(cfg["num_hidden_layers"]):
        p = {k[len(f"blocks.{i}."):]: t for k, t in params.items() if k.startswith(f"blocks.{i}.")}
        x, b, loads[i], choices[i], tallies[i] = checkpoint(
            _layer, x, p, biases.get(i), i, cfg, members, q8, (pinned or {}).get(i),
            use_reentrant=False)
        if i >= cfg["first_k_dense_replace"]:
            balance = balance + b
    x = rms(x, params["final_norm"], eps)
    y = batch["labels"]
    total = sum(checkpoint(_slab_loss, x[:, s:s + LOSS_CHUNK], params["lm_head"],
                           y[:, s:s + LOSS_CHUNK], q8, use_reentrant=False)
                for s in range(0, x.shape[1], LOSS_CHUNK))
    keep = list(moe_layers(cfg))
    return (total / y.numel() + cfg["aux_loss_alpha"] * balance,
            *({i: d[i] for i in keep} for d in (loads, choices, tallies)))


def lr_scale(step: int, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine to ``min_ratio``."""
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def moe_layers(cfg: dict) -> range:
    return range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"])


def train_readings(cfg: dict, opt: dict, weights: dict, batches: list, members: int = 1,
                   precision: str = "f32", moments_device=None, pinned=None) -> dict:
    """Follow ``len(batches)`` steps from ``weights`` (by name; their dtype is
    the one the parameters are held in) and zero biases.  Returns the loss
    of each step, each leaf's first gradient as the optimizer takes it
    (clipped), each leaf's change over the steps, as norms; the biases (by
    MoE layer, with their rate) and the parameters (f32) after the steps;
    each step's chosen experts by MoE layer, and its routing against
    ``pinned`` (another run's choices, a dict by MoE layer a step, which
    settles the near-ties its way): over the MoE layers, the tokens whose
    sets differ, those that took the other set and the largest distance
    (``pin``), and the share of (token, layer) pairs whose sets differ."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q8 = fp8 if precision == "fp8" else _keep
    device = weights["embed"].device
    moments_device = moments_device or device
    held = {k: t.dtype for k, t in weights.items()}
    params = {k: t.detach().float().clone().requires_grad_(True) for k, t in weights.items()}
    m = {k: torch.zeros(t.shape, device=moments_device) for k, t in params.items()}
    v = {k: torch.zeros(t.shape, device=moments_device) for k, t in params.items()}
    biases = {i: torch.zeros(cfg["n_routed_experts"], device=device) for i in moe_layers(cfg)}
    losses, first, choices, routing = [], {}, [], []
    for step, batch in enumerate(batches):
        loss, loads, chosen, n = loss_of(params, biases, batch, cfg, members, q8,
                                         pinned[step] if pinned else None)
        choices.append(chosen)
        n = torch.stack(list(n.values())).cpu()
        routing.append({"differing": int(n[:, 0].sum()), "pinned": int(n[:, 1].sum()),
                        "farthest": float(n[:, 2].max()),
                        "share": float(n[:, 0].sum()) / (batch["tokens"].numel() * len(n))})
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = torch.clamp(opt["grad_clip"] / (norm + 1e-9), max=1.0)
        lr = opt["lr"] * lr_scale(step, opt["warmup"], opt["total_steps"])
        b1c, b2c = 1.0 - opt["b1"] ** (step + 1), 1.0 - opt["b2"] ** (step + 1)
        with torch.no_grad():
            for k, p in params.items():
                g = grads.pop(k) * clip
                if step == 0:
                    first[k] = float(torch.linalg.vector_norm(g))
                mk, vk = m[k].to(device), v[k].to(device)
                mk.mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                vk.mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                new = p - lr * (mk / b1c / (torch.sqrt(vk / b2c) + opt["eps"])
                                + opt["weight_decay"] * p)
                p.copy_(new.to(held[k]).float())
                m[k].copy_(mk)
                v[k].copy_(vk)
                del g, mk, vk, new
            for i, load in loads.items():
                biases[i] += cfg["bias_update_speed"] * torch.sign(load.mean() - load)
        del loss, grads, loads
    change = {k: float(torch.linalg.vector_norm(p.detach() - weights[k].float()))
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "biases": biases, "bias_rate": cfg["bias_update_speed"],
            "params": {k: p.detach() for k, p in params.items()},
            "choices": choices, "routing": routing}


def counted(ref_norms: dict, floor: float = 1e-3) -> list:
    """The leaves that count: those whose reference gradient is not nought
    to rounding, at least ``floor`` of the median leaf's."""
    med = statistics.median(ref_norms.values())
    return [k for k, n in ref_norms.items() if n >= floor * med]


def worst(values) -> float:
    """The largest of ``values``; inf where one is NaN or inf."""
    values = list(values)
    return max(values) if all(map(math.isfinite, values)) else float("inf")


def leaf_gap(got: dict, ref: dict, leaves: list) -> float:
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return worst(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def bias_gap(got: dict, ref: dict, rate: float) -> float:
    """The selection biases' mean gap over every MoE layer's experts, in
    units of the rate ``rate``."""
    gaps = torch.cat([(got[i].float().cpu() - ref[i].float().cpu()).abs() for i in ref])
    return worst([float(gaps.mean()) / rate])


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers: ``loss_gap`` (nats, the worst step),
    ``grad_gap`` and ``change_gap`` (the worst counted leaf), ``route_gap``
    (the share of (token, MoE layer) pairs routed to another set of experts
    than the reference's own choice, the worst step) and ``bias_gap``
    (``bias_gap``); NaN reads as inf.  A leaf or a bias missing from ``got``
    raises."""
    leaves = counted(ref["grad_norms"])
    out = {"loss_gap": worst(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
           "grad_gap": leaf_gap(got["grad_norms"], ref["grad_norms"], leaves),
           "change_gap": leaf_gap(got["change_norms"], ref["change_norms"], leaves),
           "route_gap": worst(r["share"] for r in ref["routing"]),
           "bias_gap": bias_gap(got["biases"], ref["biases"], ref["bias_rate"])}
    if len(got["losses"]) != len(ref["losses"]):
        out["loss_gap"] = float("inf")
    return out
