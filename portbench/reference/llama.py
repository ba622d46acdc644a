"""The plain reference of the training cell: a dense GQA transformer
(Llama's layer, as Yi-6B publishes it) and AdamW, in f32 with TF32 off,
followed through the first steps of training; and the comparison that
decides ``correct`` there.  Imports nothing of the program.

The model: the embedding looked up; each layer a pre-norm residual
attention (RoPE on halves, causal softmax at 1 / sqrt(head_dim), the KV
heads repeated over their query groups) and a pre-norm residual SwiGLU
MLP; RMSNorm scales by 1 + scale; the untied head's logits over the
vocabulary; the mean next-token cross-entropy.  AdamW as the configuration
states: the gradient clipped by its global norm, bias-corrected moments,
decoupled weight decay on every leaf, a linear warm-up; the parameters are
held in their stated dtype (bf16) between steps, as the program holds
them, and every product and sum is f32.

``precision="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (one scale a tensor, from its largest magnitude) in the
forward, the nearest precision below the bf16 that the configuration
states.
"""

from __future__ import annotations

import math
import statistics

import torch
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
HEAD_CHUNK = 8  # query heads a checkpointed attention block


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (forward only: the
    gradient passes through)."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _keep(x):
    return x


def rms(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def rope(x, theta: float):
    """x (B, S, heads, hd): rotate halves by position * theta^(-i / half)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attend(q, k, v, q8):
    """Causal attention of one block of heads: q, k, v (heads, S, hd)."""
    S = q.shape[1]
    scores = (q8(q) @ q8(k).transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return q8(probs) @ q8(v)


def _layer(x, p, w, eps, theta, q8):
    B, S, d = x.shape
    h = rms(x, p["norm1"], eps)
    q = (q8(h) @ q8(p["attn.wq"])).view(B, S, w["h"], w["hd"])
    k = (q8(h) @ q8(p["attn.wk"])).view(B, S, w["kv"], w["hd"])
    v = (q8(h) @ q8(p["attn.wv"])).view(B, S, w["kv"], w["hd"])
    q, k = rope(q, theta), rope(k, theta)
    group = w["h"] // w["kv"]
    k, v = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    out = []
    for b in range(B):
        qb, kb, vb = (t[b].transpose(0, 1) for t in (q, k, v))  # (H, S, hd)
        out.append(torch.cat([
            checkpoint(_attend, qb[i:i + HEAD_CHUNK], kb[i:i + HEAD_CHUNK], vb[i:i + HEAD_CHUNK],
                       q8, use_reentrant=False)
            for i in range(0, w["h"], HEAD_CHUNK)]).transpose(0, 1).reshape(S, -1))
    x = x + q8(torch.stack(out)) @ q8(p["attn.wo"])
    h = rms(x, p["norm2"], eps)
    g = torch.nn.functional.silu(q8(h) @ q8(p["mlp.w_gate"])) * (q8(h) @ q8(p["mlp.w_up"]))
    return x + q8(g) @ q8(p["mlp.w_down"])


def loss_of(params: dict, batch: dict, cfg: dict, w: dict, q8=_keep) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch`` under ``params`` (f32)."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    x = params["embed"][batch["tokens"]]
    for i in range(w["L"]):
        p = {k[len(f"blocks.{i}."):]: t for k, t in params.items() if k.startswith(f"blocks.{i}.")}
        x = checkpoint(_layer, x, p, w, eps, theta, q8, use_reentrant=False)
    x = rms(x, params["final_norm"], eps)
    logits = q8(x) @ q8(params["lm_head"]).T
    return torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                                             batch["labels"].reshape(-1))


def lr_scale(step: int, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine to ``min_ratio``."""
    warm = min(step / max(warmup, 1), 1.0)
    frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))


def train_readings(cfg: dict, opt: dict, weights: dict, batches: list,
                   precision: str = "f32") -> dict:
    """Follow ``len(batches)`` steps from ``weights`` (by name; their dtype is
    the one the parameters are held in).  Returns the loss of each step,
    each leaf's first gradient as the optimizer takes it (clipped), and
    each leaf's change over the steps, as norms."""
    from portbench.inputs import widths

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q8 = fp8 if precision == "fp8" else _keep
    w = widths(cfg)
    held = {k: t.dtype for k, t in weights.items()}
    params = {k: t.detach().float().clone().requires_grad_(True) for k, t in weights.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    losses, first = [], {}
    for step, batch in enumerate(batches):
        loss = loss_of(params, batch, cfg, w, q8)
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
                m[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[k].mul_(opt["b2"]).add_(g * g, alpha=1 - opt["b2"])
                new = p - lr * (m[k] / b1c / (torch.sqrt(v[k] / b2c) + opt["eps"])
                                + opt["weight_decay"] * p)
                p.copy_(new.to(held[k]).float())
        del loss, grads
    change = {k: float(torch.linalg.vector_norm(p.detach() - weights[k].float()))
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": first, "change_norms": change}


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


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers: ``loss_gap`` (nats, the worst step),
    ``grad_gap`` and ``change_gap`` (the worst counted leaf); NaN reads as
    inf.  A leaf missing from ``got`` raises."""
    leaves = counted(ref["grad_norms"])
    out = {"loss_gap": worst(abs(a - b) for a, b in zip(got["losses"], ref["losses"])),
           "grad_gap": leaf_gap(got["grad_norms"], ref["grad_norms"], leaves),
           "change_gap": leaf_gap(got["change_norms"], ref["change_norms"], leaves)}
    if len(got["losses"]) != len(ref["losses"]):
        out["loss_gap"] = float("inf")
    return out
