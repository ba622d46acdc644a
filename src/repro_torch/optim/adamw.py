"""AdamW on a flat dict of parameters (``src/repro/optim/adamw.py``).

The state mirrors the parameters: ``m`` and ``v`` hold one f32 tensor per
parameter whatever the parameter's dtype, and ``step`` is an int32 tensor
on their device.  ``adamw_update`` clips by the global norm of the
gradients, corrects the moments' bias, decays every leaf (decoupled), and
computes the update in f32, cast back to each parameter's dtype; it is
functional, like the reference: it returns new tensors and leaves its
arguments as they are.  ``torch.optim.AdamW`` is not used: it keeps a bf16
parameter's state in bf16 and has no global clip.  The ZeRO-1 state specs
(``opt_state_specs``) wait for the multi-card backend (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict) -> dict:
    """Zero moments in f32 and step 0, beside ``params`` (name -> tensor)."""
    device = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new params, new state, metrics {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale
    new_params, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].float() * scale
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * torch.square(g)
        p32 = p.detach().float()
        new_p = p32 - lr * (m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
                            + cfg.weight_decay * p32)
        new_params[k], new_m[k], new_v[k] = new_p.to(p.dtype), m, v
    return new_params, {"step": step, "m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}
