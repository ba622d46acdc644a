"""The dense gated MLP (``src/repro/models/mlp.py:20-45``).

``silu(x @ W_gate) * (x @ W_up) @ W_down`` in the compute dtype.  The
products are plain ``torch.matmul``, as the reference leaves them to XLA.
The capacity-based MoE waits (ROADMAP.md).
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
