"""Carry the JAX reference's transformer parameters into the port.

``from_jax_params(params, cfg, device)`` takes the pytree that
``repro.models.transformer.init`` returns, as a nested dict of numpy arrays
(``np.asarray`` of each leaf) with the layers stacked on a leading L dim,
and builds the port's ``Transformer``.  Going through numpy keeps the port
free of JAX.  A bf16 leaf arrives as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses: it goes through float32 and back to the
config's dtype, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.models.transformer import Block, Transformer


def from_jax_params(params, cfg: ModelConfig, device=None) -> Transformer:
    """The port's model with the reference's weights (``device=None`` means
    CUDA, and raises without a card)."""
    device = resolve_device(device)

    def tensor(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
        return t.to(device=device, dtype=cfg.param_dtype)

    layers = params["layers"]
    blocks = []
    for i in range(cfg.n_layers):
        blocks.append(Block(
            tensor(layers["norm1"][i]), tensor(layers["norm2"][i]),
            {k: tensor(v[i]) for k, v in layers["attn"].items()},
            {k: tensor(v[i]) for k, v in layers["mlp"].items()}))
    lm_head = tensor(params["lm_head"]) if "lm_head" in params else None
    return Transformer(cfg, tensor(params["embed"]), blocks, tensor(params["final_norm"]),
                       lm_head)
