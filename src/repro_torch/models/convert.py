"""Carry the JAX reference's parameters into the port.

``from_jax_params(params, cfg, device)`` takes the pytree that the
reference family's ``init`` returns, as a nested structure of numpy arrays
(``np.asarray`` of each leaf), and builds the port's model for
``cfg.family``:

* ``transformer``: layers stacked on a leading L dim (``layers`` holds
  ``norm1``, ``norm2``, the ``attn`` dict and an ``mlp`` dict, or a
  ``moe`` dict with its f32 ``router`` when ``cfg.n_experts``);
* ``rwkv6``: layers stacked on L (the reference ``vmap``s its layer init);
* ``rglru_hybrid``: a list of per-layer dicts, each with ``rec`` or
  ``attn``;
* ``whisper``: ``enc_layers`` and ``dec_layers`` stacked on L (the
  reference ``vmap``s their init), each a dict of dicts (norms, attention,
  MLP), beside ``enc_pos``, ``dec_embed``, ``enc_norm`` and ``dec_norm``.

``reference_leaves`` maps the port's parameter names back onto the
reference's leaves: a layer-stacked leaf is the port's per-layer
parameters in layer order.

``laid_out_specs``, ``unshard_tensors`` and ``global_grads`` read a
laid-out model's tensors back as global arrays (checkpoints hold those,
and the tests hold gradients by reference leaf against the reference's).

``shard_model(model, mesh, policy)`` lays a model out on a mesh by its
family's ``param_specs`` (``core.mesh.shard``: the mesh dims leading on the
stacked mesh, the member's block on a rank mesh), parameter by parameter
in layer order, dropping each source tensor once its layout exists, so
that the weights are never on the card twice; the model then knows its
``mesh`` and ``policy``.

Going through numpy keeps the port free of JAX.  Each leaf keeps its own
dtype (rwkv6 and the hybrid hold f32 leaves beside ``param_dtype`` ones).
A bf16 leaf arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
refuses: it goes through float32 and back to bf16, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import mesh as M
from repro_torch.models import rglru, rwkv6, whisper
from repro_torch.models.api import get_family
from repro_torch.models.common import ModelConfig, ShardingPolicy, param, resolve_device
from repro_torch.models.parallel import check_policy
from repro_torch.models.transformer import Block, Transformer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# The port's per-layer containers that the reference stacks on a leading L
# dim, by family (the hybrid keeps a list of per-layer dicts).
STACKED_LAYERS = {"transformer": ("blocks",), "rwkv6": ("layers",),
                  "whisper": ("enc_layers", "dec_layers")}


def leaf_of(name: str, cfg: ModelConfig) -> tuple[str, int]:
    """(the reference leaf of the port's parameter ``name``, its layer):
    ``blocks.3.attn.wq`` -> ("blocks.*.attn.wq", 3); any other name is a
    leaf of its own, at 0."""
    head, _, rest = name.partition(".")
    if head in STACKED_LAYERS.get(cfg.family, ()):
        layer, _, rest = rest.partition(".")
        return f"{head}.*.{rest}", int(layer)
    return name, 0


def reference_leaves(names, cfg: ModelConfig) -> dict:
    """The reference's pytree leaves in terms of the port's parameter names
    (``named_parameters`` order): ``"blocks.*.attn.wq"`` -> the names of
    ``blocks.<i>.attn.wq`` in layer order, stacked on L in the reference;
    any other name is a leaf of its own."""
    leaves = {}
    for name in names:
        leaf, layer = leaf_of(name, cfg)
        leaves.setdefault(leaf, []).append((layer, name))
    return {leaf: [n for _, n in sorted(pairs)] for leaf, pairs in leaves.items()}


def shard_model(model, mesh, policy: ShardingPolicy):
    """Lay ``model`` out on ``mesh`` under ``policy`` in place, one parameter
    at a time; returns it, with ``model.mesh`` and ``model.policy`` set."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError(f"the model is laid out on {model.mesh!r} already")
    if model.device.type != mesh.device.type:
        raise ValueError(f"the model lies on {model.device}, the mesh on {mesh.device}")
    check_policy(mesh, policy)
    cfg = model.cfg
    specs = get_family(cfg).param_specs(cfg, policy)
    for name in [n for n, _ in model.named_parameters()]:
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        src = getattr(module, attr)
        laid = M.shard(src.detach(), mesh, specs[leaf_of(name, cfg)[0]])
        module.register_parameter(attr, param(laid))
        del src
    model.mesh, model.policy = mesh, policy
    return model


def laid_out_specs(model) -> dict:
    """Each parameter's spec, by name, under the policy that ``model`` was
    laid out for (``shard_model``)."""
    cfg = model.cfg
    specs = get_family(cfg).param_specs(cfg, model.policy)
    return {name: specs[leaf_of(name, cfg)[0]] for name, _ in model.named_parameters()}


def unshard_tensors(model, tensors: dict) -> dict:
    """Tensors laid out as ``model``'s parameters (by name: the parameters,
    their optimizer moments, summed gradients) as global arrays, by name.
    On a rank mesh every member takes part and receives them."""
    specs = laid_out_specs(model)
    return {k: M.unshard(t, model.mesh, specs[k]) for k, t in tensors.items()}


def global_grads(model, grads: dict) -> dict:
    """The global gradients of a laid-out model, by reference leaf
    (``reference_leaves``: a layer-stacked leaf stacked on L), from each
    parameter's gradient by name as autograd gives it under the gradient
    convention of ``models/parallel.py``: each copy's share, summed here
    (``core.mesh.sum_copies``)."""
    specs = laid_out_specs(model)
    summed = unshard_tensors(model, {k: M.sum_copies(g, model.mesh, specs[k])
                                     for k, g in grads.items()})
    return {leaf: torch.stack([summed[n] for n in names]) if "*" in leaf else summed[names[0]]
            for leaf, names in reference_leaves(summed, model.cfg).items()}


def from_jax_params(params, cfg: ModelConfig, device=None, trainable: bool = False):
    """The port's model with the reference's weights (``device=None`` means
    CUDA, and raises without a card), requiring gradients when
    ``trainable``."""
    device = resolve_device(device)

    def tensor(a):
        dtype = _DTYPES[np.asarray(a).dtype.name]
        t = torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy
        return t.to(device=device, dtype=dtype)

    def tensors(tree, i=None):
        return {k: tensor(v if i is None else v[i]) for k, v in tree.items()}

    def nested(tree, i):  # one layer of a dict of dicts stacked on L
        return {k: tensors(v, i) for k, v in tree.items()}

    if cfg.family == "whisper":
        n_enc = cfg.encoder_layers or cfg.n_layers
        return whisper.Whisper(
            cfg, tensor(params["enc_pos"]), tensor(params["dec_embed"]),
            [nested(params["enc_layers"], i) for i in range(n_enc)],
            [nested(params["dec_layers"], i) for i in range(cfg.n_layers)],
            tensors(params["enc_norm"]), tensors(params["dec_norm"]), trainable)
    embed, final_norm = tensor(params["embed"]), tensor(params["final_norm"])
    layers = params["layers"]
    if cfg.family == "transformer":
        ffn = "moe" if "moe" in layers else "mlp"
        blocks = [Block(tensor(layers["norm1"][i]), tensor(layers["norm2"][i]),
                        tensors(layers["attn"], i), **{ffn: tensors(layers[ffn], i)})
                  for i in range(cfg.n_layers)]
        lm_head = tensor(params["lm_head"]) if "lm_head" in params else None
        return Transformer(cfg, embed, blocks, final_norm, lm_head, trainable)
    if cfg.family == "rwkv6":
        return rwkv6.Rwkv(cfg, embed, [tensors(layers, i) for i in range(cfg.n_layers)],
                          final_norm, tensor(params["lm_head"]), trainable)
    if cfg.family == "rglru_hybrid":
        hybrid_layers = []
        for lp in layers:
            kind = "rec" if "rec" in lp else "attn"
            hybrid_layers.append(rglru.Layer(kind, tensor(lp["norm1"]), tensor(lp["norm2"]),
                                             tensors(lp[kind]), tensors(lp["mlp"])))
        return rglru.Hybrid(cfg, embed, hybrid_layers, final_norm, trainable)
    raise KeyError(f"model family {cfg.family!r} is not ported yet (see ROADMAP.md)")
