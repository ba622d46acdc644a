"""Step functions, inputs and layouts for every (arch x shape) cell.

The port's counterpart of ``src/repro/launch/steps.py``.  ``make_policy``
is the reference's.  ``build_cell(cfg, shape_name, mesh)`` builds a cell
on a stacked ``core.mesh.Mesh`` (the production mesh of
``launch/mesh.py``, or a smaller one), with the reference's options, and
returns a dict:

* ``step_fn``: the train, prefill or decode step, taking the laid-out
  inputs in the reference's order: ``(model, opt_state, batch)``,
  ``(model, tokens)`` (whisper: ``(model, batch)``) or ``(model, cache,
  tokens, pos)``.  The model is the family's module laid out by
  ``models.convert.shard_model`` (the reference's ``params``); the batch
  and the tokens are laid out by their specs and unsharded by the step
  (the families take global tokens); ``pos`` is a Python int;
* ``make_inputs(device=None, seed=0, model=None)``: those inputs, laid out
  on the mesh's device: a card, the CPU, meta tensors or a
  ``FakeTensorMode`` (the dry run, ``launch/dryrun.py``); random weights
  from ``seed``, or ``model`` (unsharded) laid out in place;
* ``specs``: one tree of :class:`InputSpec` (global shape, dtype, spec) for
  each input: the parameters by name through the family's
  ``param_specs`` (a layer-stacked reference leaf is one entry per layer,
  ``models.convert.reference_leaves``), the optimizer state through
  ``optim.opt_state_specs`` (ZeRO-1 over the batch axes), the batch, the
  cache through the family's ``cache_spec``;
* ``donate`` (documentation: the inputs a step consumes, as the
  reference donates them; the train step updates the model's parameters
  in place, the decode step the cache), ``kind`` and ``policy``.

The train step is the reference's: the family's sharded ``loss_fn`` and
its gradients, accumulated over ``microbatches`` in f32 in the layout of
the state (each microbatch's gradients reduce-scattered into it: a
``psum_scatter`` over the batch axes on the ZeRO dim, a ``psum`` over the
other axes that a parameter's spec leaves out), then
``adamw_update(..., update_specs=)``.  The long-context decode
(``long_500k``) keeps the batch whole and lays the transformer's cache out
on its sequence over ``"data"`` (``ShardingPolicy.cache_seq_axis``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core import mesh as M
from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.launch.shapes import SHAPES, ShapeCell, applicable
from repro_torch.models import get_family
from repro_torch.models.attention import KVCache
from repro_torch.models.common import ModelConfig, ShardingPolicy
from repro_torch.models.convert import leaf_of, shard_model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import opt_state_specs, zero_dim


def make_policy(cfg: ModelConfig, mesh, *, shard_batch: bool = True,
                seq_parallel: bool = False,
                align_decode_cache: bool = False) -> ShardingPolicy:
    return ShardingPolicy(
        batch_axes=batch_axes(mesh) if shard_batch else (),
        model_axis="model",
        mesh_axis_sizes=axis_sizes(mesh),
        seq_axis="model" if seq_parallel else None,
        align_decode_cache=align_decode_cache,
    )


class InputSpec(NamedTuple):
    """One input leaf: its global shape and dtype, and its layout."""

    shape: tuple
    dtype: torch.dtype
    spec: tuple


def _is_leaf(x) -> bool:
    return isinstance(x, InputSpec)


def leaves(tree):
    """The :class:`InputSpec` leaves of a tree (dicts, lists, NamedTuples),
    in order, with None skipped."""
    if _is_leaf(tree):
        return [tree]
    if tree is None:
        return []
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in leaves(item)]


def tree_map(fn, tree):
    """``fn`` of every :class:`InputSpec` leaf, the tree's structure kept."""
    if _is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return type(tree)(*(tree_map(fn, v) for v in tree))


def local_shape(leaf: InputSpec, mesh) -> tuple:
    """A member's block of the leaf's global shape under its spec."""
    spec = tuple(leaf.spec) + (None,) * (len(leaf.shape) - len(tuple(leaf.spec)))
    return tuple(g // math.prod(mesh.size(a) for a in M._axes_of(e))
                 for g, e in zip(leaf.shape, spec))


def member_bytes(trees, mesh) -> int:
    """The bytes one member holds of the inputs ``trees``, from their specs."""
    return sum(math.prod(local_shape(leaf, mesh)) * leaf.dtype.itemsize
               for tree in trees for leaf in leaves(tree))


def _laid_zeros(leaf: InputSpec, mesh):
    """Zeros laid out as ``leaf`` on ``mesh``: the member's block, behind
    the stacked mesh dims."""
    lead = tuple(mesh.shape[:mesh.stacked])
    return torch.zeros(lead + local_shape(leaf, mesh), dtype=leaf.dtype, device=mesh.device)


# ---------------------------------------------------------------------------
# Cache shape/spec builders per family
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, cell: ShapeCell, policy: ShardingPolicy):
    """The cache as a tree of :class:`InputSpec`, in the family's cache
    structure, laid out by its ``cache_spec`` under ``policy`` (the
    transformer's sequence over ``policy.cache_seq_axis``, which
    :func:`build_cell` sets for the long-context decode)."""
    fam = get_family(cfg)
    spec = fam.cache_spec(cfg, policy)
    B, S = cell.global_batch, cell.seq_len
    cd = cfg.compute_dtype
    if cfg.family == "transformer":
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(InputSpec(shape, cd, spec), InputSpec(shape, cd, spec))
    if cfg.family == "whisper":
        shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        return fam.WhisperCache(
            self_kv=KVCache(InputSpec(shape, cd, spec.self_kv.k),
                            InputSpec(shape, cd, spec.self_kv.v)),
            memory=InputSpec((B, cfg.encoder_len, cfg.d_model), cd, spec.memory))
    if cfg.family == "rwkv6":
        H, hd = fam._heads(cfg)
        return fam.RwkvCache(
            state=InputSpec((cfg.n_layers, B, H, hd, hd), torch.float32, spec.state),
            shift=InputSpec((cfg.n_layers, B, 2, cfg.d_model), cd, spec.shift))
    if cfg.family == "rglru_hybrid":
        w = fam._lru_width(cfg)
        window = max(1, min(cfg.attn_window or S, S))
        kv = (B, window, cfg.n_kv_heads, cfg.head_dim)
        return fam.HybridCache(
            rec_h=[None if s is None else InputSpec((B, w), torch.float32, s)
                   for s in spec.rec_h],
            conv=[None if s is None else InputSpec((B, cfg.conv_width - 1, w), cd, s)
                  for s in spec.conv],
            attn=[None if s is None else KVCache(InputSpec(kv, cd, s.k), InputSpec(kv, cd, s.v))
                  for s in spec.attn])
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Cell builder
# ---------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, policy: ShardingPolicy) -> dict:
    """Every parameter by name as an :class:`InputSpec` (its global shape
    and dtype, from a model built on meta tensors; its spec from the
    family's ``param_specs``)."""
    fam = get_family(cfg)
    specs = fam.param_specs(cfg, policy)
    model = fam.init(torch.Generator().manual_seed(0), cfg, "meta")
    return {n: InputSpec(tuple(p.shape), p.dtype, tuple(specs[leaf_of(n, cfg)[0]]))
            for n, p in model.named_parameters()}


def _reduce_grad(g, mesh, pspec, zspec):
    """A parameter's gradient (each copy's share, laid out as the parameter)
    summed into the layout ``zspec``: a ``psum`` over each axis that
    ``pspec`` leaves out and ``zspec`` does not take, a ``psum_scatter`` on
    the ZeRO dim over the axes it does take (major first)."""
    k = mesh.stacked
    zero = zero_dim(pspec, zspec, g.ndim - k)
    dim, axes = zero if zero is not None else (None, ())
    named = M._named(tuple(pspec), mesh)
    with mesh:
        for name, size in zip(mesh.axis_names, mesh.shape):
            if name not in named and name not in axes and size > 1:
                g = M.psum(g, name)
        for a in axes:
            g = M.psum_scatter(g.movedim(k + dim, k), a, tiled=True).movedim(k, k + dim)
    return g


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               adamw: AdamWConfig = AdamWConfig(), zero1: bool = True,
               seq_parallel: bool | None = None,
               align_decode_cache: bool = True,
               microbatches: int = 1):
    """Returns dict(step_fn, make_inputs, specs, donate, kind, policy)."""
    ok, why = applicable(cfg, shape_name)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name} skipped: {why}")
    cell = SHAPES[shape_name]
    fam = get_family(cfg)
    long_ctx = shape_name == "long_500k"
    if seq_parallel is None:
        # Sequence parallelism on for training AND prefill by default;
        # decode has seq_len 1 per step.
        seq_parallel = cell.kind in ("train", "prefill") and cell.seq_len > 1024
    policy = make_policy(cfg, mesh, shard_batch=not long_ctx, seq_parallel=seq_parallel,
                         align_decode_cache=align_decode_cache)
    if long_ctx and cfg.family == "transformer":
        policy = dataclasses.replace(policy, cache_seq_axis="data")
    p_specs = param_specs(cfg, policy)
    bspec = policy.batch_axes or None
    B, S = cell.global_batch, cell.seq_len
    cd = cfg.compute_dtype

    def tokens_spec(length):
        return InputSpec((B, length), torch.int32, (bspec, None))

    def frames_spec():
        return InputSpec((B, cfg.encoder_len, cfg.d_model), cd, (bspec, None, None))

    def lay(x, leaf):
        return M.shard(x, mesh, leaf.spec)

    def unshard(x, leaf):
        return M.unshard(x, mesh, leaf.spec)

    def random_tokens(leaf, gen, device):
        return torch.randint(0, cfg.vocab, leaf.shape, generator=gen, dtype=torch.int32,
                             device=device)

    def model_of(device, seed, model, trainable):
        if device.type != mesh.device.type:
            raise ValueError(f"inputs on {device}, the mesh on {mesh.device}")
        gen_device = device if device.type == "cuda" and not _faking() else "cpu"
        gen = torch.Generator(device=gen_device).manual_seed(seed)
        if model is None:
            model = fam.init(gen, cfg, device, trainable=trainable)
        shard_model(model, mesh, policy).requires_grad_(trainable)
        return model, gen

    if cell.kind == "train":
        shapes = {n: leaf.shape for n, leaf in p_specs.items()}
        z_specs = opt_state_specs({n: leaf.spec for n, leaf in p_specs.items()}, shapes,
                                  batch_axes=batch_axes(mesh), zero1=zero1,
                                  axis_sizes=axis_sizes(mesh))["m"]
        state_leaves = {n: InputSpec(leaf.shape, torch.float32, tuple(z_specs[n]))
                        for n, leaf in p_specs.items()}
        o_specs = {"step": InputSpec((), torch.int32, ()), "m": state_leaves,
                   "v": dict(state_leaves)}
        batch_specs = {"tokens": tokens_spec(S), "labels": tokens_spec(S)}
        if cfg.family == "whisper":
            batch_specs["frames"] = frames_spec()
        pspec = {n: leaf.spec for n, leaf in p_specs.items()}

        def train_step(model, opt_state, batch):
            params = dict(model.named_parameters())
            glob = {k: unshard(v, batch_specs[k]) for k, v in batch.items()}
            rows = B // microbatches
            loss, acc = None, {}
            for i in range(microbatches):
                part = {k: v[i * rows:(i + 1) * rows] for k, v in glob.items()}
                with torch.enable_grad():
                    part_loss = fam.loss_fn(model, part, cfg, policy)
                    grads = torch.autograd.grad(part_loss, list(params.values()))
                for (n, _), g in zip(params.items(), grads):
                    g = _reduce_grad(g, mesh, pspec[n], z_specs[n])
                    if microbatches > 1:  # the f32 accumulator, in the state's layout
                        g = g.float() if i == 0 else acc[n] + g.float()
                    acc[n] = g
                del grads
                loss = part_loss.detach() if loss is None else loss + part_loss.detach()
            if microbatches > 1:
                loss = loss / microbatches
                acc = {n: g / microbatches for n, g in acc.items()}
            new, opt_state, metrics = adamw_update(
                params, acc, opt_state, adamw, layout=(mesh, pspec),
                update_specs=z_specs if zero1 else None)
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(new[n])
            metrics["loss"] = loss
            return model, opt_state, metrics

        def make_inputs(device=None, seed: int = 0, model=None):
            device = torch.device(device) if device is not None else mesh.device
            model, gen = model_of(device, seed, model, True)
            opt_state = {"step": lay(torch.zeros((), dtype=torch.int32, device=device),
                                     o_specs["step"]),
                         "m": {n: _laid_zeros(leaf, mesh) for n, leaf in state_leaves.items()},
                         "v": {n: _laid_zeros(leaf, mesh) for n, leaf in state_leaves.items()}}
            batch = {k: lay(random_tokens(leaf, gen, device), leaf)
                     for k, leaf in batch_specs.items() if k != "frames"}
            if "frames" in batch_specs:
                leaf = batch_specs["frames"]
                batch["frames"] = lay(torch.randn(leaf.shape, generator=gen, device=device)
                                      .to(leaf.dtype), leaf)
            return model, opt_state, batch

        return {"step_fn": train_step, "make_inputs": make_inputs,
                "specs": (p_specs, o_specs, batch_specs), "donate": (0, 1),
                "kind": "train", "policy": policy}

    if cell.kind == "prefill":
        whisper = cfg.family == "whisper"
        in_specs = ({"frames": frames_spec(), "tokens": tokens_spec(S)} if whisper
                    else tokens_spec(S))

        @torch.no_grad()
        def prefill_step(model, tokens):
            if whisper:
                tokens = {k: unshard(v, in_specs[k]) for k, v in tokens.items()}
            else:
                tokens = unshard(tokens, in_specs)
            return fam.prefill(model, tokens, cfg, policy, max_len=S)

        def make_inputs(device=None, seed: int = 0, model=None):
            device = torch.device(device) if device is not None else mesh.device
            model, gen = model_of(device, seed, model, False)
            if not whisper:
                return model, lay(random_tokens(in_specs, gen, device), in_specs)
            leaf = in_specs["frames"]
            frames = torch.randn(leaf.shape, generator=gen, device=device).to(leaf.dtype)
            return model, {"frames": lay(frames, leaf),
                           "tokens": lay(random_tokens(in_specs["tokens"], gen, device),
                                         in_specs["tokens"])}

        return {"step_fn": prefill_step, "make_inputs": make_inputs,
                "specs": (p_specs, in_specs), "donate": (), "kind": "prefill",
                "policy": policy}

    # decode
    c_specs = cache_specs(cfg, cell, policy)
    tok_spec = tokens_spec(1)
    pos_spec = InputSpec((), torch.int32, ())

    @torch.no_grad()
    def decode_step(model, cache, tokens, pos: int):
        return fam.decode_step(model, cache, unshard(tokens, tok_spec), pos, cfg, policy)

    def make_inputs(device=None, seed: int = 0, model=None):
        device = torch.device(device) if device is not None else mesh.device
        model, gen = model_of(device, seed, model, False)
        cache = tree_map(lambda leaf: _laid_zeros(leaf, mesh), c_specs)
        return model, cache, lay(random_tokens(tok_spec, gen, device), tok_spec), S - 1

    return {"step_fn": decode_step, "make_inputs": make_inputs,
            "specs": (p_specs, c_specs, tok_spec, pos_spec), "donate": (1,),
            "kind": "decode", "policy": policy}


def _faking() -> bool:
    """Whether a ``FakeTensorMode`` is active (its generator stays on the host)."""
    return torch._guards.detect_fake_mode() is not None


def input_specs(cfg: ModelConfig, shape_name: str, mesh):
    """The :class:`InputSpec` trees of every model input of this cell."""
    return build_cell(cfg, shape_name, mesh)["specs"]
