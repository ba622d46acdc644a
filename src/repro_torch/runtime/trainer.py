"""Training loop: microbatching, data-parallel compressed gradients,
AdamW, checkpoints, recovery.

The port's counterpart of ``src/repro/runtime/trainer.py``.  A step takes
the gradient of the family's ``loss_fn`` by autograd (through the kernels'
``autograd.Function``s), accumulated over ``microbatches`` (the loss and
the gradients averaged), scales the learning rate by ``warmup_cosine`` at
the optimizer's step and applies ``adamw_update`` to the model's
parameters in place.  ``fit`` saves an async checkpoint every
``ckpt_every`` steps and a last one at the end, and resumes exactly from
the latest valid checkpoint (the data cursor is the step).

With ``compress_grads`` and ``dp_axis`` the step is the reference's
``shard_map`` over the DP axis of ``mesh``: member ``i`` of the axis takes
rows ``[i*B/n, (i+1)*B/n)`` of the global batch, computes its loss and
gradients (over its microbatches), and ``optim.compressed_mean`` gives
the members' int8 mean with a residual per member; AdamW then applies the
mean, equal on every member.  On the stacked mesh the members run one
after another on the card and AdamW runs once; on a rank mesh each rank
runs its member.  As in the reference, whose ``out_specs=P()`` under
``check_vma=False`` return device 0's shard, the logged loss is member
0's, and a checkpoint keeps member 0's residuals, which a resume gives
to every member.  On a rank mesh only member 0 writes checkpoints; every
rank restores.

With a sharding policy (``policy=``, and the ``mesh`` it names) the step
is the reference's jitted step under the policy: ``init_state`` lays the
model out on the mesh (``models.convert.shard_model``), the step
differentiates the family's ``loss_fn`` under the policy (the global loss,
which it reports), sums each gradient's copies into the global gradient
(``core.mesh.sum_copies``, once a step after the microbatches), and runs
AdamW on the laid-out parameters, its clip on the global norm.  A
parameter that gets no gradient raises, naming it.  An MoE with
DeepSeek-V3's selection bias (``router_bias_rate``) has its biases moved
after AdamW by the loads of the step's forward passes, summed over the
members (``models/mlp.py:update_router_biases``).  Checkpoints hold the
global parameters and moments (not the selection biases), so a sharded
run resumes unsharded and back.  Compressed gradients under a policy raise ``NotImplementedError``:
the reference's compressed step takes its parameters replicated inside
its ``shard_map``, so that its policy changes nothing for a dense model
and its expert-parallel MoE fails to lower (ROADMAP.md).

The training state is ``(model, opt_state, err_state)``: the model holds
the parameters; ``opt_state`` is AdamW's (``step``, ``m``, ``v``) and
``err_state`` the compression residuals, keyed by the reference's leaf
(``models.convert.reference_leaves``: ``blocks.*.attn.wq`` holds every
layer's, as the reference's layer-stacked leaf) and stacked per member on
a stacked mesh.  A checkpoint holds the state as one flat dict
(``params/<name>``, ``opt/step``, ``opt/m/<name>``, ``opt/v/<name>``,
``err/<leaf>``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import mesh as M
from repro_torch.models import get_family
from repro_torch.models.common import REPLICATED, ModelConfig, ShardingPolicy, resolve_device
from repro_torch.models.convert import (laid_out_specs, reference_leaves, shard_model,
                                        unshard_tensors)
from repro_torch.models.mlp import tally_loads, update_router_biases
from repro_torch.models.parallel import check_policy, is_sharded
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update, compressed_mean,
                               warmup_cosine)

PARAMS = "params/"


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    microbatches: int = 1
    compress_grads: bool = False
    dp_axis: Optional[str] = None      # set when running under a mesh
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    adamw: AdamWConfig = AdamWConfig()
    warmup: int = 20
    total_steps: int = 1000
    straggler_factor: float = 3.0      # step-time factor that flags a straggler


def params_of(model) -> dict:
    return dict(model.named_parameters())


def restore_params(model, ckpt_dir: str, step: int | None = None) -> int | None:
    """Load a trainer checkpoint's parameters into ``model`` in place;
    returns the checkpoint's step, or None when none is valid."""
    like = {PARAMS + k: p for k, p in params_of(model).items()}
    restored = CheckpointManager(ckpt_dir).restore(like, step)
    if restored is None:
        return None
    flat, step, _ = restored
    with torch.no_grad():
        for name, p in like.items():
            p.copy_(flat[name])
    return step


def _by_param(leaves: dict, grouped: dict) -> dict:
    """Tensors by parameter name from tensors by reference leaf."""
    out = {}
    for leaf, names in leaves.items():
        out.update(zip(names, grouped[leaf].unbind(0)) if "*" in leaf
                   else ((names[0], grouped[leaf]),))
    return out


class Trainer:
    """Trains ``model_cfg`` on ``device`` (None means CUDA, and raises without
    a card), or on ``mesh``'s device.  ``model``, when given, is the initial
    weights, unsharded: ``init_state`` copies it instead of drawing new ones
    (its device is then the trainer's).  ``mesh`` (a stacked ``Mesh`` or a
    ``RankMesh``) is needed by the data-parallel step (``compress_grads``
    with ``dp_axis``) and by a sharded ``policy`` (the reference's
    ``Trainer(..., policy=, mesh=)``); without them the whole batch is one
    member's."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig, device=None, model=None,
                 mesh=None, policy: ShardingPolicy = REPLICATED):
        self.dp = bool(tcfg.compress_grads and tcfg.dp_axis)
        self.policy = policy
        self.sharded = is_sharded(policy)
        if (self.dp or self.sharded) and mesh is None:
            raise ValueError("compressed data-parallel gradients and sharding policies run "
                             "over a mesh: pass mesh=")
        if self.sharded:
            if tcfg.compress_grads:
                raise NotImplementedError(
                    "compressed gradients under a sharding policy are not ported: the "
                    "reference's compressed step ignores its policy (ROADMAP.md)")
            if getattr(model, "mesh", None) is not None:
                raise ValueError("pass the initial model unsharded: the trainer lays it out")
            check_policy(mesh, policy)
        if self.dp:
            mesh.dim(tcfg.dp_axis)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.ranked = isinstance(mesh, M.RankMesh)
        if model is not None:
            self.device = model.device
        elif mesh is not None:
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.family = get_family(model_cfg)
        self._initial = model
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts) \
            if tcfg.ckpt_dir else None
        self._ema_step_time: Optional[float] = None
        self.metrics_log: list[dict] = []
        self.state = None  # (model, opt_state, err_state) after ``fit``
        self._layout = None  # (mesh, specs by name) of a laid-out model, from init_state
        self._loads = {}  # the step's MoE loads by selection bias (mlp.tally_loads)

    # -- step ----------------------------------------------------------------

    def _loss(self, model, batch):
        if self.sharded:
            return self.family.loss_fn(model, batch, self.model_cfg, self.policy)
        return self.family.loss_fn(model, batch, self.model_cfg)

    def _grads(self, model, batch):
        """(loss, grads by name): one batch, or the mean over microbatches
        (the gradients then accumulated in f32).  Under a policy each is
        the copies' shares of its laid-out parameter."""
        params = params_of(model)

        def value_and_grad(b):
            with self._tally():
                loss = self._loss(model, b)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            out = {}
            for (k, p), g in zip(params.items(), grads):
                if g is None and self.sharded:
                    raise RuntimeError(f"the sharded loss gives {k} no gradient")
                out[k] = torch.zeros_like(p) if g is None else g
            return loss.detach(), out

        mb = self.tcfg.microbatches
        if mb == 1:
            return value_and_grad(batch)
        rows = batch["tokens"].shape[0]
        if rows % mb:
            raise ValueError(f"a batch of {rows} rows does not split into {mb} microbatches")
        n = rows // mb
        loss = torch.zeros((), dtype=torch.float32, device=self.device)
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        for i in range(mb):
            part_loss, grads = value_and_grad({k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            loss = loss + part_loss
            for k, g in grads.items():
                acc[k] += g
        return loss / mb, {k: g / mb for k, g in acc.items()}

    def _dp_grads(self, model, batch, err_state):
        """(member 0's loss, the members' compressed mean gradients by
        parameter, new residuals) over the DP axis.  The compression runs on
        the reference's leaves (``reference_leaves``: one scale for a
        layer-stacked leaf), so the residuals are keyed by them."""
        mesh, axis = self.mesh, self.tcfg.dp_axis
        leaves = reference_leaves(params_of(model), self.model_cfg)
        n = mesh.size(axis)
        rows = batch["tokens"].shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over {n} members of {axis!r}")
        per = rows // n

        def rows_of(i):
            return {k: v[i * per:(i + 1) * per] for k, v in batch.items()}

        with mesh:
            if self.ranked:
                loss, grads = self._grads(model, rows_of(mesh.coord[mesh.dim(axis)]))
                grouped = {leaf: torch.stack([grads[k] for k in names]) if "*" in leaf
                           else grads[names[0]] for leaf, names in leaves.items()}
                del grads
                mean, err_state = compressed_mean(grouped, axis, err_state)
                return mesh.broadcast_first(loss), _by_param(leaves, mean), err_state
            # Stacked: the members one after another, their gradients stacked
            # along the axis' dim and copied along the mesh's other axes.
            d, lead = mesh.dim(axis), mesh.shape
            along = tuple(n if i == d else 1 for i in range(len(lead)))
            stacked, loss = {}, None
            for i in range(n):
                member_loss, grads = self._grads(model, rows_of(i))
                loss = member_loss if i == 0 else loss
                for leaf, names in leaves.items():
                    g0 = grads[names[0]]
                    if i == 0:
                        shape = (len(names),) * ("*" in leaf) + tuple(g0.shape)
                        stacked[leaf] = g0.new_empty((n,) + shape)
                    if "*" in leaf:
                        for j, k in enumerate(names):
                            stacked[leaf][i, j].copy_(grads[k])
                    else:
                        stacked[leaf][i].copy_(g0)
                del grads
            stacked = {k: g.reshape(along + g.shape[1:]).expand(lead + g.shape[1:])
                       for k, g in stacked.items()}
            mean, err_state = compressed_mean(stacked, axis, err_state)
            del stacked
        first = (0,) * len(lead)
        unequal = torch.zeros((), dtype=torch.bool, device=self.device)
        for m in mean.values():
            unequal |= (m != m[first]).any()
        if bool(unequal):
            raise RuntimeError("the compressed mean differs between members of the mesh")
        return loss, _by_param(leaves, {k: m[first].clone() for k, m in mean.items()}), err_state

    def _tally(self):
        """Around a loss's forward: the MoE's loads for the selection biases
        (``mlp.tally_loads``), where the config moves them."""
        if not self.model_cfg.router_bias_rate:
            return contextlib.nullcontext()
        return tally_loads(self._loads)

    def _step_fn(self, model, opt_state, batch, err_state):
        """One optimizer step; the model's parameters are updated in place,
        and the MoE's selection biases by the step's loads.
        Returns (model, opt_state, err_state, metrics)."""
        self._loads = {}
        if self.dp:
            loss, grads, err_state = self._dp_grads(model, batch, err_state)
        else:
            loss, grads = self._grads(model, batch)
        if self.sharded:  # each copy's share summed: the global gradient
            specs = self._layout[1]
            grads = {k: M.sum_copies(g, self.mesh, specs[k]) for k, g in grads.items()}
        with tracing.span("optimizer"):
            lr_scale = warmup_cosine(opt_state["step"], warmup=self.tcfg.warmup,
                                     total=self.tcfg.total_steps)
            params = params_of(model)
            # the old state is not read again: donate its moments (one copy at the peak)
            new, opt_state, metrics = adamw_update(params, grads, opt_state, self.tcfg.adamw,
                                                   lr_scale, self._layout, donate=True)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(new[k])
            if self._loads:
                update_router_biases(self._loads, self.model_cfg.router_bias_rate,
                                     self.mesh if self.sharded else None)
        metrics["loss"] = loss
        return model, opt_state, err_state, metrics

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: int = 0):
        """(model, opt_state, err_state): the given model copied, or weights
        drawn from a generator seeded with ``seed``."""
        if self._initial is not None:
            model = copy.deepcopy(self._initial).requires_grad_(True)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model = self.family.init(gen, self.model_cfg, self.device, trainable=True)
        self._layout = None
        if self.sharded:
            shard_model(model, self.mesh, self.policy).requires_grad_(True)
            self._layout = (self.mesh, laid_out_specs(model))
        params = params_of(model)
        opt_state = adamw_init(params)
        err_state = {}
        for leaf, names in reference_leaves(params, self.model_cfg).items():
            p = params[names[0]]
            shape = self._lead + (len(names),) * ("*" in leaf) + tuple(p.shape) \
                if self.tcfg.compress_grads else (1,)
            err_state[leaf] = torch.zeros(shape, dtype=torch.float32, device=p.device)
        return model, opt_state, err_state

    @property
    def _lead(self) -> tuple:
        """The stacked member dims of the residuals."""
        return self.mesh.shape[:self.mesh.stacked] if self.dp else ()

    def _flat(self, state) -> dict:
        """The state as one flat dict of global tensors (a laid-out model's
        parameters and moments unsharded: on a rank mesh every rank takes
        part)."""
        model, opt_state, err_state = state
        glob = (lambda d: unshard_tensors(model, d)) if self.sharded else (lambda d: d)
        flat = {PARAMS + k: p for k, p in glob({k: p.detach()
                                                  for k, p in params_of(model).items()}).items()}
        flat["opt/step"] = opt_state["step"]
        for part in ("m", "v"):
            flat.update({f"opt/{part}/{k}": t for k, t in glob(opt_state[part]).items()})
        first = (0,) * len(self._lead)  # member 0's residuals, as the reference saves
        flat.update({f"err/{k}": t[first] for k, t in err_state.items()})
        return flat

    def _load(self, state, flat: dict):
        """``state`` with every leaf replaced by ``flat``'s (the residuals
        given to every member; a laid-out model's leaves laid out again);
        the model's parameters are written in place."""
        model, opt_state, err_state = state
        lay = (lambda k, t: M.shard(t, self.mesh, self._layout[1][k])) if self.sharded \
            else (lambda k, t: t)
        with torch.no_grad():
            for k, p in params_of(model).items():
                p.copy_(lay(k, flat[PARAMS + k]))
        opt_state = {"step": flat["opt/step"],
                     **{part: {k: lay(k, flat[f"opt/{part}/{k}"]) for k in opt_state[part]}
                        for part in ("m", "v")}}
        err = {k: flat[f"err/{k}"].expand(self._lead + flat[f"err/{k}"].shape).clone()
               for k in err_state}
        return model, opt_state, err

    @property
    def _writes(self) -> bool:
        """Whether this process writes checkpoints: member 0 of a rank mesh,
        or the one process."""
        return not self.ranked or self.mesh.rank == self.mesh.ranks[0]

    # -- loop ----------------------------------------------------------------

    def fit(self, source, steps: int, seed: int = 0, start_step: int = 0,
            resume: bool = True):
        """Train up to step ``steps`` on ``source.batch_at(step)``; returns
        (model, opt_state) and keeps the whole state in ``self.state``."""
        state = self.init_state(seed)
        step = start_step
        if self.ckpt and resume:
            restored = self.ckpt.restore(self._flat(state))
            if restored is not None:
                flat, step, _ = restored
                state = self._load(state, flat)
                print(f"resumed from checkpoint @ step {step}")
        model, opt_state, err_state = state
        while step < steps:
            batch = {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                     for k, v in source.batch_at(step).items()}
            t0 = time.perf_counter()
            model, opt_state, err_state, metrics = self._step_fn(model, opt_state, batch,
                                                                 err_state)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self._watch_straggler(dt, step)
            step += 1
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt})
            if self.ckpt and step % self.tcfg.ckpt_every == 0:
                flat = self._flat((model, opt_state, err_state))  # collective when sharded
                if self._writes:
                    self.ckpt.save_async(step, flat, metadata={"loss": loss})
        self.state = (model, opt_state, err_state)
        if self.ckpt:
            flat = self._flat(self.state)
            if self._writes:
                self.ckpt.save(step, flat)
        if self.ckpt and self.ranked:
            self.mesh.barrier()  # every rank sees the last checkpoint
        return model, opt_state

    def _watch_straggler(self, dt: float, step: int):
        """Flag a step slower than ``straggler_factor`` times the moving
        average of step times (on a fleet, the cue to swap in a spare and
        re-run deterministically from the last checkpoint)."""
        if self._ema_step_time is None:
            self._ema_step_time = dt
            return
        if dt > self.tcfg.straggler_factor * self._ema_step_time and step > 3:
            self.metrics_log.append({"step": step, "straggler": dt})
        self._ema_step_time = 0.9 * self._ema_step_time + 0.1 * dt

    # -- failure recovery ----------------------------------------------------

    def recover(self, like_state):
        """The latest valid checkpoint loaded into ``like_state``: (state,
        step, metadata)."""
        if self.ckpt is None:
            raise RuntimeError("recovery requires a checkpoint dir")
        restored = self.ckpt.restore(self._flat(like_state))
        if restored is None:
            raise RuntimeError("no valid checkpoint to recover from")
        flat, step, metadata = restored
        return self._load(like_state, flat), step, metadata
