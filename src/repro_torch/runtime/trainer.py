"""Training loop: microbatching, AdamW, checkpoints, recovery.

The port's counterpart of ``src/repro/runtime/trainer.py`` on one card.
A step takes the gradient of the family's ``loss_fn`` by autograd (through
the kernels' ``autograd.Function``s), accumulated over ``microbatches``
(the loss and the gradients averaged), scales the learning rate by
``warmup_cosine`` at the optimizer's step and applies ``adamw_update`` to
the model's parameters in place.  ``fit`` saves an async checkpoint every
``ckpt_every`` steps and a last one at the end, and resumes exactly from
the latest valid checkpoint (the data cursor is the step).  The
int8-compressed data-parallel mean (``compress_grads`` with ``dp_axis``)
needs one rank per card and raises (ROADMAP.md).

The training state is ``(model, opt_state, err_state)``: the model holds
the parameters; ``opt_state`` is AdamW's (``step``, ``m``, ``v``) and
``err_state`` the compression residuals, both keyed by parameter name.  A
checkpoint holds it as one flat dict (``params/<name>``, ``opt/step``,
``opt/m/<name>``, ``opt/v/<name>``, ``err/<name>``).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models import get_family
from repro_torch.models.common import ModelConfig, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine

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


class Trainer:
    """Trains ``model_cfg`` on ``device`` (None means CUDA, and raises without
    a card).  ``model``, when given, is the initial weights: ``init_state``
    copies it instead of drawing new ones (its device is then the
    trainer's)."""

    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig, device=None, model=None):
        if tcfg.compress_grads and tcfg.dp_axis:
            raise NotImplementedError(
                "compressed data-parallel gradients need the one-rank-per-card "
                "torch.distributed backend (ROADMAP.md)")
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = model.device if model is not None else resolve_device(device)
        self.family = get_family(model_cfg)
        self._initial = model
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts) \
            if tcfg.ckpt_dir else None
        self._ema_step_time: Optional[float] = None
        self.metrics_log: list[dict] = []
        self.state = None  # (model, opt_state, err_state) after ``fit``

    # -- step ----------------------------------------------------------------

    def _loss(self, model, batch):
        return self.family.loss_fn(model, batch, self.model_cfg)

    def _grads(self, model, batch):
        """(loss, grads by name): one batch, or the mean over microbatches
        (the gradients then accumulated in f32)."""
        params = params_of(model)

        def value_and_grad(b):
            loss = self._loss(model, b)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                                   for (k, p), g in zip(params.items(), grads)}

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

    def _step_fn(self, model, opt_state, batch, err_state):
        """One optimizer step; the model's parameters are updated in place.
        Returns (model, opt_state, err_state, metrics)."""
        loss, grads = self._grads(model, batch)
        lr_scale = warmup_cosine(opt_state["step"], warmup=self.tcfg.warmup,
                                 total=self.tcfg.total_steps)
        params = params_of(model)
        new, opt_state, metrics = adamw_update(params, grads, opt_state, self.tcfg.adamw,
                                               lr_scale)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
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
        params = params_of(model)
        opt_state = adamw_init(params)
        err_shape = (lambda p: p.shape) if self.tcfg.compress_grads else (lambda p: (1,))
        err_state = {k: torch.zeros(err_shape(p), dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
        return model, opt_state, err_state

    @staticmethod
    def _flat(state) -> dict:
        model, opt_state, err_state = state
        flat = {PARAMS + k: p.detach() for k, p in params_of(model).items()}
        flat["opt/step"] = opt_state["step"]
        for part in ("m", "v"):
            flat.update({f"opt/{part}/{k}": t for k, t in opt_state[part].items()})
        flat.update({f"err/{k}": t for k, t in err_state.items()})
        return flat

    @staticmethod
    def _load(state, flat: dict):
        """``state`` with every leaf replaced by ``flat``'s; the model's
        parameters are written in place."""
        model, opt_state, err_state = state
        with torch.no_grad():
            for k, p in params_of(model).items():
                p.copy_(flat[PARAMS + k])
        opt_state = {"step": flat["opt/step"],
                     **{part: {k: flat[f"opt/{part}/{k}"] for k in opt_state[part]}
                        for part in ("m", "v")}}
        return model, opt_state, {k: flat[f"err/{k}"] for k in err_state}

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
                self.ckpt.save_async(step, self._flat((model, opt_state, err_state)),
                                     metadata={"loss": loss})
        self.state = (model, opt_state, err_state)
        if self.ckpt:
            self.ckpt.save(step, self._flat(self.state))
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
