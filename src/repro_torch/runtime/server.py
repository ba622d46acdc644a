"""Batched serving: slot-based continuous batching over prefill/decode steps.

The port's counterpart of ``src/repro/runtime/server.py``, with the same
behaviour: a pool of ``batch_slots`` sequences decodes in lockstep; the
requests of one wave are left-padded with token 0 (no pad mask) to the
wave's longest prompt, so they share one length; the padded vocab tail is
stripped before sampling; sampling is greedy, or at ``temperature > 0``
draws from a numpy ``Generator(seed)``.  It runs eagerly, one
``decode_step`` per token, on the model's device.  It serves any ported
family through ``models.get_family``: the dense and MoE transformers, the
recurrentgemma hybrid and RWKV-6, unsharded or under a sharding policy.

With a sharding policy (the reference's ``policy`` argument) the server
runs the family's partitioned passes: ``mesh`` lays an unsharded model
out for the policy (``models.convert.shard_model``), or may be left out
for a model laid out already.  Prefill splits each wave's prompts over the
policy's batch axes and returns global logits; the KV cache stays sharded
on the mesh between decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import get_family
from repro_torch.models.common import REPLICATED, ModelConfig, ShardingPolicy, resolve_device
from repro_torch.models.convert import shard_model
from repro_torch.models.parallel import is_sharded


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Serves ``model`` (of any ported family) on ``device``: None means CUDA,
    and raises without a card; the model must lie on that device.  Under a
    sharded ``policy`` the model is laid out on ``mesh`` (given here, or
    by ``shard_model`` before)."""

    def __init__(self, model_cfg: ModelConfig, model, max_len: int = 64,
                 temperature: float = 0.0, device=None,
                 policy: ShardingPolicy = REPLICATED, mesh=None):
        self.cfg = model_cfg
        self.family = get_family(model_cfg)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the server on {self.device}")
        if mesh is not None:
            if not is_sharded(policy):
                raise ValueError("a mesh needs a sharded policy")
            if getattr(model, "mesh", None) is None:
                shard_model(model, mesh, policy)
            elif model.mesh is not mesh:
                raise ValueError(f"the model is laid out on {model.mesh!r}, not {mesh!r}")
        self.model = model
        self.policy = policy
        self.max_len = max_len
        self.temperature = temperature

    def _prefill(self, tokens):
        return self.family.prefill(self.model, tokens, self.cfg, self.policy,
                                   max_len=self.max_len)

    def _decode(self, cache, tokens, pos: int):
        return self.family.decode_step(self.model, cache, tokens, pos, self.cfg, self.policy)

    def _sample(self, logits: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        logits = logits[:, : self.cfg.vocab]  # strip padded vocab tail
        if self.temperature <= 0:
            return logits.argmax(-1)
        p = torch.softmax(torch.from_numpy(logits) / self.temperature, dim=-1).numpy()
        return np.array([rng.choice(p.shape[-1], p=row / row.sum()) for row in p])

    @torch.inference_mode()
    def generate(self, prompts: list[list[int]], max_new: int = 16,
                 seed: int = 0) -> list[list[int]]:
        """Generate completions for a batch of same-length prompts."""
        rng = np.random.default_rng(seed)
        B = len(prompts)
        plen = len(prompts[0])
        if any(len(p) != plen for p in prompts):
            raise ValueError("prompts must be same length")
        if plen + max_new > self.max_len:
            raise ValueError(f"{plen} + {max_new} tokens exceed max_len {self.max_len}")
        tokens = torch.tensor(prompts, dtype=torch.int64, device=self.device)
        logits, cache = self._prefill(tokens)
        outs = [[] for _ in range(B)]
        cur = self._sample(logits.cpu().numpy(), rng)
        for b in range(B):
            outs[b].append(int(cur[b]))
        for step in range(1, max_new):
            pos = plen + step - 1
            nxt = torch.as_tensor(cur, dtype=torch.int64).to(self.device)[:, None]
            logits, cache = self._decode(cache, nxt, pos)
            cur = self._sample(logits.cpu().numpy(), rng)
            for b in range(B):
                outs[b].append(int(cur[b]))
        return outs

    def serve(self, requests: list[Request], batch_slots: int = 4) -> list[Request]:
        """Continuous-batching loop over a request queue (greedy decode)."""
        queue = list(requests)
        active: list[Optional[Request]] = [None] * batch_slots
        # Process in waves of equal prompt length for cache compatibility.
        while queue or any(a is not None for a in active):
            free = [i for i, a in enumerate(active) if a is None]
            while free and queue:
                active[free.pop()] = queue.pop(0)
            batch = [a for a in active if a is not None]
            if not batch:
                break
            plen = max(len(r.prompt) for r in batch)
            prompts = [([0] * (plen - len(r.prompt))) + r.prompt for r in batch]
            max_new = max(r.max_new for r in batch)
            outs = self.generate(prompts, max_new=max_new)
            for r, o in zip(batch, outs):
                r.out = o[: r.max_new]
                r.done = True
            active = [None] * batch_slots
        return requests
