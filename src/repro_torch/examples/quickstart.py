"""Quickstart: train a tiny LM on synthetic Markov data, then sample from it.

The port's counterpart of ``examples/quickstart.py``: the same config,
data, optimizer and schedule through the port's ``Trainer`` and
``Server``.  Its f32 attention is the ``flash_attention`` kernel on the
card (the ``mma_sync`` route at head_dim 16).  Weights are drawn from a
generator seeded with 0; the reference draws its own, so the losses are
not the reference's.

  PYTHONPATH=src python -m repro_torch.examples.quickstart               # the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu  # the host
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMSource
from repro_torch.examples import parse_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.server import Server
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    device = parse_device(__doc__, argv)
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"),
                              n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                              head_dim=16, d_ff=128, vocab=128)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=32, global_batch=8,
                            seed=0, branching=2)
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=3e-3),
                                         warmup=10, total_steps=80), device=device)
    model, _ = trainer.fit(src, steps=80, resume=False)
    # a straggler flag is an entry without a loss
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(uniform entropy would be {math.log(cfg.vocab):.3f})")

    server = Server(cfg, model, max_len=48, device=device)
    out = server.generate([[5, 9, 2, 7]], max_new=12)[0]
    print("generated continuation:", out)
    return {"losses": losses, "tokens": out, "vocab": cfg.vocab}


if __name__ == "__main__":
    main()
