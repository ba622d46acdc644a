"""End-to-end training from the command line.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1_5_0_5b \
      --steps 200 --batch 8 --seq 256 --scale 100m --ckpt-dir ck   # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --scale smoke

The counterpart of ``src/repro/launch/train.py`` with the same flags and
``--device``.  ``--scale`` picks the configuration: ``full`` the assigned
one, ``smoke`` the reduced one of the CPU tests, ``100m`` a same-family
reduction of about 100 M parameters in f32.  Weights are drawn from a
``torch.Generator`` seeded with ``--seed``; the data are the Markov chain
of ``data.SyntheticLMSource`` (or the bytes of ``--data``).  The MoE
archs keep their experts and top-k at every scale.  ``--arch
whisper_base`` stops with an error before any weights are built: the
data sources give tokens only, and whisper's ``loss_fn`` takes audio
frames too (the reference's train CLI fails there as well).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import ByteFileSource, SyntheticLMSource
from repro_torch.models.common import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def scaled_config(arch: str, scale: str):
    if scale == "full":
        return get_config(arch)
    if scale == "smoke":
        return get_smoke_config(arch)
    if scale == "100m":
        cfg = get_smoke_config(arch)
        return dataclasses.replace(
            cfg, n_layers=8, d_model=512, n_heads=8,
            n_kv_heads=min(8, max(1, cfg.n_kv_heads)), head_dim=64,
            d_ff=2048, vocab=32768, loss_chunk=256,
            param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)
    raise ValueError(scale)


def main(argv=None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b", choices=ARCH_IDS)
    ap.add_argument("--scale", default="100m", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default=None, help="path for byte-level data")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = scaled_config(args.arch, args.scale)
    if cfg.family == "whisper":
        ap.error(f"--arch {args.arch}: the data sources give tokens only, and whisper's "
                 "loss_fn takes audio frames too")

    device = resolve_device(args.device)
    if args.data:
        src = ByteFileSource(args.data, seq_len=args.seq, global_batch=args.batch,
                             seed=args.seed)
        cfg = dataclasses.replace(cfg, vocab=256)
    else:
        src = SyntheticLMSource(vocab=cfg.vocab, seq_len=args.seq,
                                global_batch=args.batch, seed=args.seed, branching=4)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the host CPU"
    print(f"arch={cfg.name} family={cfg.family} params~{cfg.n_params/1e6:.1f}M "
          f"device={where}")
    tcfg = TrainerConfig(
        adamw=AdamWConfig(lr=args.lr), warmup=min(50, args.steps // 10 + 1),
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tcfg, device=device)
    trainer.fit(src, steps=args.steps, seed=args.seed)
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    k = max(1, min(10, len(losses) // 5))
    print(f"loss: first{k}={sum(losses[:k])/k:.4f} "
          f"last{k}={sum(losses[-k:])/k:.4f} steps={len(losses)}")
    return trainer


if __name__ == "__main__":
    main()
