"""End-to-end serving from the command line: batched generation over a request queue.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_0_5b \
      --requests 8 --max-new 16                  # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch rwkv6_3b
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch moonshot_v1_16b

The counterpart of ``src/repro/launch/serve.py`` with the same flags and
``--device``.  Weights are random, drawn from a ``torch.Generator`` seeded
with 0, or restored from the latest valid trainer checkpoint in
``--ckpt-dir`` (``launch/train.py --scale smoke --ckpt-dir ...``); the
prompts come from a numpy ``Generator`` seeded with 1.  ``--arch
whisper_base`` stops with an error before any weights are built: the
``Server`` passes token arrays to ``prefill``, and whisper's takes audio
frames too (the reference's serve CLI fails there as well).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import get_family
from repro_torch.models.common import resolve_device
from repro_torch.runtime.server import Request, Server
from repro_torch.runtime.trainer import restore_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1_5_0_5b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a trainer checkpoint")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch)
    if cfg.family == "whisper":
        ap.error(f"--arch {args.arch}: the server serves token prompts, and whisper's "
                 "prefill takes audio frames too; drive models.whisper's prefill and "
                 "decode_step directly")

    device = resolve_device(args.device)
    fam = get_family(cfg)
    model = fam.init(torch.Generator(device=device).manual_seed(0), cfg, device)
    if args.ckpt_dir:
        step = restore_params(model, args.ckpt_dir) if Path(args.ckpt_dir).is_dir() else None
        if step is None:
            ap.error(f"--ckpt-dir {args.ckpt_dir}: no valid checkpoint")
        print(f"restored params from checkpoint @ step {step}")
    server = Server(cfg, model, max_len=args.prompt_len + args.max_new + 1,
                    temperature=args.temperature, device=device)
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len)],
                    max_new=args.max_new) for _ in range(args.requests)]
    t0 = time.perf_counter()
    done = server.serve(reqs, batch_slots=args.batch_slots)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "the host CPU"
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s on {where})")
    for r in done[:3]:
        print(f"  prompt={r.prompt[:4]}... -> {r.out}")
    return done


if __name__ == "__main__":
    main()
