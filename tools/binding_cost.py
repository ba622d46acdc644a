"""Host cost of the kernels' binding, on the card, for one source tree.

Runs the parts of ``chip_smoke.py``'s main path that launch ``reduce_nway``
most often, at its sizes, through the tree's public entry points, and
prints one JSON line:

  * ``reduce_nway`` host microseconds a call (and device microseconds, by
    CUDA events over the same loop) at a decode psum's shape and at phase
    11a's backward sum, through the wrapper as the tree runs it and,
    where the tree binds the kernel as a ``torch.library`` op, through
    ``torch.ops.repro_torch.reduce_nway`` and its ``.default`` overload;
  * phase 11a's step: qwen1.5-0.5b, full depth, bf16, sequence-parallel on
    a stacked (2, 4) mesh, 4 x 2048, through ``Trainer(policy=, mesh=)``:
    step ms (median of steps 3-6) and ``reduce_nway`` launches a step;
  * decode ms a step (median of 32, each ended by a synchronisation) and
    launches a step of phase 10a's yi-6b on (2, 4) and phase 12a's
    rwkv6-3b on (1, 4), bf16, full depth, after a 4 x 2048 prefill.

Usage (on a machine with the card), one process per tree, trees in turn:

  python tools/binding_cost.py --src path/to/tree/src --tag NAME [--out DIR]

To compare two trees, run them alternately in one session (A, B, B, A):
host times on a shared host drift between calls.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

LOOP = 2000
WAVE, SLOTS, DECODE_STEPS = 2048, 4, 32
TRAIN_BATCH, TRAIN_STEPS = 4, 6
SHAPES = {"decode psum (2, 4, 2, 1, 4096) bf16": ((2, 4, 2, 1, 4096), 1),
          "11a backward sum (2, 4, 2, 2048, 1024) bf16": ((2, 4, 2, 2048, 1024), 1)}


def per_call(torch, fn, x, dim) -> dict:
    """Host and device microseconds a call over LOOP calls, after a warm-up."""
    for _ in range(50):
        fn(x, dim)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(LOOP):
        fn(x, dim)
    host = (time.perf_counter() - t0) / LOOP * 1e6
    end.record()
    torch.cuda.synchronize()
    return {"host_us": host, "device_us": start.elapsed_time(end) / LOOP * 1e3}


def micro(torch) -> dict:
    from repro_torch.kernels import reduce_nway as rn

    ways = {"wrapper": lambda x, d: rn.reduce_nway(x, dim=d)}
    if hasattr(torch.ops.repro_torch, "reduce_nway"):
        packet = torch.ops.repro_torch.reduce_nway
        ways["op"] = lambda x, d: packet(x, "add", d)
        ways["op.default"] = lambda x, d, f=packet.default: f(x, "add", d)
    out = {}
    for name, (shape, dim) in SHAPES.items():
        x = torch.randn(shape, device="cuda").to(torch.bfloat16)
        out[name] = {way: per_call(torch, fn, x, dim) for way, fn in ways.items()}
    return out


def train_step(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    class Repeat:
        def __init__(self, source):
            self.source = source

        def batch_at(self, step):
            return self.source.batch_at(0)

    cfg = get_config("qwen1_5_0_5b")
    mesh = Mesh((2, 4), ("data", "model"), device="cuda")
    policy = make_policy(cfg, mesh, seq_parallel=True)
    src = Repeat(SyntheticLMSource(vocab=cfg.vocab, seq_len=WAVE, global_batch=TRAIN_BATCH,
                                   seed=1, branching=4))
    model = tt.init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=2,
                                         total_steps=TRAIN_STEPS),
                      model=model, mesh=mesh, policy=policy)
    del model
    before = reduce_nway.launches
    trainer.fit(src, steps=TRAIN_STEPS, seed=0)
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    out = {"step_ms": dts, "median_ms": statistics.median(dts[2:]),
           "reduce_nway_per_step": (reduce_nway.launches - before) / TRAIN_STEPS}
    del trainer
    return out


def decode(torch, arch: str, mesh_shape: tuple) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model

    cfg = get_config(arch)
    fam = get_family(cfg)
    mesh = Mesh(mesh_shape, ("data", "model"), device="cuda")
    policy = make_policy(cfg, mesh)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = shard_model(fam.init(gen, cfg, "cuda"), mesh, policy)
    x = torch.randint(0, cfg.vocab, (SLOTS, WAVE + DECODE_STEPS + 8), generator=gen,
                      device="cuda")
    times, launches = [], []
    with torch.inference_mode():
        _, cache = fam.prefill(model, x[:, :WAVE], cfg, policy,
                               max_len=WAVE + DECODE_STEPS + 8)
        for i in range(DECODE_STEPS + 4):
            pos = WAVE + i
            torch.cuda.synchronize()
            before, t0 = reduce_nway.launches, time.perf_counter()
            _, cache = fam.decode_step(model, cache, x[:, pos:pos + 1], pos, cfg, policy)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            launches.append(reduce_nway.launches - before)
    del model, cache
    times = times[4:]
    return {"step_ms": times, "median_ms": statistics.median(times),
            "reduce_nway_per_step": launches[-1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default=None, help="also write the record here, as TAG.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("binding_cost: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"tag": args.tag, "src": str(Path(repro_torch.__file__).parent),
           "device": torch.cuda.get_device_name(0), "torch": torch.__version__}
    t0 = time.perf_counter()
    rec["reduce_nway_call"] = micro(torch)
    rec["train_11a"] = train_step(torch)
    for key, arch, mesh in (("decode_10a yi_6b (2,4)", "yi_6b", (2, 4)),
                            ("decode_12a rwkv6_3b (1,4)", "rwkv6_3b", (1, 4))):
        gc.collect()
        torch.cuda.empty_cache()
        rec[key] = decode(torch, arch, mesh)
    rec["seconds"] = time.perf_counter() - t0
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.tag}.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
