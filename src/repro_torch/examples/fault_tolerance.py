"""Fault-tolerance walkthrough: fabric faults, then crash/corrupt/resume.

The port's counterpart of ``examples/fault_tolerance.py``.

Fabric level (host only): a router dies on the NoC, the collective storm
re-grafts its trees around the fault and completes with a measurable
makespan delta, and the collective layer re-targets the largest
surviving submesh — the fabric-level decision that hands off to the
elastic re-mesh of the runtime.

Simulator level (also host only): the resilient execution layer — pause
a run at an exact cycle, checkpoint it to a fingerprinted snapshot,
restore bit-identically; let a link die *mid-run* via a FaultTimeline
and watch the surviving traffic re-lower around it; SIGKILL a shard
fork worker and get the identical answer anyway.  Both print the
reference's lines.

Runtime level (the card, or the host under ``--device cpu``): crash
mid-run, corrupt a checkpoint, resume, through the port's ``Trainer``
and checkpoint manager; the model's attention is the ``flash_attention``
kernel on the card.

  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance               # the card
  PYTHONPATH=src python -m repro_torch.examples.fault_tolerance --device cpu  # the host
"""

from __future__ import annotations

import dataclasses
import pathlib
import shutil
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.data import SyntheticLMSource
from repro_torch.examples import parse_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def fabric_demo():
    """Dead fabric router -> re-grafted collectives -> surviving submesh."""
    from repro_torch.core.noc.faults import FaultSet, surviving_submesh
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.traffic import collective_storm, replay
    from repro_torch.core.topology import Coord, Mesh2D

    mesh = Mesh2D(8, 8)
    print("fabric phase: router (5,5) dies on the 8x8 mesh")
    trace = collective_storm(mesh, tile_bytes=2048, phases=1)
    healthy = replay(trace, params=PAPER_MICRO).makespan

    faults = FaultSet(dead_routers=(Coord(5, 5),))
    # Drop the dead tile's own traffic, keep everything else: the
    # multicast/reduction trees re-graft around the fault in-fabric.
    from repro_torch.core.noc.faults import degrade_trace

    degraded_trace = degrade_trace(trace, faults)
    degraded = replay(degraded_trace,
                      params=dataclasses.replace(PAPER_MICRO,
                                                 faults=faults)).makespan
    print(f"  storm completes degraded: makespan {healthy} -> {degraded} "
          f"({degraded / healthy:.2f}x)")

    sub = surviving_submesh(mesh, faults)
    print(f"  collective layer re-targets the surviving "
          f"{sub.w}x{sub.h} submesh at ({sub.x},{sub.y}) — the fabric "
          "analogue of the elastic re-mesh below")


def resilience_demo():
    """Checkpoint/restart, a mid-run link death, and a killed worker."""
    import random

    from repro_torch.core.noc import shard
    from repro_torch.core.noc.faults import FaultSet
    from repro_torch.core.noc.netsim import NoCSim
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.resilience import (
        FaultEvent, FaultTimeline, Snapshot, checkpoint, restore,
        run_with_timeline,
    )
    from repro_torch.core.topology import Coord, Mesh2D

    def build():
        sim = NoCSim(Mesh2D(8, 8), PAPER_MICRO)
        rng = random.Random(0)
        tiles = [Coord(x, y) for x in range(8) for y in range(8)]
        for _ in range(24):
            a, b = rng.sample(tiles, 2)
            sim.add_unicast(a, b, 4096)
        return sim

    makespan = build().run()
    print(f"simulator phase: 24-unicast workload, makespan {makespan}")

    cut = makespan // 2
    sim = build()
    sim.run(stop_at=cut)
    snap = Snapshot.from_json(checkpoint(sim, cut).to_json())
    resumed = restore(snap)
    print(f"  checkpoint at cycle {cut} "
          f"({len(snap.to_json())} bytes, sha256 {snap.fingerprint[:12]}…), "
          f"restored run finishes at {resumed.run(start_cycle=cut)} — "
          "bit-identical")

    sim = build()
    ev = FaultEvent(cut, FaultSet(
        dead_links=frozenset({(Coord(3, 4), Coord(4, 4))})))
    prof = run_with_timeline(sim, FaultTimeline([ev]), profile=True)
    print(f"  link (3,4)-(4,4) dies mid-run at cycle {cut}: "
          f"{prof.relowered_streams} stream(s) re-lowered around it, "
          f"makespan {makespan} -> {prof.makespan}")

    sim = build()
    shard.set_chaos("kill", worker=1, at_op=3)
    try:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            prof = sim.run(engine="shard:2x2:2", profile=True)
    finally:
        shard.set_chaos(None)
    print(f"  SIGKILLed fork worker 1 mid-run: respawned "
          f"{prof.worker_respawns}x, replayed its epoch log, makespan "
          f"{prof.makespan} — same as undisturbed")


def runtime_demo(device) -> dict:
    """Train with checkpoints, resume in a new trainer, then recover past a
    corrupt checkpoint; returns the steps that it prints."""
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="repro_ft_"))
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_0_5b"),
                              n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                              head_dim=16, d_ff=64, vocab=64)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=1e-3), ckpt_dir=str(workdir),
                         ckpt_every=5, total_steps=100)
    try:
        print("phase 1: train 12 steps, checkpointing every 5 (async, atomic)")
        t1 = Trainer(cfg, tcfg, device=device)
        t1.fit(src, steps=12, resume=False)
        on_disk = t1.ckpt.steps()
        print("  checkpoints on disk:", on_disk)

        print("phase 2: 'node failure' — new process resumes from latest")
        t2 = Trainer(cfg, tcfg, device=device)
        t2.fit(src, steps=20, resume=True)
        steps = [m["step"] for m in t2.metrics_log if "loss" in m]  # not a straggler flag
        print(f"  resumed at step {steps[0]}, ran to {steps[-1]}")

        print("phase 3: corrupt the newest checkpoint — CRC check falls back")
        newest = sorted(workdir.glob("ckpt_*"))[-1]
        (newest / "arrays.npz").write_bytes(b"bitrot")
        t3 = Trainer(cfg, tcfg, device=device)
        state = t3.init_state(seed=0)
        _, step, _ = t3.recover(state)
        print(f"  recovered from step {step} (newest was corrupt)")
    finally:
        shutil.rmtree(workdir)
    return {"checkpoints": on_disk, "resumed_at": steps[0], "ran_to": steps[-1],
            "recovered_from": step}


def main(argv=None) -> dict:
    device = parse_device(__doc__, argv)
    fabric_demo()
    resilience_demo()
    out = runtime_demo(device)
    print("done")
    return out


if __name__ == "__main__":
    main()
