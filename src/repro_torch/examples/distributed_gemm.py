"""SUMMA + FusedConcatLinear with every schedule on a stacked mesh,
plus the NoC cost path of the same workload as a collective program.

The port's counterpart of ``examples/distributed_gemm.py``.  The
reference's 8 spoofed XLA host devices become 8 members stacked on one
device (``core.mesh.Mesh``): a (2, 2) ("row", "col") mesh for SUMMA and an
(8,) ("model",) mesh for FCL and the overlapped matmuls, at the
reference's shapes.  Every member's product is the ``gemm`` kernel (its f32
CUDA-core route) and every native reduction the ``reduce_nway`` kernel.
Each input is drawn by numpy from a seed of its own.  Errors are against
``torch.matmul`` in f32 with TF32 off; SUMMA's times are the mean of 10
calls after a warm one, ending in a synchronisation of the card.  The
cost path runs on the host and prints the reference's cycles.

  PYTHONPATH=src python -m repro_torch.examples.distributed_gemm               # the card
  PYTHONPATH=src python -m repro_torch.examples.distributed_gemm --device cpu  # the host
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.fcl import fcl_sharded
from repro_torch.core.mesh import Mesh
from repro_torch.core.overlap import ag_matmul_sharded, matmul_rs_sharded
from repro_torch.core.summa import summa_sharded
from repro_torch.examples import parse_device, where

MEMBERS = 8  # the reference's 8 spoofed host devices
SUMMA_SCHEDULES = ("native", "chain", "pipelined", "tree", "ring")
FCL_SCHEDULES = ("native", "chain", "tree")
TIMED_CALLS = 10


def noc_cost_path() -> dict:
    """The canonical program-API usage: the fabric+compute workload of a
    double-buffered SUMMA run, executed under contention in one pass."""
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.program import run_program
    from repro_torch.core.summa import summa_program
    from repro_torch.core.topology import Mesh2D

    print("NoC cost path: 8x8 SUMMA program with per-tile ComputeOps")
    prog = summa_program(Mesh2D(8, 8), tile_bytes=2048, schedule="native",
                         iters=4, compute_cycles="model")
    overlapped = run_program(prog, PAPER_MICRO, mode="op")
    serialized = run_program(prog, PAPER_MICRO, mode="barrier")
    comm = run_program(prog.comm_only(), PAPER_MICRO, mode="op")
    comp = run_program(prog.compute_only(), PAPER_MICRO, mode="op")
    print(f"  per-op gated (comm/compute overlap): {overlapped.makespan} cycles")
    print(f"  barrier-serialized baseline:         {serialized.makespan:.0f} cycles"
          f"  ({serialized.makespan / overlapped.makespan:.2f}x slower)")
    print(f"  comm-only {comm.makespan} / compute-only {comp.makespan} cycles"
          " (overlap lower bound)")
    return {"overlapped": overlapped.makespan, "serialized": serialized.makespan,
            "comm_only": comm.makespan, "compute_only": comp.makespan}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_demo(device) -> dict:
    """The ``*_sharded`` calls on stacked meshes on ``device``: SUMMA on
    (2, 2) with every schedule, timed; FCL, ``ag_matmul`` and ``matmul_rs``
    over 8 members.  Returns each max_err (and SUMMA's us a call)."""

    def normal(seed, *shape):
        x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(x).to(device)

    def max_err(y, ref):
        return (y - ref).abs().max().item()

    out = {"summa": {}, "fcl": {}}
    print(f"{MEMBERS} mesh members stacked on {where(device)}")
    side = 2
    grid = Mesh((side, side), ("row", "col"), device=device)
    A, B = normal(0, 512, 512), normal(1, 512, 512)
    ref = A @ B
    print("\nSUMMA GEMM (512^3) on a 2x2 grid:")
    for sched in SUMMA_SCHEDULES:
        C = summa_sharded(A, B, grid, "row", "col", schedule=sched)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            C = summa_sharded(A, B, grid, "row", "col", schedule=sched)
        _sync(device)
        dt = (time.perf_counter() - t0) / TIMED_CALLS
        err = max_err(C, ref)
        out["summa"][sched] = {"us": dt * 1e6, "max_err": err}
        print(f"  {sched:>10}: {dt*1e6:8.1f} us  max_err={err:.2e}")

    axis_mesh = Mesh((MEMBERS,), ("model",), device=device)
    attn, wo = normal(2, 64, 16 * MEMBERS), normal(3, 16 * MEMBERS, 32)
    print(f"\nFusedConcatLinear reduction over {MEMBERS} head-shards:")
    for sched in FCL_SCHEDULES:
        y = fcl_sharded(attn, wo, axis_mesh, schedule=sched)
        err = max_err(y, attn @ wo)
        out["fcl"][sched] = err
        print(f"  {sched:>10}: max_err={err:.2e}")

    print("\noverlapped collective matmuls (beyond-paper):")
    x, w = normal(4, 16 * MEMBERS, 32), normal(5, 32, 8 * MEMBERS)
    out["ag_matmul"] = max_err(ag_matmul_sharded(x, w, axis_mesh), x @ w)
    print(f"  ag_matmul   max_err={out['ag_matmul']:.2e}")
    x2, w2 = normal(6, 16 * MEMBERS, 32 * MEMBERS), normal(7, 32 * MEMBERS, 24)
    out["matmul_rs"] = max_err(matmul_rs_sharded(x2, w2, axis_mesh), x2 @ w2)
    print(f"  matmul_rs   max_err={out['matmul_rs']:.2e}")
    return out


def main(argv=None) -> dict:
    device = parse_device(__doc__, argv)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 references
    try:
        out = {"cost_path": noc_cost_path()}
        out.update(mesh_demo(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


if __name__ == "__main__":
    main()
