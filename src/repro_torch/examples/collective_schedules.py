"""Explore the paper's collective schedules: models, simulator, and the
collective program IR (the canonical workload API).

The port's counterpart of ``examples/collective_schedules.py``, on the
port's copies of ``core/noc``, ``core/topology.py`` and the emitters of
``core/schedules.py``; it prints the same lines.  It runs on the host.

  PYTHONPATH=src python -m repro_torch.examples.collective_schedules
"""

from repro_torch.core import schedules as sched
from repro_torch.core.collectives import choose_schedule
from repro_torch.core.noc import model as m
from repro_torch.core.noc.netsim import NoCSim
from repro_torch.core.noc.params import PAPER_MICRO
from repro_torch.core.noc.program import ProgramBuilder, run_program
from repro_torch.core.topology import Coord, Mesh2D, Submesh


def main():
    p = PAPER_MICRO
    print("1-D multicast to 4 clusters (cycles):")
    print(f"{'size':>8} {'naive':>8} {'seq':>8} {'tree':>8} {'hw':>8} {'speedup':>8} {'chosen':>10}")
    for kib in (1, 2, 4, 8, 16, 32):
        n = p.beats(kib * 1024)
        naive = m.multicast_naive(p, n, 4)
        seq = m.multicast_seq(p, n, 4)
        tree = m.multicast_tree(p, n, 4)
        hw = m.multicast_hw(p, n, 4)
        print(f"{kib:>6}Ki {naive:8.0f} {seq:8.0f} {tree:8.0f} {hw:8.0f} "
              f"{min(seq, tree)/hw:8.2f} {choose_schedule(kib*1024, 4):>10}")

    print("\nflit-level simulation, 4x4 mesh, 32 KiB multicast to the full mesh:")
    sim = NoCSim(Mesh2D(4, 4), p)
    sim.add_multicast(Coord(0, 0), Submesh(0, 0, 4, 4).multi_address(), 32 * 1024)
    t = sim.run()
    print(f"  simulator: {t} cycles; model: "
          f"{m.multicast_hw(p, p.beats(32*1024), 4, 4):.0f} cycles")

    print("\n2-D reduction join fan-in (the paper's 1.9x observation):")
    for r in (1, 2, 4):
        hw = m.reduction_hw(p, p.beats(32 * 1024), 4, r)
        print(f"  rows={r}: {hw:.0f} cycles")

    # ----------------------------------------------------------------------
    # The program IR: declare a whole workload — collectives, compute, and
    # their dependencies — and run it under contention in one pass.  Here:
    # an all-reduce along row 0 feeds a per-tile compute, which gates a
    # broadcast of the result down each column (per-op gating, no barriers).
    # ----------------------------------------------------------------------
    print("\ncollective program: all-reduce -> compute -> column broadcasts")
    mesh = Mesh2D(4, 4)
    b = ProgramBuilder(mesh)
    row = [Coord(x, 0) for x in range(4)]
    ar = sched.all_reduce_ops(b, row, nbytes=8192, schedule="native", params=p)
    comp = [b.compute((x, 0), cycles=256.0, deps=ar) for x in range(4)]
    for x in range(4):
        col = [Coord(x, y) for y in range(4)]
        sched.broadcast_ops(b, col, root=0, nbytes=8192, schedule="native",
                            deps=comp[x], params=p)
    prog = b.build()
    res = run_program(prog, p, mode="op")
    stats = res.stats()
    print(f"  {len(prog.ops)} ops, makespan {res.makespan} cycles; per-op "
          f"latency mean {stats.mean:.0f} / p50 {stats.p50:.0f} / "
          f"p95 {stats.p95:.0f} / max {stats.max:.0f}")
    for r in res.runs[:4]:
        print(f"    op#{r.op.id:<2} {r.op.kind:<10} inject {r.inject_cycle:8.1f}"
              f"  done {r.done_cycle:8.1f}  latency {r.latency:7.1f}")
    print("  (trace schema v3 round trip: "
          f"{len(prog.to_json())} bytes of JSON)")


if __name__ == "__main__":
    main()
