"""The readings that each cell's limits are set from, at the cell's own size
on the card, in one process:

    python3 portbench/controls.py --workload NAME --seeds S1 S2 ... \\
        [--control-seeds C1 C2 C3] [--faults KIND ...] [--seconds 1]

For every seed in ``--seeds``, the program's reading: a run of the cell
(a window of ``--seconds``; none for training, whose readings are of its
first steps) and the numbers it compares.  For every seed in
``--control-seeds``, the control's: the reference in the program's place
at the precision below the configuration's (the GEMM cells: TF32; training:
fp8), compared as the program is.  ``--faults`` plants each named fault of
``faults.py`` under a run of each control seed.  One JSON line a reading,
on standard output.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_gemm(cell, seed: int, device: str) -> dict:
    """TF32 products in the program's place, compared as the program's are:
    ``max_rel_err`` over the window's first ``samples`` calls' outputs,
    ``sum_rel_err`` over the column sums of a call on every operand pair."""
    import torch

    from portbench.cell import driver_of
    from portbench.reference import matmul as ref

    drv = driver_of(cell)
    xs, ws, _ = drv.make_inputs(cell, seed, device)
    pairs = math.lcm(len(xs), len(ws))
    worst, sums = 0.0, []
    for i in range(pairs):
        a, l = drv.operands(i, xs, ws)
        out = ref.matmul(xs[a], ws[l], "tf32")
        sums.append(drv.checksum(out))
        if i < cell.traffic["samples"]:
            worst = max(worst, ref.rel_err(out, ref.matmul(xs[a], ws[l])))
    return {"max_rel_err": worst, "sum_rel_err": drv.sum_rel_err(torch.stack(sums), xs, ws)}


def control_train(cell, seed: int, device: str) -> dict:
    """The reference at fp8 against the reference."""
    import torch

    from portbench import inputs
    from portbench.reference import llama

    cfg, tr = cell.config, cell.traffic
    B, S, V = tr["batch"], tr["seq"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["torch_dtype"])
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in inputs.token_batch(seed, s, B, S, V).items()}
               for s in range(tr["checked_steps"])]
    weights = inputs.llama_weights(cfg, seed, device, dtype)
    ref = llama.train_readings(cfg, tr["optimizer"], weights, batches)
    got = llama.train_readings(cfg, tr["optimizer"], weights, batches, precision="fp8")
    return llama.compare(got, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from portbench import faults
    from portbench.cell import driver_of, load_cell

    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    kind = cell.traffic["driver"]

    def emit(row):
        print(json.dumps({"workload": cell.name, **row}), flush=True)

    def program(seed, fault=None):
        seconds = 0.0 if kind == "train" else args.seconds
        t = time.perf_counter()
        if fault is None:
            run = driver_of(cell).run(cell, seed, seconds, False, "cuda", t)
        else:
            with faults.planted(kind, fault):
                run = driver_of(cell).run(cell, seed, seconds, False, "cuda", t)
        torch.cuda.empty_cache()
        return {k: v for k, (v, _) in run.checks.items()}

    for seed in args.seeds:
        emit({"side": "program", "seed": seed, **program(seed)})
    for seed in args.control_seeds:
        if kind == "train":
            emit({"side": "control fp8", "seed": seed, **control_train(cell, seed, "cuda")})
        else:
            emit({"side": "control tf32", "seed": seed, **control_gemm(cell, seed, "cuda")})
        torch.cuda.empty_cache()
        for fault in args.faults:
            emit({"side": f"fault {fault}", "seed": seed, **program(seed, fault)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
