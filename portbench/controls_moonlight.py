"""The readings that the Moonlight cell's limits are set from, at the cell's
own size on the card, in one process, as ``controls.py`` reads the other
cells':

    python3 portbench/controls_moonlight.py --workload NAME --seeds S1 S2 ... \\
        [--margin-factor F] [--control-seeds C1 C2] [--faults KIND ...]

For every seed in ``--seeds``, the program's reading: a run of the cell
without a window (its readings are of its first steps), the numbers it
compares and the reference's routing tally (``reference/moonlight.py:pin``).
With ``--margin-factor``, the reference's ``PIN_MARGIN`` is then set to F
times the largest distance of a differing choice over those runs (bf16's
score error, as the runs measure it), rounded up to two digits, for the
rest of the process: the sound runs read the same under it, since every
choice they differ in lies within it.  For every seed in
``--control-seeds``, the control's: the reference at fp8 in the program's
place, compared with the reference as the program is (the f32 run taking
the fp8 run's choices at near-ties, as it takes the program's).
``--faults`` plants each named fault, of ``faults.py``'s training faults
or ``BIAS_FAULTS`` here, under a run of each control seed.  One JSON line
a reading, on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
# Faults of the selection bias (DeepSeek-V3's auxiliary-loss-free
# balancing), each planted in the program while open: ``bias_ignored`` (the
# router chooses by score alone), ``bias_sign`` (the update moves each bias
# the wrong way), ``bias_one_member`` (the update reads the first member's
# loads, not their sum over the members).
BIAS_FAULTS = ("bias_ignored", "bias_sign", "bias_one_member")


@contextlib.contextmanager
def bias_fault(kind: str):
    from repro_torch.models import mlp
    from repro_torch.runtime import trainer

    update = trainer.update_router_biases
    if kind == "bias_ignored":
        route = mlp._route_biased
        patch = mock.patch.object(mlp, "_route_biased",
                                  lambda params, xf, cfg, bias: route(params, xf, cfg, None))
    elif kind == "bias_sign":
        patch = mock.patch.object(trainer, "update_router_biases",
                                  lambda tally, rate, mesh=None: update(tally, -rate, mesh))
    elif kind == "bias_one_member":
        def first_member(tally, rate, mesh=None):
            lead = (0,) * (mesh.stacked if mesh is not None else 0)
            update({k: (b, load[lead]) for k, (b, load) in tally.items()}, rate, None)
        patch = mock.patch.object(trainer, "update_router_biases", first_member)
    else:
        raise ValueError(f"no bias fault {kind!r}: {BIAS_FAULTS}")
    with patch:
        yield


def planted(kind: str):
    """A fault of ``BIAS_FAULTS`` or of ``faults.py``'s training faults."""
    from portbench import faults

    return bias_fault(kind) if kind in BIAS_FAULTS else faults.planted("train", kind)


def round_up(x: float) -> float:
    """``x`` rounded up to two significant digits."""
    unit = 10.0 ** (math.floor(math.log10(x)) - 1)
    return float(f"{math.ceil(x / unit - 1e-9) * unit:.2g}")


def control(cell, seed: int, device: str) -> dict:
    """The reference at fp8 against the reference."""
    import torch

    from portbench import inputs
    from portbench.cell import driver_of
    from portbench.reference import moonlight

    cfg, tr = cell.config, cell.traffic
    B, S, V = tr["batch"], tr["seq"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["torch_dtype"])
    members = cfg["mesh"][cfg["mesh_axes"].index("model")]
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in inputs.token_batch(seed, s, B, S, V).items()}
               for s in range(tr["checked_steps"])]
    weights = driver_of(cell).moonlight_weights(cfg, seed, device, dtype)

    def readings(precision, pinned=None):
        out = moonlight.train_readings(cfg, tr["optimizer"], weights, batches, members,
                                       precision=precision, moments_device="cpu", pinned=pinned)
        out.pop("params")
        return out

    low = readings("fp8")
    torch.cuda.empty_cache()
    ref = readings("f32", low["choices"])
    return moonlight.compare(low, ref) | {"routing": ref["routing"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--margin-factor", type=float, default=None)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    from portbench.cell import driver_of, load_cell
    from portbench.reference import moonlight

    if not torch.cuda.is_available():
        print("controls_moonlight: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)

    def emit(row):
        print(json.dumps({"workload": cell.name, **row}), flush=True)

    def program(seed, fault=None):
        t = time.perf_counter()
        with planted(fault) if fault else contextlib.nullcontext():
            run = driver_of(cell).run(cell, seed, 0.0, False, "cuda", t)
        torch.cuda.empty_cache()
        return {k: v for k, (v, _) in run.checks.items()} | {
            "routing": run.routing, "peak_gib": run.memory_peak_bytes / 2 ** 30,
            "s": time.perf_counter() - t}

    farthest = 0.0
    for seed in args.seeds:
        row = program(seed)
        farthest = max([farthest] + [r["farthest"] for r in row["routing"]])
        emit({"side": "program", "seed": seed, "margin": moonlight.PIN_MARGIN, **row})
    if args.margin_factor is not None and farthest > 0:
        moonlight.PIN_MARGIN = round_up(args.margin_factor * farthest)
        emit({"side": "margin", "farthest": farthest, "factor": args.margin_factor,
              "margin": moonlight.PIN_MARGIN})
    for seed in args.control_seeds:
        emit({"side": "control fp8", "seed": seed, "margin": moonlight.PIN_MARGIN,
              **control(cell, seed, "cuda")})
        torch.cuda.empty_cache()
        for fault in args.faults:
            emit({"side": f"fault {fault}", "seed": seed, "margin": moonlight.PIN_MARGIN,
                  **program(seed, fault)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
