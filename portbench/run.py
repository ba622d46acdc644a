"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout.  The run makes its inputs and weights on
the card from ``--seed``, warms up the cell's shapes, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference in ``portbench/reference/``, and prints one JSON line last:
the end-to-end metrics with ``--trace 0``, the per-layer metrics (read from
a ``torch.profiler`` window over the whole measurement) with ``--trace 1``.
It exits non-zero and prints no result without the card(s) the cell asks
for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Every cache at a fixed path inside the checkout.
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from portbench import cell as C

    cell = C.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); this host has {have}",
              file=sys.stderr)
        return 2
    run = C.driver_of(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device="cuda", started=STARTED)
    line = C.result_line(cell, run, bool(args.trace))
    found = C.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; the port's benchmark may load neither "
              "JAX nor the JAX package", file=sys.stderr)
        return 3
    print("\n".join(C.check_lines(run)), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
