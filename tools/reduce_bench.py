"""``reduce_nway`` on the card, for one source tree: times, bits and SASS.

Builds the tree's kernel library (``_build.build``) and runs
``chip_smoke.py``'s phase-2 ``reduce_nway`` cases (``reduce_shapes``)
through the tree's wrapper, and prints one JSON line with, for each case:

  * ``ms``: device time a call (``chip_smoke.time_ms``: the timed calls
    queue behind a spin kernel, so that the host's pace does not show; the
    median of ``--repeats`` such loops), and ``library_ms`` the same for
    ``torch.sum`` / ``torch.amax`` over the same input; an input the tree's
    kernel cannot read in place is copied first, inside the timed call, as
    the tree's mesh does;
  * ``sha``: a hash of the output's bytes, so that two trees (or two
    builds) can be held bit-equal;
  * ``bound_ms``: the bytes the call must move over 3.35 TB/s.

It also prints the registers of each ``reduce_kernel`` instantiation
(``ptxas -v``) and, for the SASS, the global loads a thread issues before
its first combine (``chip_smoke.reduce_sass``).  Usage, on a machine with
the card, one process per tree, in turns (A, B, B, A):

  python tools/reduce_bench.py --src path/to/tree/src --tag NAME \\
      [--cases WORDS] [--repeats N] [--out DIR]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", required=True)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cases", help="run only the cases whose name holds one of these "
                    "comma-separated words")
    ap.add_argument("--out", default="build/reduce_bench")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke  # puts this tree's src on the path: the tree under test goes first

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("reduce_bench: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import reduce_nway as mod

    path, secs, report = _build.build()
    _build.library()
    regs = [line.strip() for line in report.split("== reduce_nway.cu", 1)[-1].split("==")[0]
            .splitlines() if "registers" in line or "spill" in line]
    in_place = getattr(mod, "reads_in_place", lambda x, dim: x.is_contiguous())
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cs in smoke.reduce_shapes(gen):
        if args.cases and not any(w in cs["name"] for w in args.cases.split(",")):
            continue
        x, op, dim, lib = cs["x"], cs["op"], cs["dim"], cs["library"]

        def call(x=x, op=op, dim=dim):
            return mod.reduce_nway(x if in_place(x, dim) else x.contiguous(), op=op, dim=dim)

        out = call()
        torch.cuda.synchronize()
        plan = mod._plan(x, dim)._asdict() if hasattr(mod, "_plan") else None

        def median_ms(fn):
            return statistics.median(smoke.time_ms(fn, cs["iters"]) for _ in range(args.repeats))

        rows.append({
            "case": cs["name"], "ms": median_ms(call),
            "library_ms": median_ms(lib) if lib else None,
            "bound_ms": cs["nbytes"] / smoke.PEAK_BYTES * 1e3, "read_in_place": in_place(x, dim),
            "sha": hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16],
            "plan": plan})
        del out
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    doc = {"tag": args.tag, "src": args.src, "card": smi, "build_s": secs, "ptxas": regs,
           "loads_before_first_combine": smoke.reduce_sass(path), "cases": rows}
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.tag}.json").write_text(json.dumps(doc, indent=1))
    for r in rows:
        print(f"  {args.tag}: {r['case']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, library "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}) "
              f"sha {r['sha']}", flush=True)
    print(json.dumps(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
