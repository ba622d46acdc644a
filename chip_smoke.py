#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Phases, each of which raises on failure:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the main path, with times, a library call as yardstick,
   and the card's least time for the same work (``bound_ms``);
3. drive the main path at the widths of yi-6b (d_model 4096, 32 heads x
   128, d_ff 11008) with T = 4096 tokens: SUMMA on a 4x4 mesh (all five
   schedules), FCL over 8 members (four schedules plus ``scatter``),
   ``ag_matmul`` and ``matmul_rs`` over 8, and the barrier over 16; each
   output is held against ``torch.matmul`` in f32, and both kernels must
   have been launched;
4. print the ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
   line.

It exits non-zero, printing no result, when no CUDA card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12    # HBM bytes/s

# yi-6b widths (src/repro/configs/yi_6b.py) and the token count.
D_MODEL, N_HEADS, HEAD_DIM, D_FF, TOKENS = 4096, 32, 128, 11008, 4096

# Main-path tolerance, relative to max|ref|: every product is an f32 sum
# over K = 4096 (11008 for matmul_rs) taken in another order than cuBLAS's;
# a random-walk rounding error is ~sqrt(K) * 2^-24 of a typical term, three
# orders below 1e-4, while one wrong block would give an error of order 1.
MAIN_RTOL = 1e-4
DEVICE = "cuda"


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / rate * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rel_err(out, ref) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    return err, err / scale


def gemm_cases(gen):
    from repro_torch.kernels.ref import gemm_ref

    def case(name, batch, M, K, N, dtype, accumulate, rtol, iters):
        shape = (batch,) if batch else ()
        a = torch.randn(*shape, M, K, generator=gen, device=DEVICE).to(dtype)
        b = torch.randn(*shape, K, N, generator=gen, device=DEVICE).to(dtype)
        c = torch.randn(*shape, M, N, generator=gen, device=DEVICE).to(dtype) if accumulate else None
        nb = batch or 1
        ops = 2.0 * nb * M * N * K
        nbytes = a.element_size() * nb * (M * K + K * N + M * N * (2 if accumulate else 1))
        if accumulate:
            lib = (lambda: torch.baddbmm(c, a, b)) if batch else (lambda: torch.addmm(c, a, b))
        else:
            lib = (lambda: torch.bmm(a, b)) if batch else (lambda: torch.matmul(a, b))
        return dict(name=name, kernel=lambda: gemm(a, b, c, accumulate=accumulate),
                    plain=lambda: gemm_ref(a, b, c, accumulate=accumulate), library=lib,
                    rtol=rtol, iters=iters,
                    bound=bound(ops, PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32, nbytes))

    from repro_torch.kernels.ops import gemm
    f32, bf16 = torch.float32, torch.bfloat16
    # f32: sums over K <= 1024 in another order than the plain version's;
    # bf16: outputs round to 8 bits, so one ulp (2^-8 relative) may differ.
    summa = (16, TOKENS // 4, D_MODEL // 4, D_FF // 4)       # one step on the 4x4 mesh
    fcl = (8, TOKENS, N_HEADS * HEAD_DIM // 8, D_MODEL)      # partials over 8 members
    return [
        case("summa_step {}x({}x{} @ {}x{}) +C f32".format(*summa[:3], *summa[2:]),
             *summa, f32, True, 1e-4, 5),
        case("fcl_partials {}x({}x{} @ {}x{}) f32".format(*fcl[:3], *fcl[2:]),
             *fcl, f32, False, 1e-4, 5),
        case(f"square {D_MODEL}^3 bf16", 0, D_MODEL, D_MODEL, D_MODEL, bf16, False, 2e-2, 5),
        case("ragged 1000x333 @ 333x777 +C f32", 0, 1000, 333, 777, f32, True, 1e-4, 20),
    ]


def reduce_cases(gen):
    from repro_torch.kernels.ops import reduce_nway
    from repro_torch.kernels.ref import reduce_nway_ref

    def case(name, x, op, rtol, library):
        n, m = x.shape
        nbytes = (n + 1) * m * x.element_size()
        return dict(name=name, kernel=lambda: reduce_nway(x, op=op),
                    plain=lambda: reduce_nway_ref(x, op), library=library,
                    rtol=rtol, iters=20, bound=bound((n - 1) * m, PEAK_F32, nbytes))

    m = D_MODEL * TOKENS
    xf = torch.randn(8, m, generator=gen, device=DEVICE)
    xb = torch.randn(8, m, generator=gen, device=DEVICE).to(torch.bfloat16)
    bits = (torch.rand(16, 1 << 20, generator=gen, device=DEVICE) < 0.95).to(torch.int32)
    # f32 add: 8 terms, rounding ~8 * 2^-24; bf16 add: the f32 sum rounds to
    # 8 bits, so one ulp (2^-8 relative) may differ; max and and are exact.
    return [
        case(f"add (8, {D_MODEL}*{TOKENS}) f32", xf, "add", 1e-5, lambda: torch.sum(xf, 0)),
        case(f"add (8, {D_MODEL}*{TOKENS}) bf16", xb, "add", 2e-2, lambda: torch.sum(xb, 0)),
        case(f"max (8, {D_MODEL}*{TOKENS}) f32", xf, "max", 0.0, lambda: torch.amax(xf, 0)),
        case("and (16, 2^20) int32", bits, "and", 0.0, None),
    ]


def run_case(cs) -> dict:
    out, ref = cs["kernel"](), cs["plain"]()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype or out.device.type != DEVICE:
        fail(f"{cs['name']}: kernel gave {out.shape} {out.dtype} {out.device}, "
             f"plain {ref.shape} {ref.dtype}")
    err, rel = rel_err(out, ref)
    if not rel <= cs["rtol"]:
        fail(f"{cs['name']}: max_abs_err {err:.3e} (relative {rel:.3e}) above {cs['rtol']}")
    bound_ms, bound_by = cs["bound"]
    row = dict(case=cs["name"], max_abs_err=err, rel_err=rel, tol=cs["rtol"],
               ms=time_ms(cs["kernel"], cs["iters"]),
               plain_ms=time_ms(cs["plain"], cs["iters"]),
               library_ms=time_ms(cs["library"], cs["iters"]) if cs["library"] else None,
               bound_ms=bound_ms, bound_by=bound_by)
    print(f"  {row['case']}: max_abs_err {err:.3e} (rel {rel:.3e} <= {cs['rtol']}) "
          f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} library "
          f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} "
          f"bound {bound_ms:.4f} ({bound_by})", flush=True)
    return row


def lsb_and_barrier():
    """LsbAnd: the AND is 1 iff every member's bit is set."""
    from repro_torch.kernels.ops import reduce_nway

    arrived = torch.ones(16, 1 << 20, dtype=torch.int32, device=DEVICE)
    missing = arrived.clone()
    missing[3, 12345] = 0
    full, part = reduce_nway(arrived, op="and"), reduce_nway(missing, op="and")
    torch.cuda.synchronize()
    if not (bool((full == 1).all()) and int(part[12345]) == 0 and int(part.sum()) == (1 << 20) - 1):
        fail("LsbAnd barrier semantics violated")
    print("  LsbAnd: all arrived -> 1 everywhere; one bit missing -> 0 at that bit only")


def _kernel_name(key: str) -> str:
    """A kernel's symbol without its signature and the common namespaces."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]
    return key.replace("at::native::", "").replace("std::", "")[:64]


def device_breakdown(prof) -> dict:
    """Device time by kernel from a profiler window (CUPTI)."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    short = [(_kernel_name(k), ms, n) for k, ms, n in rows]
    return {"device_ms": busy, "top": short[:6]}


def main_path(gen) -> dict:
    """The yi-6b-width collective GEMM path; returns wall and device times per run."""
    from repro_torch.core.fcl import fcl_sharded
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.overlap import ag_matmul_sharded, matmul_rs_sharded
    from repro_torch.core.schedules import barrier
    from repro_torch.core.summa import summa_sharded
    from torch.profiler import ProfilerActivity, profile

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    walls = {}

    def check(name, fn, ref):
        """A cold run, a timed warm run and a profiled run, each held to ``ref``."""
        for run in ("cold", "warm", "profiled"):
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                if run == "profiled" else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                y = fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            if y.device.type != DEVICE:
                fail(f"{name}: output on {y.device}, not {DEVICE}")
            if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
                fail(f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)}, or not finite")
            err, rel = rel_err(y, ref)
            if not rel <= MAIN_RTOL:
                fail(f"{name} ({run}): relative error {rel:.3e} above {MAIN_RTOL}")
            del y
            if run == "cold":
                walls[name] = {"cold_ms": wall}
            elif run == "warm":
                walls[name]["ms"] = wall
            else:
                walls[name].update(device_breakdown(prof), profiled_wall_ms=wall)
        w = walls[name]
        w["idle_share"] = 1 - w["device_ms"] / w["ms"]
        top = ", ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in w["top"][:4])
        print(f"  {name}: wall {w['ms']:.2f} ms (cold {w['cold_ms']:.2f}), max_abs_err "
              f"{err:.3e} (rel {rel:.3e} <= {MAIN_RTOL}); device busy {w['device_ms']:.2f} ms "
              f"(idle {w['idle_share']:.1%}): {top}", flush=True)

    def barrier_on(mesh, schedule):
        with mesh:
            return barrier("x", schedule=schedule)

    mesh44 = Mesh((4, 4), ("row", "col"), device=DEVICE)
    mesh8 = Mesh((8,), ("model",), device=DEVICE)
    mesh16 = Mesh((16,), ("x",), device=DEVICE)

    # SUMMA: the MLP up-projection, X (T x d_model) @ W_up (d_model x d_ff).
    A, B = randn(TOKENS, D_MODEL), randn(D_MODEL, D_FF)
    ref = A @ B
    for s in ("native", "chain", "pipelined", "tree", "ring"):
        check(f"summa {s} 4x4", lambda: summa_sharded(A, B, mesh44, "row", "col", schedule=s), ref)
    del A, B, ref

    # FCL: attention output projection, 8 members of 4 heads x 128 each.
    attn, wo = randn(TOKENS, N_HEADS * HEAD_DIM), randn(N_HEADS * HEAD_DIM, D_MODEL)
    ref = attn @ wo
    for s in ("native", "chain", "pipelined", "tree"):
        check(f"fcl {s} x8", lambda: fcl_sharded(attn, wo, mesh8, "model", schedule=s), ref)
    check("fcl native scatter x8",
          lambda: fcl_sharded(attn, wo, mesh8, "model", scatter=True), ref)
    del attn, wo, ref

    x, w_up = randn(TOKENS, D_MODEL), randn(D_MODEL, D_FF)
    check("ag_matmul x8", lambda: ag_matmul_sharded(x, w_up, mesh8, "model"), x @ w_up)
    del x, w_up
    h, w_down = randn(TOKENS, D_FF), randn(D_FF, D_MODEL)
    check("matmul_rs x8", lambda: matmul_rs_sharded(h, w_down, mesh8, "model"), h @ w_down)
    del h, w_down

    sixteen = torch.full((16,), 16, dtype=torch.int32, device=DEVICE)
    for s in ("native", "tree"):
        check(f"barrier {s} x16", lambda: barrier_on(mesh16, s), sixteen)
    return walls


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.reduce_nway import reduce_nway

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # 1. Build.
    path, secs, report = _build.build()
    print(f"[build] {path.relative_to(ROOT)} in {secs:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"  {line.strip()}")
    _build.library()

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)

    # 2. Kernels against their plain versions.
    print("[kernels] against the plain versions, on the card")
    gemm_rows = [run_case(cs) for cs in gemm_cases(gen)]
    reduce_rows = [run_case(cs) for cs in reduce_cases(gen)]
    lsb_and_barrier()
    torch.cuda.empty_cache()

    # 3. The main path; only its launches count.
    print(f"[main path] yi-6b widths: d_model {D_MODEL}, {N_HEADS} heads x {HEAD_DIM}, "
          f"d_ff {D_FF}, {TOKENS} tokens")
    torch.cuda.reset_peak_memory_stats()
    gemm.launches = 0
    reduce_nway.launches = 0
    walls = main_path(gen)
    launches = {"gemm": gemm.launches, "reduce_nway": reduce_nway.launches}
    print(f"  launches on the main path: {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was never launched on the main path")

    # 4. Result lines.
    def entry(name, source, replaces, rows):
        main_row = rows[0]  # the main-path shape of this kernel
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[name], "max_abs_err": main_row["max_abs_err"],
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "library_ms": main_row["library_ms"], "case": main_row["case"],
                "cases": rows}

    kernels = [
        entry("gemm", "src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:48", gemm_rows),
        entry("reduce_nway", "src/repro_torch/kernels/csrc/reduce_nway.cu",
              "src/repro/kernels/reduce_nway.py:38", reduce_rows),
    ]
    print(json.dumps({"main_path": walls}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
