"""Production-mesh dry run: every (architecture x shape) cell traced, not run.

The port's counterpart of ``src/repro/launch/dryrun.py``.  For each cell:

  * build the step function and its laid-out inputs (``launch/steps.py``)
    on the production mesh, (16, 16) single-pod and (2, 16, 16) multi-pod
    (``launch/mesh.py``), as stacked members;
  * run the step once on tensors that hold no data, where the reference
    lowers and compiles it: ``--device cuda`` (the default) traces the
    card's path, every kernel through its op (``torch.library`` custom
    ops with fake implementations and FLOP formulas, ``kernels/``), on
    meta tensors; ``--device cpu`` traces the plain path (the kernels'
    plain versions) under ``FakeTensorMode``.  Nothing is allocated on a
    device, so the full depth is traced on a host without a card;
  * record the roofline (``launch/roofline.py``) on the H100's constants:
    ``hlo_flops`` from ``torch.utils.flop_counter`` (the kernels by their
    formulas), ``hlo_bytes`` the bytes that each op reads and writes (views
    move none; eager PyTorch fuses nothing, so this is the port's real
    traffic), ``coll_bytes`` / ``coll_breakdown`` the result bytes of the
    axis functions of ``core/mesh.py`` (``count_collectives``), all
    members' together; ``bytes_per_device`` the inputs' bytes per member
    from their specs plus the trace's peak of live storage over the
    members; the kernels' launches that the step would make; ``method:
    "traced"``.

The card's path traces on meta tensors rather than fake CUDA ones because
a CPU-only PyTorch has no CUDA device guard: autograd on a fake CUDA
tensor aborts the process there.  Meta tensors take the same ops and the
kernels' ops (whose meta kernels are their fake implementations).

The reference lowers each cell three times (``compile-scan`` and the
unrolled ``baseline`` single-pod, ``compile-scan`` multi-pod) and
extrapolates deep unrolled models from two shallow ones.  A trace has no
compile cost, ``scan_layers`` changes nothing in the port, and the port
runs its layers in a Python loop: one ``baseline`` pass per mesh traces
the full depth.  Records go to ``results/dryrun_torch.json`` (never the
reference's ``results/dryrun.json``); the sweep is resumable.  Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-multipod]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import mesh as M
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import H100, from_trace
from repro_torch.launch.shapes import SHAPES, applicable
from repro_torch.launch.steps import build_cell, member_bytes

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results"
OUT = "dryrun_torch.json"
KERNEL_NS = "repro_torch"  # the kernels' ops: torch.ops.repro_torch.*


def _tensor_bytes(t: torch.Tensor) -> int:
    """The distinct bytes a tensor covers (a broadcast dim counts once)."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


class Tally(TorchDispatchMode):
    """Per op: its launches if it is a kernel's op, the bytes it reads and
    writes (tensor arguments and results; a view op moves none), and the
    storage it allocates, whose live total's peak is kept (a storage is
    freed when its last tensor goes).  ``flops`` is the ``FlopCounterMode``
    that the trace runs beside it.  Inside :meth:`repeat` every cost
    counts n times."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.launches: dict[str, int] = {}
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.times = 1
        self._known: set[int] = set()

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Ops traced inside stand for ``n`` identical runs of them, one
        after another (a loop of identical slices): their FLOPs, bytes and
        launches count n times; their storage is live once."""
        counts = self.flops.flop_counts["Global"]
        before, times = dict(counts), self.times
        self.times *= n
        try:
            yield
        finally:
            self.times = times
            for op, v in list(counts.items()):
                counts[op] += (v - before.get(op, 0)) * (n - 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == KERNEL_NS:
            name = func.__name__.split(".")[0]
            self.launches[name] = self.launches.get(name, 0) + self.times
        if func.is_view:
            return out
        flat = []
        for x in (*args, *kwargs.values(), out):
            flat.extend(x if isinstance(x, (list, tuple)) else (x,))
        self.bytes += self.times * sum(_tensor_bytes(t) for t in flat
                                       if isinstance(t, torch.Tensor))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())
        return out

    def exclude(self, tensors):
        """Storages that exist before the trace (the inputs): not counted."""
        for t in tensors:
            self._known.add(t.untyped_storage()._cdata)

    def _track(self, storage):
        key = storage._cdata
        if key in self._known:
            return
        self._known.add(key)
        n = storage.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key, n)

    def _free(self, key: int, n: int):
        self._known.discard(key)
        self.live -= n


def _tensors(obj):
    """Every tensor in nested inputs (modules' parameters included)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


@contextlib.contextmanager
def trace_device(device: str):
    """The device a trace's tensors take: ``cuda`` (the card's path) traces
    on meta tensors; ``cpu`` (the plain path) under ``FakeTensorMode``."""
    if device == "cuda":
        yield torch.device("meta")
    elif device == "cpu":
        with FakeTensorMode():
            yield torch.device("cpu")
    else:
        raise ValueError(f"dry run on {device!r}: cuda or cpu")


@contextlib.contextmanager
def _flash_grad_traced_once(tally: Tally):
    """Within: the plain flash backward (``kernels/flash_attention.py``)
    traces its first slice of BH once, standing for all the equal ones
    (``tally.repeat``), and a ragged last one on its own: the loop's costs
    at one slice's trace time.  Tensors that hold data run the whole loop."""
    whole = fa.flash_attention_grad

    def grad(q, k, v, g, *, window: int = 0):
        parts = fa.grad_parts(*q.shape[:2])
        if q.device.type != "meta" and not isinstance(q, FakeTensor):
            return whole(q, k, v, g, window=window)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        equal = [p for p in parts if p.stop - p.start == parts[0].stop - parts[0].start]
        with tally.repeat(len(equal)):
            fa.grad_part(q, k, v, g, window, parts[0], grads)
        for part in parts[len(equal):]:
            fa.grad_part(q, k, v, g, window, part, grads)
        return grads

    fa.flash_attention_grad = grad
    try:
        yield
    finally:
        fa.flash_attention_grad = whole


def trace_step(built: dict, mesh, inputs=None) -> dict:
    """Run ``built``'s step once under the counters on ``inputs`` (made by
    its ``make_inputs`` when None): FLOPs, bytes, collective bytes by kind,
    peak of live storage, kernel launches, all members' together."""
    inputs = built["make_inputs"]() if inputs is None else inputs
    flops = FlopCounterMode(display=False)
    tally = Tally(flops)
    tally.exclude(_tensors(inputs))
    with M.count_collectives() as coll, flops, tally, _flash_grad_traced_once(tally):
        built["step_fn"](*inputs)
    return {"flops": flops.get_total_flops(), "bytes": tally.bytes, "coll": dict(coll),
            "peak_bytes": tally.peak, "launches": dict(sorted(tally.launches.items())),
            "input_bytes_per_member": member_bytes(built["specs"], mesh)}


def run_cell(arch: str, shape: str, multi_pod: bool = False, variant: str = "baseline",
             cfg_override=None, verbose: bool = True, mesh=None, mesh_name: str | None = None,
             build_opts: dict | None = None, device: str = "cuda"):
    """Trace one cell (see the module docstring) and return its record.

    ``mesh`` (a ``core.mesh.Mesh`` or anything with ``shape`` and
    ``axis_names``) replaces the production mesh; it is rebuilt on the
    trace's device.  A failing cell is a record with ``status: "fail"``.
    """
    cfg = cfg_override or get_config(arch)
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": "multi" if multi_pod else "single",
                "variant": variant, "status": "skipped", "reason": why}
    if mesh is None:
        mesh_name = mesh_name or ("2x16x16" if multi_pod else "16x16")
    mesh_name = mesh_name or "x".join(map(str, mesh.shape))
    cell = SHAPES[shape]
    t0 = time.perf_counter()
    try:
        with trace_device(device) as dev:
            tmesh = make_production_mesh(multi_pod=multi_pod, device=dev) if mesh is None \
                else M.Mesh(mesh.shape, mesh.axis_names, device=dev)
            built = build_cell(cfg, shape, tmesh, **(build_opts or {}))
            counts = trace_step(built, tmesh)
            del built
        chips = math.prod(tmesh.shape)
        roof = from_trace(arch, shape, mesh_name, chips, flops=counts["flops"],
                          bytes_accessed=counts["bytes"], coll=counts["coll"],
                          bytes_per_device=counts["input_bytes_per_member"]
                          + counts["peak_bytes"] / chips,
                          cfg=cfg, cell_kind=cell.kind, seq_len=cell.seq_len,
                          global_batch=cell.global_batch, hardware=H100)
        rec = roof.to_dict()
        rec.update({
            "method": "traced", "variant": variant, "status": "ok", "device": device,
            "trace_s": round(time.perf_counter() - t0, 2),
            "launches": counts["launches"],
            "input_bytes_per_member": counts["input_bytes_per_member"],
            "trace_peak_bytes": counts["peak_bytes"],
        })
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape} ({variant}): OK ({rec['trace_s']}s) "
                  f"bottleneck={rec['bottleneck']} frac={rec['roofline_fraction']:.3f} "
                  f"bytes/dev={rec['bytes_per_device'] / 2**30:.2f}GiB", flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 — a failing cell is a recorded bug
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape} ({variant}): FAIL {e}", flush=True)
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name, "variant": variant,
                "status": "fail", "error": str(e)[:2000],
                "trace_s": round(time.perf_counter() - t0, 2)}


def append_result(rec: dict, path: pathlib.Path | None = None):
    path = path or (RESULTS / OUT)
    path.parent.mkdir(parents=True, exist_ok=True)
    records = json.loads(path.read_text()) if path.exists() else []
    records = [r for r in records
               if not (r["arch"] == rec["arch"] and r["shape"] == rec["shape"]
                       and r["mesh"] == rec["mesh"]
                       and r.get("variant", "baseline") == rec.get("variant", "baseline"))]
    records.append(rec)
    path.write_text(json.dumps(records, indent=1))


def _done(records, arch, shape, mesh, variant) -> bool:
    return any(r["arch"] == arch and r["shape"] == shape and r["mesh"] == mesh
               and r.get("variant") == variant and r.get("status") != "fail"
               for r in records)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-multipod", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the kernels' path (default); cpu: the plain versions")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.out) if args.out else (RESULTS / OUT)
    existing = json.loads(out.read_text()) if (out.exists() and not args.no_resume) else []
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    # one pass per cell and mesh: single-pod, then multi-pod
    jobs = [(a, s, mp) for a in archs for s in shapes
            for mp in ((False,) if args.no_multipod else (False, True))]
    for a, s, mp in jobs:
        mesh_name = "2x16x16" if mp else "16x16"
        if _done(existing, a, s, mesh_name, "baseline"):
            print(f"[{mesh_name}] {a} x {s} (baseline): cached, skip")
            continue
        rec = run_cell(a, s, multi_pod=mp, device=args.device)
        append_result(rec, out)


if __name__ == "__main__":
    main()
