"""The collective GEMM driver: one caller in a closed loop on an entry point
of ``repro_torch.core`` (``summa_sharded``, ``fcl_sharded``), through the
model's layers in turn, as a forward pass makes the same call in each.

Traffic keys: ``entry`` (summa, fcl); ``series`` (the name that the
cell's end-to-end metrics carry: ``<series>_call_ms``,
``<series>_call_p95_ms``; cells whose calls spread alike share one);
``schedule``; ``mesh`` (the stacked mesh's shape: (r, c) for summa, (n,)
for fcl); ``weight`` (the product's weight by its name in
``inputs.llama_weights``, such as ``mlp.w_up``); ``tokens`` (the rows of
the activation); ``activations`` (how many seeded activations the calls
rotate through); ``warm_calls`` (at least ``samples`` + 2 are made);
``samples`` (how many of the window's whole outputs, drawn from the seed,
are compared); ``limits``.  The configuration gives the widths, the depth
and ``compute_dtype``.

The card holds every weight of the model (``inputs.llama_weights``), as
the deployment does; call i multiplies activation i mod ``activations`` by
layer i mod ``num_hidden_layers``'s ``weight``.  Each call ends in
``torch.cuda.synchronize()``, as a caller that reads C does; its latency
is taken on the host's clock from the call to the synchronize, and holds
the call's checksum: C's column sums, one read of C on the card (about
0.6 % of a call) inside a ``check`` span (``trace.CHECK_SPAN``), so that
the readers can tell the benchmark's kernels from the program's.  The
checksums go into rows allocated in set-up, as many as calls at the
products' roofline would fill the window, and the warm-up holds as many
outputs as the window does: memory allocated in the window would stall
its call in ``cudaMalloc`` (10-50 ms, every hundredth call or so).  Once
the window has closed, two numbers decide ``correct``: ``max_rel_err``,
the sampled outputs' largest error over their largest reference value
(``reference.matmul``: f32, TF32 off), and ``sum_rel_err``, the same of
every call's column sums against the reference's, ``(1^T X) W`` in f64.
"""

from __future__ import annotations

import math
import random
import time


def make_call(tr: dict, device):
    """``(x, w) -> C`` through the traffic's entry point."""
    from repro_torch.core.fcl import fcl_sharded
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.summa import summa_sharded

    entry, shape = tr["entry"], tuple(tr["mesh"])
    if entry == "summa":
        mesh = Mesh(shape, ("row", "col"), device=device)
        return lambda x, w: summa_sharded(x, w, mesh, "row", "col", schedule=tr["schedule"])
    if entry == "fcl":
        mesh = Mesh(shape, ("model",), device=device)
        return lambda x, w: fcl_sharded(x, w, mesh, "model", schedule=tr["schedule"])
    raise ValueError(f"unknown collective GEMM entry {entry!r}")


def make_inputs(cell, seed: int, device):
    """(activations, the layers' weights, every weight): drawn on ``device``
    from one generator seeded with ``seed``, the model's weights first, in
    the configuration's ``compute_dtype``.  The activations are N(0, 1), the
    weights N(0, 1 / fan_in), so that C's entries are about N(0, 1)."""
    import torch

    from portbench import inputs

    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cfg["compute_dtype"])
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    every = inputs.llama_weights(cfg, seed, device, dtype, generator=gen)
    ws = [every[f"blocks.{i}.{tr['weight']}"] for i in range(cfg["num_hidden_layers"])]
    m, k = tr["tokens"], ws[0].shape[0]
    xs = torch.randn(tr["activations"], m, k, generator=gen, device=device).to(dtype)
    return xs, ws, every


def operands(i: int, xs, ws) -> tuple:
    """The (activation, layer) of the window's call ``i``."""
    return i % len(xs), i % len(ws)


def checksum(c, out=None):
    """C's column sums, in C's dtype: one read of C and no copy."""
    import torch

    return torch.sum(c, dim=0, out=out)


class Rows:
    """Checksum rows of ``width``, allocated ``cap`` at a time."""

    def __init__(self, cap: int, width: int, dtype, device):
        self.cap, self.shape, self.dtype, self.device = cap, (cap, width), dtype, device
        self.blocks = []

    def __getitem__(self, i: int):
        import torch

        while i // self.cap >= len(self.blocks):
            self.blocks.append(torch.empty(self.shape, dtype=self.dtype, device=self.device))
        return self.blocks[i // self.cap][i % self.cap]

    def first(self, count: int):
        import torch

        return torch.cat(self.blocks)[:count]


def sum_rel_err(sums, xs, ws) -> float:
    """The largest ``rel_err`` of the calls' column sums (row i is call
    i's), each against ``(1^T X) W`` in f64 for the call's operands."""
    from portbench.reference import matmul as ref

    by_pair = {}
    for i in range(len(sums)):
        by_pair.setdefault(operands(i, xs, ws), []).append(i)
    worst = 0.0
    for (a, l), rows in by_pair.items():
        want = xs[a].double().sum(dim=0) @ ws[l].double()
        got = sums[rows]
        worst = max(worst, ref.rel_err(got, want.expand_as(got)))
    return worst


def p95(values) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device: str, started: float):
    import torch

    from portbench import flops
    from portbench import trace as T
    from portbench.cell import Run
    from portbench.reference import matmul as ref

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg, tr = cell.config, cell.traffic
    xs, ws, every = make_inputs(cell, seed, device)
    m, (k, n) = tr["tokens"], ws[0].shape
    call = make_call(tr, device)
    spans = T.Spans(trace)
    least = flops.product_bound_s(flops.gemm_flops(m, k, n),
                                  flops.gemm_bytes(m, k, n, xs.element_size()), cfg["compute_dtype"])
    least = max(least, 1e-5)  # no call and synchronize from Python takes less
    sums = Rows(int(seconds / least) + 16, n, xs.dtype, xs.device)
    warm = []  # as many outputs held as the window holds, so that it allocates none
    for i in range(max(tr["warm_calls"], tr["samples"] + 2)):
        a, l = operands(i, xs, ws)
        warm.append(call(xs[a], ws[l]))
        checksum(warm[-1], out=sums[i])
    sync()
    del warm

    pick = random.Random(seed)
    kept, latencies = [], []  # kept: a reservoir of (call, output) drawn from the seed
    prof = T.start_profiler() if trace else None
    sync()
    t_open = time.perf_counter()
    t = t_open
    while t - t_open < seconds or not latencies:
        i = len(latencies)
        a, l = operands(i, xs, ws)
        t0 = time.perf_counter()
        with spans.span("call"):
            c = call(xs[a], ws[l])
        with spans.span(T.CHECK_SPAN):
            checksum(c, out=sums[i])
        with spans.span("synchronize"):
            sync()
        t = time.perf_counter()
        latencies.append(t - t0)
        if len(kept) < tr["samples"]:
            kept.append((i, c))
        else:
            j = pick.randrange(len(latencies))
            if j < len(kept):
                kept[j] = (i, c)
    if prof is not None:
        prof.stop()
    window_s = t - t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del call, c
    traced = T.reduce_profile(prof) if prof is not None else None
    del prof

    def sampled_err(i, out):
        a, l = operands(i, xs, ws)
        return ref.rel_err(out, ref.matmul(xs[a], ws[l]))

    worst = max(sampled_err(i, out) for i, out in kept)
    del kept, every
    units, series, lim = len(latencies), tr["series"], tr["limits"]
    summed = sum_rel_err(sums.first(units), xs, ws)
    return Run(
        setup_s=t_open - started, window_s=window_s, units=units, attempted=units,
        end_to_end={f"{series}_call_ms": window_s / units * 1e3,
                    f"{series}_call_p95_ms": p95(latencies) * 1e3,
                    "setup_s": t_open - started},
        checks={"max_rel_err": (worst, lim["max_rel_err"]),
                "sum_rel_err": (summed, lim["sum_rel_err"])},
        shapes={"m": m, "k": k, "n": n, "members": math.prod(tr["mesh"]),
                "dtype": cfg["compute_dtype"], "itemsize": xs.element_size()},
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        memory_peak_bytes=int(peak), trace=traced)
