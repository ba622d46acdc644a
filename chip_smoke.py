#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with one CUDA card and ``nvcc``.
Phases, each of which raises on failure:

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc``, print the build time and ptxas's
   registers and spills (and a summary for the CUDA-core ``gemm``, ``wkv``,
   ``mma.sync`` flash and ``rglru_scan`` kernels; a spill in either of the
   last two fails), and count the HGMMA instructions of the two wgmma
   kernels and the HMMA instructions of the ``mma.sync`` flash kernel in
   the library's SASS (none fails);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the main paths, with times, a library call as yardstick,
   and the card's least time for the same work (``bound_ms``).  ``gemm``
   has two routes (tensor-core for bf16, CUDA-core for the rest), and
   ``flash_attention`` two (wgmma for bf16 at d 64-256, ``mma_sync`` for
   the rest): every case names the route it must take, and the 4096^3
   bf16 gemm and the yi-6b bf16 flash wave also run through the other
   route, so that the speed-up is read on one card.  Each
   CUDA-core ``gemm`` case names its launch plan (``gemm_plan``: tile 128
   or 64, vector or scalar loads); ``wkv`` prints its cluster size, shared
   memory and resident clusters at head sizes 64 and 32;
3. drive the collective GEMM path at the widths of yi-6b (d_model 4096,
   32 heads x 128, d_ff 11008) with T = 4096 tokens: SUMMA on a 4x4 mesh
   (all five schedules), FCL over 8 members (four schedules plus
   ``scatter``), ``ag_matmul`` and ``matmul_rs`` over 8, and the barrier
   over 16; each output is held against ``torch.matmul`` in f32, and
   ``gemm`` and ``reduce_nway`` must have been launched;
4. serve yi-6b at full width and depth (32 layers) with random weights
   from ``--seed``: in f32, the prefill logits of one wave (4 x 2048
   tokens) through the flash kernel against plain attention, and
   decode-after-prefill against a longer prefill (the KV-cache gate); then
   in bf16, ``Server.serve`` of 8 requests (prompts of 1536-2048 tokens, 4
   slots, 32 new tokens), twice, which must give in-vocab, equal tokens,
   with ``flash_attention`` launched 32 times per prefill, all on its
   tensor-core route (the f32 checks take the ``mma_sync`` route);
5. serve recurrentgemma-2b at full width and depth (26 layers) in the same
   way: f32 prefill logits through ``rglru_scan`` and ``flash_attention``
   against their plain versions, decode at 2600 after a prefill of 2600
   (past the attention window of 2048) against a prefill of 2601, then the
   bf16 serve twice, with ``rglru_scan`` launched 18 and ``flash_attention``
   8 times per prefill (tensor-core route);
6. serve rwkv6-3b at full width and depth (32 layers) in the same way:
   f32 prefill logits through ``wkv`` against its plain version, decode at
   2048 against a prefill of 2049 (a ragged last chunk), then the bf16
   serve twice, with ``wkv`` launched 32 times per prefill;
7. train: each kernel's ``autograd.Function`` (``flash_attention`` in f32
   on its ``mma_sync`` route and in bf16 on its wgmma route,
   ``rglru_scan``, ``wkv``) against autograd through its plain version at
   the training shapes, each output carrying a ``grad_fn`` and
   ``rglru_scan``'s backward launching the kernel; the loss and every
   parameter's gradient of qwen1.5-0.5b (2 layers), recurrentgemma-2b (3)
   and rwkv6-3b (2) at full width in f32 through the kernels against the
   plain versions; qwen1.5-0.5b at full width and depth (24 layers) in
   bf16 through ``launch/train.py`` (12 steps of 4 x 2048 tokens: step
   time, tokens/s, MFU, peak memory, the idle share of a profiled step,
   ``flash_attention`` 48 launches a step on its wgmma route); a learning
   gate (12 steps on one repeated batch lower the loss by a nat); exact
   resume from a checkpoint (2 layers, f32); recurrentgemma-2b (6 layers)
   and rwkv6-3b (4 layers) at full width in bf16, 6 steps each;
8. the fabric programs of the main path, on the host, through the port's
   own copy of the NoC substrate (program IR, flit-level simulator):
   reproduce the 21 golden fingerprints of the legacy emitters, traces and
   replays; check every numeric claim of the paper (``all_claims``); emit
   phase 3's schedules as programs at 32 KiB (SUMMA on 4x4, FCL's
   all-reduce, ``ag_matmul`` and ``matmul_rs`` over a row of 8) and print
   their simulated cycles and native-over-baseline speed-ups beside phase
   3's measured warm-wall ratios (printed, held to nothing); the overlap
   gate (the 8x8 SUMMA with modelled compute beats its barrier form and
   stays at or above max(comm-only, compute-only)); all within 30 s;
9. print the ``{"training": ...}`` line, the ``{"fabric": ...}`` line, the
   ``{"kernels": [...]}`` line, one entry per route of each kernel (with
   its gradient's method and times where it has one), and, last, the
   ``{"ok": true, ...}`` line.

It exits non-zero, printing no result, when no CUDA card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_TF32 = 494.7e12    # FLOP/s, tensor cores, TF32
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12    # HBM bytes/s

# yi-6b widths (src/repro/configs/yi_6b.py) and the token count.
D_MODEL, N_HEADS, HEAD_DIM, D_FF, TOKENS = 4096, 32, 128, 11008, 4096

# Main-path tolerance, relative to max|ref|: every product is an f32 sum
# over K = 4096 (11008 for matmul_rs) taken in another order than cuBLAS's;
# a random-walk rounding error is ~sqrt(K) * 2^-24 of a typical term, three
# orders below 1e-4, while one wrong block would give an error of order 1.
MAIN_RTOL = 1e-4
# bf16 kernel outputs are held element by element, |out - ref| <= BF16_RTOL *
# |ref| + atol: kernel and plain version take every product and sum in f32
# (in other orders, ~1e-6 relative apart) and round once to bf16, so they
# may differ by one bf16 ulp, at most 2^-7 of the value; the atol (stated
# per case) covers the f32 difference where the value is near zero.
BF16_RTOL = 2.0 ** -7
DEVICE = "cuda"

# Serving phases (repro_torch.configs): one wave of 4 x 2048 tokens for the
# f32 checks, then 8 requests of 1536-2048 tokens over 4 slots.
WAVE, SLOTS, REQUESTS, MAX_NEW = 2048, 4, 8, 32
PROMPT_LENS = (1536, 2048)
MAX_LEN = 2080
# Further flash cases (BH, S, d[, window]): a gemma3-12b local layer of 4
# sequences x 16 heads x 256 with its window of 1024, a ragged S, and the
# hybrid's layer.
GEMMA_LOCAL = (4 * 16, 4096, 256, 1024)
RAGGED = (32, 1000, HEAD_DIM)
# recurrentgemma-2b's attention layer over one wave: 4 sequences x 10 heads
# of 256, window 2048.
HYBRID_WAVE = (4 * 10, WAVE, 256, 2048)
# f32 prefill logits, flash kernel against plain attention, relative to
# max|logits|: each layer's attention differs from the plain version by the
# f32 rounding of another summation order (~1e-6 relative); 32 layers of
# random weights carry that through, and a wrong block would give an error
# of order 1.  The decode-after-prefill gate holds to the same bound.
SERVE_RTOL = 1e-3
# The models each serving phase drives: its kernels with their launches per
# prefill, and the decode gate's position (past recurrentgemma's window of
# 2048; a ragged last chunk of rwkv6's 64).
SERVES = (
    dict(arch="yi_6b", kernels={"flash_attention": 32}, gate=WAVE),
    dict(arch="recurrentgemma_2b", kernels={"rglru_scan": 18, "flash_attention": 8}, gate=2600),
    dict(arch="rwkv6_3b", kernels={"wkv": 32}, gate=2048),
)
# Recurrence kernel cases: the hybrid's wave (B, S, lru width), the rwkv6
# wave (B, S, heads, head size), and ragged S.
RGLRU_WAVE = (4, WAVE, 2560)
RGLRU_RAGGED = (3, 1000, 2560)
WKV_WAVE = (4, WAVE, 40, 64)
WKV_RAGGED = (2, 1000, 40, 64)
WKV_STRONG = (2, 1024, 40, 64)  # at the model's strongest decay, logw = -e^2
WKV_HD32 = (4, WAVE, 80, 32)    # the same width in heads of 32 (clusters of 2)
# Training (phase 7).  Kernel gradients at the training shapes: qwen1.5-0.5b's
# attention over one batch (4 sequences x 16 heads of 64), the hybrid's scan
# and rwkv6's wkv over 2 x 2048 tokens.  Tolerances: the reference tests'
# (2e-4 flash f32, 2e-2 bf16, 1e-4 rglru, 2e-3 wkv) of max|g_plain|.
GRAD_FLASH = (4 * 16, WAVE, 64)
GRAD_RGLRU = (2, WAVE, 2560)
GRAD_WKV = (2, WAVE, 40, 64)
# Whole-model f32 gates at full width, depth cut: the loss and each gradient
# leaf within TRAIN_RTOL of the plain versions' max|.| (the bound of the
# serving f32 gates: a summation order per layer apart, a wrong block O(1)).
GATE_TOKENS = (1, 1024)
TRAIN_RTOL = 1e-3
TRAIN_GATES = (("qwen1_5_0_5b", 2, ("flash_attention",)),
               ("recurrentgemma_2b", 3, ("rglru_scan", "flash_attention")),
               ("rwkv6_3b", 2, ("wkv",)))
# qwen1.5-0.5b at full width and depth through launch/train.py in bf16; the
# learning gate on one repeated batch; exact resume at 2 layers in f32.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, WAVE, 12
LEARN_STEPS, LEARN_LR, LEARN_DROP = 12, 1e-3, 1.0
RESUME_LAYERS, RESUME_TOKENS = 2, (2, 1024)
# The recurrent families at full width, depth cut, in bf16, with each
# kernel's launches a step: the hybrid's 6 layers are 4 recurrent (the scan
# in the forward, the remat recompute and the backward) and 2 attention
# (forward and recompute, wgmma route); rwkv6's 4 layers run wkv in the
# forward and the recompute.
RECURRENT_TOKENS, RECURRENT_STEPS = (2, WAVE), 6
TRAIN_RECURRENT = (
    dict(arch="recurrentgemma_2b", n_layers=6,
         launches={"rglru_scan": 12, "rglru_scan[backward]": 4, "flash_attention": 4,
                   "flash_attention[tensor_core]": 4}),
    dict(arch="rwkv6_3b", n_layers=4, launches={"wkv": 8}),
)
# The fabric programs of the main path (phase 8), simulated on the host by
# the port's flit-level NoC simulator with the paper's micro-benchmark
# parameters (PAPER_MICRO); its cycles are the modelled fabric's, not the
# card's.  The golden sha256 prefixes are those of the reference's
# tests/test_program.py (legacy emitters, traces and replays), which
# tests/test_torch_noc_copies.py holds equal to these.
GOLDEN_EMITTERS = {
    "broadcast_native": "9d845029befe936b",
    "broadcast_chain": "1485a1d1386b160c",
    "broadcast_pipelined": "87f2e6d2f0b462be",
    "broadcast_tree": "30f0300af8005a90",
    "all_reduce_native": "ca4737a2f9acc989",
    "all_reduce_chain": "ff328f3c872e07aa",
    "all_reduce_pipelined": "2544616bef2344db",
    "all_reduce_tree": "092ab212d9f07daa",
}
GOLDEN_TRACES = {
    "summa4_native": "6fe2d4a63785b259",
    "summa4_tree": "4941198248634659",
    "summa16_native": "268e6dc06073c22a",
    "ag_ring": "12f987c989d01c17",
    "rs_ring": "a9d580d7236c89be",
    "summa_storm8": "ee76b3f5198e7f00",
    "fcl_storm8": "b8146120406afcd8",
    "mixed_storm8": "6b9c41a50739c6a9",
    "collective_storm8": "a89a33ad6d48afbb",
}
GOLDEN_REPLAYS = {
    "replay_summa4_barrier": "1e9ebca967b21cc4",
    "replay_summa4_window": "4231c469be043f3c",
    "replay_gap_barrier": "e52f958030774b90",
    "replay_gap_window": "2f5e70d586315197",
}
# Phase 3's schedules as fabric programs at 32 KiB, the top of the paper's
# 1-32 KiB range (simulation time grows with bytes, so not phase 3's 11 MiB
# tiles): SUMMA on a 4x4 mesh, FCL's all-reduce and the two rings over a row
# of 8 of an 8x8 mesh.  The overlap gate is bench_program's: the 8x8 SUMMA
# with modelled compute, 8 iterations of 2 KiB tiles.
FABRIC_BYTES = 32 * 1024
FABRIC_SCHEDULES = ("native", "chain", "pipelined", "tree")
OVERLAP_SIDE, OVERLAP_ITERS, OVERLAP_TILE = 8, 8, 2048
FABRIC_BUDGET_S = 30.0


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


def product_bounds(ops: float, dtype, nbytes: float) -> dict:
    """``bound`` of a product: bf16 at the bf16 tensor-core rate; f32, at f32
    accuracy, at the least of the CUDA-core time and the 3xTF32 time (three
    TF32 products each at the tensor-core rate), with the CUDA-core figure
    beside it as ``bound_cuda_core``."""
    if dtype == torch.bfloat16:
        return {"bound": bound(ops, PEAK_BF16, nbytes)}
    return {"bound": bound(ops, max(PEAK_F32, PEAK_TF32 / 3), nbytes),
            "bound_cuda_core": bound(ops, PEAK_F32, nbytes)[0]}


def gemm_cases(gen):
    from repro_torch.kernels.gemm import gemm_plan, gemm_route, sm_count
    from repro_torch.kernels.ref import gemm_ref

    def case(name, batch, M, K, N, dtype, accumulate, rtol, iters, atol=None, route=None):
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
        # ``route`` forces a route (the CUDA-core kernel on a tensor-core
        # shape, for the speed-up on one card); else the wrapper's rule picks.
        ptrs = [t.data_ptr() for t in (a, b) + ((c,) if accumulate else ())]
        taken = route or gemm_route(dtype, K, N, ptrs)
        tag = taken
        if taken == "cuda_core":  # the launch plan the wrapper will take
            tile, vector = gemm_plan(nb, M, N, K, sm_count(0), ptrs, dtype)
            tag += f", tile {tile}, {'vector' if vector else 'scalar'}"
        return dict(name=f"{name} [{tag}]", route=taken, wrapper=gemm,
                    kernel=lambda: gemm(a, b, c, accumulate=accumulate, _route=route),
                    plain=lambda: gemm_ref(a, b, c, accumulate=accumulate), library=lib,
                    rtol=rtol, atol=atol, iters=iters, **product_bounds(ops, dtype, nbytes))

    from repro_torch.kernels.ops import gemm
    f32, bf16 = torch.float32, torch.bfloat16
    # f32: sums over K <= 1024 in another order than the plain version's,
    # relative to max(1, max|ref|); bf16: element by element (BF16_RTOL), the
    # atol above the f32 sum-order difference over K = 4096 (~1e-4 at most).
    summa = (16, TOKENS // 4, D_MODEL // 4, D_FF // 4)       # one step on the 4x4 mesh
    fcl = (8, TOKENS, N_HEADS * HEAD_DIM // 8, D_MODEL)      # partials over 8 members
    sq = (0, D_MODEL, D_MODEL, D_MODEL)
    return [
        case("summa_step {}x({}x{} @ {}x{}) +C f32".format(*summa[:3], *summa[2:]),
             *summa, f32, True, 1e-4, 5),
        case("fcl_partials {}x({}x{} @ {}x{}) f32".format(*fcl[:3], *fcl[2:]),
             *fcl, f32, False, 1e-4, 5),
        case(f"square {D_MODEL}^3 bf16", *sq, bf16, False, BF16_RTOL, 20, atol=1e-3),
        case(f"square {D_MODEL}^3 bf16", *sq, bf16, False, BF16_RTOL, 5, atol=1e-3,
             route="cuda_core"),
        case("summa_step {}x({}x{} @ {}x{}) +C bf16".format(*summa[:3], *summa[2:]),
             *summa, bf16, True, BF16_RTOL, 20, atol=1e-3),
        case("ragged 1000x328 @ 328x776 +C bf16", 0, 1000, 328, 776, bf16, True, BF16_RTOL, 20,
             atol=1e-3),
        case("ragged 1000x333 @ 333x776 +C bf16", 0, 1000, 333, 776, bf16, True, BF16_RTOL, 20,
             atol=1e-3),
        case("ragged 1000x333 @ 333x777 +C f32", 0, 1000, 333, 777, f32, True, 1e-4, 20),
        case("ragged 1000x332 @ 332x776 +C f32", 0, 1000, 332, 776, f32, True, 1e-4, 20),
    ]


def reduce_cases(gen):
    from repro_torch.kernels.ops import reduce_nway
    from repro_torch.kernels.ref import reduce_nway_ref

    def case(name, x, op, rtol, library, atol=None):
        n, m = x.shape
        nbytes = (n + 1) * m * x.element_size()
        return dict(name=name, kernel=lambda: reduce_nway(x, op=op),
                    plain=lambda: reduce_nway_ref(x, op), library=library,
                    rtol=rtol, atol=atol, iters=20, bound=bound((n - 1) * m, PEAK_F32, nbytes))

    m = D_MODEL * TOKENS
    xf = torch.randn(8, m, generator=gen, device=DEVICE)
    xb = torch.randn(8, m, generator=gen, device=DEVICE).to(torch.bfloat16)
    bits = (torch.rand(16, 1 << 20, generator=gen, device=DEVICE) < 0.95).to(torch.int32)
    ints = torch.randint(-2 ** 31, 2 ** 31 - 1, (16, 1 << 20), generator=gen, device=DEVICE,
                         dtype=torch.int32)
    # f32 add: 8 terms, rounding ~8 * 2^-24; bf16 add: the f32 sums round to
    # bf16, held element by element (BF16_RTOL); max and and are exact (int32
    # max over the whole int32 range: bit-exact, where an f32 running value
    # would round every value above 2^24).
    return [
        case(f"add (8, {D_MODEL}*{TOKENS}) f32", xf, "add", 1e-5, lambda: torch.sum(xf, 0)),
        case(f"add (8, {D_MODEL}*{TOKENS}) bf16", xb, "add", BF16_RTOL,
             lambda: torch.sum(xb, 0), atol=1e-5),
        case(f"max (8, {D_MODEL}*{TOKENS}) f32", xf, "max", 0.0, lambda: torch.amax(xf, 0)),
        case("and (16, 2^20) int32", bits, "and", 0.0, None),
        case("max (16, 2^20) int32", ints, "max", 0.0, lambda: torch.amax(ints, 0)),
    ]


def causal_pairs(S: int, window: int) -> int:
    """Live (query, key) pairs of a causal mask, within ``window`` when > 0."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_cases(gen):
    from repro_torch.kernels.flash_attention import flash_route
    from repro_torch.kernels.ops import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    import torch.nn.functional as F

    def case(BH, S, d, window, dtype, rtol, iters, atol=None, route=None):
        q, k, v = (torch.randn(BH, S, d, generator=gen, device=DEVICE).to(dtype)
                   for _ in range(3))
        ops = 4.0 * d * BH * causal_pairs(S, window)
        nbytes = 4 * BH * S * d * q.element_size()
        if 0 < window < S:
            i = torch.arange(S, device=DEVICE)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                         attn_mask=mask)
        else:
            lib = lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                         is_causal=True)
        # ``route`` forces a route (see gemm_cases); else the wrapper's rule.
        taken = route or flash_route(dtype, d, [t.data_ptr() for t in (q, k, v)])
        name = f"({BH}, {S}, {d}) {str(dtype).split('.')[-1]} window {window} [{taken}]"
        return dict(name=name, route=taken, wrapper=flash_attention,
                    kernel=lambda: flash_attention(q, k, v, window=window, _route=route),
                    plain=lambda: flash_attention_ref(q, k, v, window=window), library=lib,
                    rtol=rtol, atol=atol, iters=iters, **product_bounds(ops, dtype, nbytes))

    f32, bf16 = torch.float32, torch.bfloat16
    bh = 4 * N_HEADS  # one wave of yi-6b: 4 sequences x 32 heads
    # f32: sums over keys and head dims in another order than the plain
    # version's, with the online softmax's rescaling, and 3xTF32 products
    # (~2^-21 relative each), ~1e-6 relative to max(1, max|ref|); bf16:
    # element by element (BF16_RTOL).  Row i's output has a spread of
    # ~sqrt(e / (i + 1)), ~0.04 at S = 2048, so dropping one
    # 64-key tile, or starting the window a tile late, moves it by ~0.01: far
    # above either limit.  The gemma3 local layer runs in both types, so that
    # the window's tile skip at d = 256 is held at the f32 limit too.
    return [
        case(bh, WAVE, HEAD_DIM, 0, bf16, BF16_RTOL, 20, atol=1e-5),
        case(bh, WAVE, HEAD_DIM, 0, f32, 1e-4, 5),  # phases 4-5's f32 checks: mma_sync's first
        case(bh, WAVE, HEAD_DIM, 0, bf16, BF16_RTOL, 5, atol=1e-5, route="mma_sync"),
        case(bh, WAVE, 32, 0, bf16, BF16_RTOL, 10, atol=1e-5),
        case(*HYBRID_WAVE, bf16, BF16_RTOL, 20, atol=1e-5),
        case(*GEMMA_LOCAL, bf16, BF16_RTOL, 10, atol=1e-5),
        case(*GEMMA_LOCAL, f32, 1e-4, 3),
        case(*RAGGED, 0, f32, 1e-4, 10),
    ]


def rglru_cases(gen):
    from repro_torch.kernels.ops import rglru_scan
    from repro_torch.kernels.ref import rglru_scan_ref

    def case(shape, dtype, rtol, iters, atol=None):
        # decays in (0, 1), a tenth of them above 0.99 (long memory)
        a = (torch.rand(shape, generator=gen, device=DEVICE) ** 0.1).to(dtype)
        b = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        n = a.numel()
        name = f"{tuple(shape)} {str(dtype).split('.')[-1]}"
        return dict(name=name, kernel=lambda: rglru_scan(a, b), plain=lambda: rglru_scan_ref(a, b),
                    library=None, rtol=rtol, atol=atol, iters=iters,
                    bound=bound(2.0 * n, PEAK_F32, 3 * n * a.element_size()))

    f32, bf16 = torch.float32, torch.bfloat16
    # f32: the same products and sums associated otherwise (runs of 8 steps
    # and segments of 128 composed by the look-back), ~1e-6 relative to
    # max(1, max|ref|); bf16: the f32 result rounded once, element by element
    # (BF16_RTOL), the atol above that f32 difference near zero.  A dropped
    # or misplaced carry between segments moves a long-memory channel by O(1).
    return [
        case(RGLRU_WAVE, f32, 1e-4, 20),
        case(RGLRU_WAVE, bf16, BF16_RTOL, 20, atol=1e-4),
        case(RGLRU_RAGGED, f32, 1e-4, 20),
    ]


def wkv_flops(B: int, S: int, H: int, hd: int) -> float:
    """Flops of the chunked WKV: per chunk of n tokens, 4 hd per live pair
    s <= t (the decayed r . k and P @ V) and 4 hd^2 per token (r . state and
    the state update)."""
    total = 0.0
    for t0 in range(0, S, 64):
        n = min(64, S - t0)
        total += 4.0 * hd * n * (n + 1) / 2 + 4.0 * hd * hd * n
    return B * H * total


def wkv_cases(gen):
    from repro_torch.kernels.ops import wkv
    from repro_torch.kernels.ref import wkv_ref

    def case(shape, dtype, rtol, iters, atol=None, logw=None):
        B, S, H, hd = shape
        r, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype) for _ in range(3))
        if logw is None:  # decay rates log-uniform over the model's range
            lw = -torch.exp(torch.rand(shape, generator=gen, device=DEVICE) * 10 - 8)
        else:
            lw = torch.full(shape, logw, device=DEVICE)
        u = 0.5 * torch.randn(H, hd, generator=gen, device=DEVICE)
        nbytes = r.numel() * (4 * r.element_size() + 4) + 4 * (u.numel() + B * H * hd * hd)
        name = f"{tuple(shape)} {str(dtype).split('.')[-1]}" + (
            f" logw {logw:.4f}" if logw is not None else "")
        return dict(name=name, kernel=lambda: wkv(r, k, v, lw, u),
                    plain=lambda: wkv_ref(r, k, v, lw, u), library=None, rtol=rtol, atol=atol,
                    iters=iters, bound=bound(wkv_flops(B, S, H, hd), PEAK_F32, nbytes))

    f32, bf16 = torch.float32, torch.bfloat16
    # f32: sums over 64 key channels and up to 64 tokens in another order
    # than the sequential plain version's, ~1e-6 relative to max(1, max|ref|)
    # (values up to ~1e3 with the weakest decays); bf16: element by element
    # (BF16_RTOL), the atol above that f32 difference where a value is near
    # zero.  At logw = -e^2 the reference's chunked form overflows to NaN;
    # the kernel must be finite and equal the sequential plain version.
    return [
        case(WKV_WAVE, bf16, BF16_RTOL, 3, atol=1e-3),
        case(WKV_WAVE, f32, 1e-4, 3),
        case(WKV_RAGGED, f32, 1e-4, 3),
        case(WKV_STRONG, f32, 1e-4, 3, logw=-math.e ** 2),
        case(WKV_HD32, bf16, BF16_RTOL, 3, atol=1e-3),
    ]


def run_case(cs) -> dict:
    wrapper = cs.get("wrapper")  # a kernel with two routes: the case names its route
    before = dict(wrapper.route_launches) if wrapper else {}
    out, ref = cs["kernel"](), cs["plain"]()
    torch.cuda.synchronize()
    if wrapper:
        moved = {r: wrapper.route_launches[r] - n for r, n in before.items()}
        if moved != {r: int(r == cs["route"]) for r in before}:
            fail(f"{cs['name']}: route launches moved by {moved}, not one {cs['route']}")
    if isinstance(out, tuple):  # wkv's final state: f32, relative to max(1, max|ref|)
        (out, state), (ref, ref_state) = out, ref
        if state.shape != ref_state.shape or not bool(torch.isfinite(state).all()):
            fail(f"{cs['name']}: state {tuple(state.shape)}, plain {tuple(ref_state.shape)}, "
                 "or not finite")
        state_rel = rel_err(state, ref_state)[1]
        if not state_rel <= 1e-4:
            fail(f"{cs['name']}: final state at {state_rel:.3e} of max(1, max|ref|), above 1e-4")
    if not bool(torch.isfinite(out.float()).all()):
        fail(f"{cs['name']}: the kernel's output is not finite")
    if out.shape != ref.shape or out.dtype != ref.dtype or out.device.type != DEVICE:
        fail(f"{cs['name']}: kernel gave {out.shape} {out.dtype} {out.device}, "
             f"plain {ref.shape} {ref.dtype}")
    if cs["atol"] is None:  # relative to max(1, max|ref|)
        err, rel = rel_err(out, ref)
        limit = f"{cs['rtol']} x max(1, max|ref|)"
        ratio = rel / cs["rtol"] if cs["rtol"] else (0.0 if err == 0 else float("inf"))
    else:  # element by element: |out - ref| <= rtol * |ref| + atol
        diff = (out.float() - ref.float()).abs()
        err, rel = diff.max().item(), rel_err(out, ref)[1]
        limit = f"{cs['rtol']:.3e} x |ref| + {cs['atol']} per element"
        ratio = (diff / (cs["rtol"] * ref.float().abs() + cs["atol"])).max().item()
        del diff
    if not ratio <= 1.0:
        fail(f"{cs['name']}: max_abs_err {err:.3e} at {ratio:.3f} of its limit {limit}")
    bound_ms, bound_by = cs["bound"]
    row = dict(case=cs["name"], route=cs.get("route"), max_abs_err=err, rel_err=rel, tol=limit,
               limit_ratio=ratio,
               ms=time_ms(cs["kernel"], cs["iters"]),
               plain_ms=time_ms(cs["plain"], cs["iters"]),
               library_ms=time_ms(cs["library"], cs["iters"]) if cs["library"] else None,
               bound_ms=bound_ms, bound_by=bound_by)
    if "bound_cuda_core" in cs:  # an f32 product: its CUDA-core bound beside
        row["bound_cuda_core_ms"] = cs["bound_cuda_core"]
    print(f"  {row['case']}: max_abs_err {err:.3e} ({ratio:.3f} of {limit}) "
          f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} library "
          f"{row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} "
          f"bound {bound_ms:.4f} ({bound_by})", flush=True)
    return row


def kernel_symbol(mangled: str) -> str:
    """``flash_wgmma_kernel[ILi64E]`` from an Itanium-mangled kernel symbol:
    the name that ends in ``kernel`` and its template arguments as mangled."""
    i, last = mangled.find("_ZN") + 3, mangled
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        ident, i = mangled[j:j + n], j + n
        if ident.endswith("kernel"):
            args = mangled[i:mangled.find("E", i) + 1] if mangled[i:i + 1] == "I" else ""
            return ident + (f"[{args}]" if args else "")
        last = ident
    return last


def print_ptxas(report: str):
    """ptxas's registers, spills and performance notes, by kernel."""
    name = "?"
    for line in report.splitlines():
        if line.startswith("=="):
            print(f"  {line.strip()}")
        elif "Function properties for" in line:
            name = kernel_symbol(line.split("for ", 1)[1].strip())
        elif "registers" in line or "spill" in line or "Potential" in line:
            print(f"    {name}: {line.split(':', 1)[-1].strip()}")


SPILL_CHECKED = ("gemm_kernel", "wkv_kernel", "flash_mma_kernel", "rglru_kernel")


def kernel_spills(report: str) -> dict:
    """Registers and spill bytes (stores + loads) of each instantiation of
    the kernels in ``SPILL_CHECKED``, from ptxas's report."""
    out, name = {}, None
    for line in report.splitlines():
        if "Function properties for" in line:
            mangled = line.split("for ", 1)[1].strip()
            name = next((k for k in SPILL_CHECKED if k + "I" in mangled), None)
            if name:  # the kernel's name and its template arguments as mangled
                args = mangled.split(name, 1)[1]
                name += f"[{args[1:args.find('EE') + 1]}]"
        elif name and "spill" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(name, {})["spill_bytes"] = sum(nums[1:3])
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(line.split("Used", 1)[1].split()[0])
    return out


def tensor_core_sass(lib) -> dict:
    """Tensor-core instructions in the SASS of ``lib``: HGMMA (wgmma) in the
    two wgmma kernels, HMMA (mma.sync) in the mma.sync flash kernel, summed
    over each kernel's instantiations."""
    from repro_torch.kernels import _build

    exe = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(exe), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    ops = {"gemm_wgmma_kernel": "HGMMA", "flash_wgmma_kernel": "HGMMA",
           "flash_mma_kernel": "HMMA"}
    counts = dict.fromkeys(ops, 0)
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in counts if k in line), None)
        elif current and ops[current] in line:
            counts[current] += 1
    return counts


def speedups(gemm_rows, flash_rows):
    """The tensor-core routes against the other ones and the library, at
    the shapes both routes ran in this run."""
    for kind, rows in (("gemm", gemm_rows), ("flash_attention", flash_rows)):
        by_shape = {}
        for r in rows:
            by_shape.setdefault(r["case"].rsplit(" [", 1)[0], {})[r["route"]] = r
        for shape, pair in by_shape.items():
            if len(pair) == 2:
                tc = pair.pop("tensor_core")
                (other, cc), = pair.items()
                print(f"  {kind} {shape}: tensor-core {tc['ms']:.4f} ms, {other} "
                      f"{cc['ms']:.4f} ms ({cc['ms'] / tc['ms']:.2f}x faster), library "
                      f"{tc['library_ms']:.4f} ms ({tc['ms'] / tc['library_ms']:.2f}x its time)")


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


def model_kernels() -> dict:
    """The kernel wrappers that the models call, by name."""
    from repro_torch.kernels.ops import flash_attention, rglru_scan, wkv

    return {"flash_attention": flash_attention, "rglru_scan": rglru_scan, "wkv": wkv}


@contextlib.contextmanager
def plain_kernels(names):
    """The models call the plain versions of the kernels ``names`` in place
    of the kernels (differentiable, for the gradient gates too)."""
    from unittest import mock

    from repro_torch.kernels import ref as kref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import rwkv6 as rwkv_mod

    def plain_flash(q, k, v, *, window=0, **_):
        return kref.flash_attention_ref(q, k, v, window=window)

    def plain_rglru(a, b, **_):
        return kref.rglru_scan_ref(a, b)

    where = {"flash_attention": (attn_mod, "flash_attention", plain_flash),
             "rglru_scan": (rglru_mod, "rglru_scan", plain_rglru),
             "wkv": (rwkv_mod, "wkv", kref.wkv_ref)}
    with contextlib.ExitStack() as stack:
        for name in names:
            stack.enter_context(mock.patch.object(*where[name]))
        yield


def serve_phase(seed: int, arch: str, kernels: dict, gate: int) -> dict:
    """One model at full width and depth: the f32 checks, then the bf16
    serve; returns its numbers.

    ``kernels`` maps each kernel on the model's path to its launches per
    prefill; ``gate`` is the decode gate's position.
    """
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_family
    from repro_torch.runtime.server import Request, Server
    from torch.profiler import ProfilerActivity, profile

    wrappers = model_kernels()
    cfg = get_config(arch)
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    model = fam.init(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}; {n_params / 1e9:.3f} B parameters in "
          f"{str(cfg.param_dtype).split('.')[-1]}, initialised in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_params": n_params}

    # f32 checks: the kernels against their plain versions, and the cache gate.
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    model32 = copy.deepcopy(model).to(torch.float32)
    x = torch.randint(0, cfg.vocab, (SLOTS, max(WAVE, gate) + 1), generator=gen, device=DEVICE)

    def check(key, name, got, ref):
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, or not finite")
        err = rel_err(got, ref)[0]
        scale = ref.abs().max().item()
        if not err <= SERVE_RTOL * scale:
            fail(f"{name}: max_abs_err {err:.3e} above {SERVE_RTOL} x max|logits| {scale:.3e}")
        print(f"  {name}: max_abs_err {err:.3e}, max|logits| {scale:.3e} "
              f"(ratio {err / scale:.3e} <= {SERVE_RTOL})", flush=True)
        out[key] = {"max_abs_err": err, "max_abs": scale}

    # flash_attention, the kernel with two routes, takes its mma_sync one in
    # f32 (these checks) and its tensor-core one in bf16 (the serve): each
    # route's count is read after the part that drives it.
    routed = {name: wrappers[name] for name in kernels
              if hasattr(wrappers[name], "route_launches")}

    def zero_routes():
        for w in routed.values():
            w.route_launches.update(dict.fromkeys(w.route_launches, 0))

    zero_routes()
    with torch.inference_mode():
        before = {name: wrappers[name].launches for name in kernels}
        logits, cache = fam.prefill(model32, x[:, :WAVE], cfg32, max_len=MAX_LEN)
        for name, per in kernels.items():
            if wrappers[name].launches - before[name] != per:
                fail(f"f32 prefill launched {name} {wrappers[name].launches - before[name]} "
                     f"times, not {per}")
        with plain_kernels(kernels):
            plain_logits, _ = fam.prefill(model32, x[:, :WAVE], cfg32)
        check("prefill_f32", f"f32 prefill logits, {' + '.join(kernels)} vs plain, "
              f"{SLOTS} x {WAVE}", logits, plain_logits)
        del plain_logits
        if gate != WAVE:
            del cache
            _, cache = fam.prefill(model32, x[:, :gate], cfg32, max_len=gate + 1)
        dec = fam.decode_step(model32, cache, x[:, gate:gate + 1], gate, cfg32)[0]
        del cache
        full = fam.prefill(model32, x[:, :gate + 1], cfg32, max_len=gate + 1)[0]
        check("decode_gate_f32", f"f32 decode at {gate} vs prefill of {gate + 1}", dec, full)
    del model32, logits, dec, full
    f32_routes = {name: dict(w.route_launches) for name, w in routed.items()}
    for name, counts in f32_routes.items():
        if counts["tensor_core"] or not counts["mma_sync"]:
            fail(f"f32 checks launched {name} by route {counts}: f32 takes the mma_sync route")
    torch.cuda.empty_cache()

    # bf16 serving: 8 requests, two waves of ragged length, run twice.
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, REQUESTS)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
    server = Server(cfg, model, max_len=MAX_LEN, device=DEVICE)
    times = {"prefill": [], "decode": []}

    def timed(fn, key):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return r
        return call

    server._prefill = timed(server._prefill, "prefill")
    server._decode = timed(server._decode, "decode")
    runs = []
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30  # the weights and what else is held
    for name in kernels:
        wrappers[name].launches = 0
    zero_routes()
    for run in ("cold", "warm"):
        for key in times:
            times[key] = []
        reqs = [Request(prompt=p, max_new=MAX_NEW) for p in prompts]
        t = time.perf_counter()
        done = server.serve(reqs, batch_slots=SLOTS)
        wall = (time.perf_counter() - t) * 1e3
        tokens = [r.out for r in done]
        n_tok = sum(len(o) for o in tokens)
        if not all(r.done and len(r.out) == MAX_NEW for r in done):
            fail("serve: a request did not finish with its tokens")
        if not all(0 <= tok < cfg.vocab for o in tokens for tok in o):
            fail("serve: a token outside [0, vocab)")
        runs.append({"run": run, "wall_ms": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall * 1e3,
                     "prefill_ms": list(times["prefill"]),
                     "decode_ms_per_step": sum(times["decode"]) / len(times["decode"]),
                     "decode_steps": len(times["decode"]), "out": tokens})
        print(f"  serve ({run}): {len(done)} requests, prompts {sorted(int(n) for n in lens)}, "
              f"{n_tok} tokens in {wall:.1f} ms ({n_tok / wall * 1e3:.1f} tok/s); prefill ms per "
              f"wave {[round(m, 2) for m in times['prefill']]}, decode "
              f"{runs[-1]['decode_ms_per_step']:.2f} ms per step over "
              f"{len(times['decode'])} steps", flush=True)
    launches = {name: wrappers[name].launches for name in kernels}
    n_prefills = sum(len(r["prefill_ms"]) for r in runs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if runs[0]["out"] != runs[1]["out"]:
        fail("serve: a second run gave other tokens")
    for name, per in kernels.items():
        if launches[name] != per * n_prefills:
            fail(f"{name} launched {launches[name]} times over {n_prefills} prefills, "
                 f"not {per} per prefill")
    serve_routes = {name: dict(w.route_launches) for name, w in routed.items()}
    for name, counts in serve_routes.items():
        if counts != {"mma_sync": 0, "tensor_core": kernels[name] * n_prefills}:
            fail(f"bf16 serve launched {name} by route {counts}, not "
                 f"{kernels[name]} tensor-core launches per prefill")
    print(f"  served twice, same tokens; launches {launches} ({n_prefills} prefills x "
          f"{kernels}), by route {serve_routes} (f32 checks: {f32_routes}); peak device "
          f"memory {peak:.2f} GiB ({resident:.2f} GiB resident at the start)")

    # One profiled prefill and one profiled decode step of the first wave.
    wave = [[0] * (max(map(len, prompts[:SLOTS])) - len(p)) + p for p in prompts[:SLOTS]]
    tokens = torch.tensor(wave, dtype=torch.int64, device=DEVICE)
    with torch.inference_mode():
        for name in ("prefill", "decode"):
            walls = {}
            for run in ("warm", "profiled"):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                    if run == "profiled" else contextlib.nullcontext()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with prof:
                    t = time.perf_counter()
                    if name == "prefill":
                        logits, cache = fam.prefill(model, tokens, cfg, max_len=MAX_LEN)
                    else:
                        nxt = logits.argmax(-1)[:, None]
                        fam.decode_step(model, cache, nxt, tokens.shape[1], cfg)
                    torch.cuda.synchronize()
                    walls[run] = (time.perf_counter() - t) * 1e3
                if run == "warm":
                    call_peak = torch.cuda.max_memory_allocated() / 2**30
            # Idle share against the unprofiled warm wall, as in phase 3: the
            # profiler's own host overhead stretches the profiled wall.
            br = device_breakdown(prof)
            idle = 1 - br["device_ms"] / walls["warm"]
            top = ", ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in br["top"])
            print(f"  {name}: warm wall {walls['warm']:.2f} ms (profiled {walls['profiled']:.2f}), "
                  f"peak device memory {call_peak:.2f} GiB, device busy {br['device_ms']:.2f} ms "
                  f"(idle {idle:.1%}): {top}", flush=True)
            out[f"profiled_{name}"] = {"wall_ms": walls["warm"], "idle_share": idle,
                                       "profiled_wall_ms": walls["profiled"],
                                       "peak_gib": call_peak, **br}
    for r in runs:
        del r["out"]
    out.update(runs=runs, launches=launches, route_launches=serve_routes,
               f32_route_launches=f32_routes, prefills=n_prefills, peak_gib=peak,
               resident_gib=resident, prompt_lens=[int(n) for n in lens])
    # The timed wrappers hold the server's bound methods: a reference cycle
    # that keeps the model alive until the collector runs.
    del model, server, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def grad_cases(gen):
    """Each kernel's ``autograd.Function`` at the training shapes: name,
    kernel, route, function, plain version, inputs, output gradients, tol
    and how the backward computes."""
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.ops import flash_attention, rglru_scan, wkv

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    cases = []
    for dtype, route, tol in ((torch.float32, "mma_sync", 2e-4),
                              (torch.bfloat16, "tensor_core", 2e-2)):
        qkv = [randn(*GRAD_FLASH, dtype=dtype) for _ in range(3)]
        cases.append(dict(
            name=f"flash_attention {GRAD_FLASH} {str(dtype).split('.')[-1]}",
            kernel="flash_attention", route=route, fn=flash_attention,
            plain=kref.flash_attention_ref, inputs=qkv,
            grads=[randn(*GRAD_FLASH, dtype=dtype)], tol=tol,
            grad="autograd through the plain version, slices of BH (kernels/flash_attention.py)"))
    a = (torch.rand(GRAD_RGLRU, generator=gen, device=DEVICE) ** 0.1)
    cases.append(dict(
        name=f"rglru_scan {GRAD_RGLRU} f32", kernel="rglru_scan", route=None,
        fn=rglru_scan, plain=kref.rglru_scan_ref, inputs=[a, randn(*GRAD_RGLRU)],
        grads=[randn(*GRAD_RGLRU)], tol=1e-4,
        grad="the kernel over reversed time (kernels/rglru.py)"))
    B, S, H, hd = GRAD_WKV
    # decay rates log-uniform over the model's whole range [-e^2, -e^-20]
    logw = -torch.exp(torch.rand(GRAD_WKV, generator=gen, device=DEVICE) * 22 - 20)
    logw = logw.clamp(min=-math.e ** 2)
    cases.append(dict(
        name=f"wkv {GRAD_WKV} f32, logw down to -e^2", kernel="wkv", route=None,
        fn=wkv, plain=kref.wkv_ref,
        inputs=[randn(*GRAD_WKV), randn(*GRAD_WKV), randn(*GRAD_WKV), logw,
                0.5 * randn(H, hd), randn(B, H, hd, hd)],
        grads=[randn(*GRAD_WKV), randn(B, H, hd, hd)], tol=2e-3,
        grad="autograd through wkv_chunked_ref, 16-token chunks (kernels/ref.py)"))
    return cases


def launch_counts(wrappers) -> dict:
    """Every launch counter of the kernels in ``wrappers``."""
    out = {}
    for name, w in wrappers.items():
        out[name] = w.launches
        for route, n in getattr(w, "route_launches", {}).items():
            out[f"{name}[{route}]"] = n
        if hasattr(w, "backward_launches"):
            out[f"{name}[backward]"] = w.backward_launches
    return out


def zero_counts(wrappers):
    """Set every launch counter of the kernels in ``wrappers`` to 0."""
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "route_launches"):
            w.route_launches.update(dict.fromkeys(w.route_launches, 0))
        if hasattr(w, "backward_launches"):
            w.backward_launches = 0


def moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def run_grad_case(cs) -> dict:
    """The Function's gradients against autograd through the plain version:
    max|g - g_plain| <= tol * max|g_plain| for every input."""
    wrappers = model_kernels()
    leaves = [t.detach().requires_grad_() for t in cs["inputs"]]
    before = launch_counts(wrappers)
    outs = cs["fn"](*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    if any(o.grad_fn is None for o in outs):
        fail(f"{cs['name']}: an output carries no grad_fn")
    got = torch.autograd.grad(outs, leaves, cs["grads"], retain_graph=True)
    torch.cuda.synchronize()
    launched = moved(before, launch_counts(wrappers))
    want_launches = {cs["kernel"]: 1}
    if cs["route"]:
        want_launches[f"{cs['kernel']}[{cs['route']}]"] = 1
    if cs["kernel"] == "rglru_scan":  # the backward is the kernel once more
        want_launches.update({"rglru_scan": 2, "rglru_scan[backward]": 1})
    if launched != want_launches:
        fail(f"{cs['name']}: forward and backward launched {launched}, not {want_launches}")
    plain_leaves = [t.detach().requires_grad_() for t in cs["inputs"]]
    plain_outs = cs["plain"](*plain_leaves)
    plain_outs = plain_outs if isinstance(plain_outs, tuple) else (plain_outs,)
    want = torch.autograd.grad(plain_outs, plain_leaves, cs["grads"], retain_graph=True)
    ratios = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(g).all()):
            fail(f"{cs['name']}: the gradient of input {i} is not finite")
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        ratios.append(err / (cs["tol"] * scale))
        if not err <= cs["tol"] * scale:
            fail(f"{cs['name']}: gradient of input {i} off by {err:.3e}, above "
                 f"{cs['tol']} x max|g_plain| {scale:.3e}")
    iters = 3 if cs["kernel"] != "flash_attention" else 5
    row = dict(case=cs["name"], kernel=cs["kernel"], route=cs["route"], tol=cs["tol"],
               grad=cs["grad"], max_ratio=max(ratios),
               fwd_ms=time_ms(lambda: cs["fn"](*leaves), iters),
               bwd_ms=time_ms(lambda: torch.autograd.grad(outs, leaves, cs["grads"],
                                                          retain_graph=True), iters),
               plain_fwd_ms=time_ms(lambda: cs["plain"](*plain_leaves), 1),
               plain_bwd_ms=time_ms(lambda: torch.autograd.grad(
                   plain_outs, plain_leaves, cs["grads"], retain_graph=True), 1))
    print(f"  {cs['name']}: gradients at {row['max_ratio']:.3f} of {cs['tol']} x max|g_plain|; "
          f"forward {row['fwd_ms']:.3f} ms, backward {row['bwd_ms']:.3f} ms; plain forward "
          f"{row['plain_fwd_ms']:.3f} ms, backward {row['plain_bwd_ms']:.3f} ms; "
          f"launches {launched}", flush=True)
    return row


def model_grad_gate(seed: int, arch: str, depth: int, kernels) -> dict:
    """One family at full width, ``depth`` layers, in f32: the loss and every
    parameter's gradient through the kernels against the plain versions,
    within TRAIN_RTOL of max|.| (of each leaf)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_family

    cfg = dataclasses.replace(get_config(arch), n_layers=depth, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = fam.init(gen, cfg, DEVICE, trainable=True)
    tokens = torch.randint(0, cfg.vocab, (GATE_TOKENS[0], GATE_TOKENS[1] + 1), generator=gen,
                           device=DEVICE)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    params = list(model.parameters())
    wrappers = model_kernels()

    def value_and_grads():
        loss = fam.loss_fn(model, batch, cfg)
        return loss.item(), torch.autograd.grad(loss, params)

    before = launch_counts(wrappers)
    loss, grads = value_and_grads()
    launched = moved(before, launch_counts(wrappers))
    if not all(launched.get(k) for k in kernels):
        fail(f"{arch} f32 gate: launches {launched}, not every one of {kernels}")
    with plain_kernels(kernels):
        plain_loss, plain_grads = value_and_grads()
    if not abs(loss - plain_loss) <= TRAIN_RTOL * abs(plain_loss):
        fail(f"{arch} f32 gate: loss {loss} against plain {plain_loss}")
    worst = 0.0
    for (name, _), g, w in zip(model.named_parameters(), grads, plain_grads):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        if not bool(torch.isfinite(g).all()) or not err <= TRAIN_RTOL * scale:
            fail(f"{arch} f32 gate: gradient of {name} off by {err:.3e}, max|g_plain| {scale:.3e}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"  {arch} ({depth} layers, f32, {GATE_TOKENS[0]} x {GATE_TOKENS[1]}): loss {loss:.6f} "
          f"(plain {plain_loss:.6f}); worst gradient leaf at {worst:.3e} of its max|g_plain| "
          f"(<= {TRAIN_RTOL}); launches {launched}", flush=True)
    out = {"arch": arch, "n_layers": depth, "loss": loss, "plain_loss": plain_loss,
           "worst_grad_rel": worst, "launches": launched}
    del model, grads, plain_grads
    return out


def train_flops(model, cfg, B: int, S: int) -> float:
    """Model FLOPs of one training step (forward and backward, 3 x the
    forward; the remat recompute not counted): 2 per weight of every
    product per token (the head included), and 4 * head_dim per live
    causal (query, key) pair per head for attention."""
    weights = sum(p.numel() for n, p in model.named_parameters() if p.ndim == 2 and n != "embed")
    weights += model.head.numel()
    attention = 4.0 * cfg.head_dim * cfg.n_heads * B * causal_pairs(S, 0) * cfg.n_layers
    return 3.0 * (2.0 * B * S * weights + attention)


def split_launches(fam, model, batch, cfg) -> dict:
    """Launches of one loss and gradient, by kernel: in the forward, in the
    backward's remat recompute, and by the backward itself."""
    wrappers = model_kernels()
    params = list(model.parameters())
    c0 = launch_counts(wrappers)
    loss = fam.loss_fn(model, batch, cfg)
    c1 = launch_counts(wrappers)
    torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    c2 = launch_counts(wrappers)
    out = {}
    for name in wrappers:
        fwd, during = c1[name] - c0[name], c2[name] - c1[name]
        bwd = c2.get(f"{name}[backward]", 0) - c1.get(f"{name}[backward]", 0)
        if fwd or during:
            out[name] = {"forward": fwd, "recompute": during - bwd, "backward": bwd}
    return out


def profiled_step(trainer, batch) -> dict:
    """One warm optimizer step timed, then one profiled: device busy and idle
    share against the warm wall."""
    from torch.profiler import ProfilerActivity, profile

    model, opt_state, err_state = trainer.state
    walls = {}
    for run in ("warm", "profiled"):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            if run == "profiled" else contextlib.nullcontext()
        torch.cuda.synchronize()
        with prof:
            t = time.perf_counter()
            model, opt_state, err_state, _ = trainer._step_fn(model, opt_state, batch, err_state)
            torch.cuda.synchronize()
            walls[run] = (time.perf_counter() - t) * 1e3
    trainer.state = (model, opt_state, err_state)
    br = device_breakdown(prof)
    return {"wall_ms": walls["warm"], "profiled_wall_ms": walls["profiled"],
            "idle_share": 1 - br["device_ms"] / walls["warm"], **br}


def train_entry(seed: int) -> dict:
    """qwen1.5-0.5b at full width and depth through ``launch/train.py``, bf16."""
    import statistics

    from repro_torch.data import SyntheticLMSource
    from repro_torch.launch import train as train_cli

    B, S, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    wrappers = model_kernels()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    trainer = train_cli.main(["--arch", "qwen1_5_0_5b", "--scale", "full", "--batch", str(B),
                              "--seq", str(S), "--steps", str(steps), "--seed", str(seed)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = launch_counts(wrappers)
    cfg = trainer.model_cfg
    model = trainer.state[0]
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train: losses {losses}")
    per_step = {k: v / steps for k, v in counts.items() if v}
    want = {"flash_attention": 2 * cfg.n_layers, "flash_attention[tensor_core]": 2 * cfg.n_layers}
    if per_step != want:
        fail(f"train: launches per step {per_step}, not {want} (forward and remat recompute, "
             "every one on the tensor-core route)")
    step_ms = statistics.median(dts[2:])
    flops = train_flops(model, cfg, B, S)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed, branching=4)
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(steps).items()}
    split = split_launches(trainer.family, model, batch, cfg)
    prof = profiled_step(trainer, batch)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "batch": B, "seq": S, "steps": steps,
           "n_params": sum(p.numel() for p in model.parameters()), "losses": losses,
           "step_ms": dts, "warm_step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "mfu": flops / (step_ms / 1e3) / PEAK_BF16, "mfu_peak": "bf16 dense 989 TFLOP/s",
           "peak_gib": peak, "wall_s": wall, "launches_per_step": per_step,
           "launch_split": split, "profiled_step": prof}
    top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof["top"][:5])
    print(f"  train {cfg.name} full ({cfg.n_layers} layers, bf16, {B} x {S}): losses "
          f"{[round(x, 4) for x in losses]}; warm step {step_ms:.1f} ms (median of steps 3-"
          f"{steps}), {out['tokens_per_s']:.0f} tokens/s, {flops / 1e12:.2f} model TFLOP a step, "
          f"MFU {out['mfu']:.2%} of bf16 989 TFLOP/s; peak {peak:.2f} GiB; launches per step "
          f"{per_step}, split {split}; profiled step: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.1%}): {top}", flush=True)
    del trainer, model
    return out


class _Repeat:
    """A source that gives its first batch at every step."""

    def __init__(self, source):
        self.source = source

    def batch_at(self, step):
        return self.source.batch_at(0)


def learning_gate(seed: int) -> dict:
    """qwen1.5-0.5b, full width and depth, bf16: LEARN_STEPS steps on one
    repeated batch must lower the loss by at least LEARN_DROP nats."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("qwen1_5_0_5b")
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=LEARN_LR), warmup=2,
                                         total_steps=LEARN_STEPS), device=DEVICE)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            seed=seed + 1, branching=4)
    trainer.fit(_Repeat(src), steps=LEARN_STEPS, seed=seed)
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    if not losses[-1] <= losses[0] - LEARN_DROP:
        fail(f"learning gate: loss {losses[0]:.4f} -> {losses[-1]:.4f}, not {LEARN_DROP} lower")
    print(f"  learning gate ({LEARN_STEPS} steps on one batch, lr {LEARN_LR}): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (at least {LEARN_DROP} nats lower)", flush=True)
    del trainer
    return {"losses": losses, "lr": LEARN_LR}


def resume_gate(seed: int) -> dict:
    """qwen1.5-0.5b at full width, RESUME_LAYERS layers, f32: 4 steps, a
    checkpoint, and a new Trainer resumed to 8 equal 8 straight steps."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("qwen1_5_0_5b"), n_layers=RESUME_LAYERS,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=RESUME_TOKENS[1],
                            global_batch=RESUME_TOKENS[0], seed=seed + 2)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=1e-3), total_steps=100, ckpt_every=4)
    straight, _ = Trainer(cfg, tcfg, device=DEVICE).fit(src, steps=8, seed=seed, resume=False)
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        resumable = dataclasses.replace(tcfg, ckpt_dir=str(ck))
        t0 = time.perf_counter()
        Trainer(cfg, resumable, device=DEVICE).fit(src, steps=4, seed=seed, resume=False)
        again = Trainer(cfg, resumable, device=DEVICE)
        resumed, _ = again.fit(src, steps=8, seed=seed, resume=True)
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if again.metrics_log[0]["step"] != 5:
        fail(f"resume: the new trainer started at step {again.metrics_log[0]['step']}, not 5")
    worst = 0.0
    for (name, a), b in zip(resumed.named_parameters(), straight.parameters()):
        over = ((a - b).abs() - (1e-5 + 1e-4 * b.abs())).max().item()
        worst = max(worst, ((a - b).abs() / (1e-5 + 1e-4 * b.abs())).max().item())
        if over > 0:
            fail(f"resume: {name} differs from the straight run beyond rtol 1e-4, atol 1e-5")
    print(f"  exact resume ({cfg.n_layers} layers, f32, {RESUME_TOKENS[0]} x {RESUME_TOKENS[1]}): "
          f"8 steps with a checkpoint at 4 equal 8 straight steps (worst at {worst:.3e} of "
          f"rtol 1e-4 + atol 1e-5); checkpoints {ckpt_bytes / 2**30:.2f} GiB on disk, "
          f"{wall:.1f} s for the two resumable runs", flush=True)
    return {"n_layers": cfg.n_layers, "worst_ratio": worst, "ckpt_gib": ckpt_bytes / 2**30,
            "resumable_wall_s": wall}


def recurrent_training(seed: int, arch: str, n_layers: int, launches: dict) -> dict:
    """A recurrent family at full width, ``n_layers`` layers, bf16:
    RECURRENT_STEPS steps, each with the kernel ``launches`` given."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    B, S = RECURRENT_TOKENS
    wrappers = model_kernels()
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=3e-4), warmup=2,
                                         total_steps=RECURRENT_STEPS), device=DEVICE)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed, branching=4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    trainer.fit(src, steps=RECURRENT_STEPS, seed=seed)
    per_step = {k: v / RECURRENT_STEPS for k, v in launch_counts(wrappers).items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    if not all(map(math.isfinite, losses)):
        fail(f"{arch} training: losses {losses}")
    if per_step != launches:
        fail(f"{arch} training: launches per step {per_step}, not {launches}")
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    split = split_launches(trainer.family, trainer.state[0], batch, cfg)
    step_ms = statistics.median(dts[2:])
    print(f"  train {cfg.name} ({n_layers} layers, bf16, {B} x {S}): losses "
          f"{[round(x, 4) for x in losses]}; warm step {step_ms:.1f} ms (median of steps 3-"
          f"{RECURRENT_STEPS}); peak {peak:.2f} GiB; launches per step {per_step}, "
          f"split {split}", flush=True)
    out = {"arch": cfg.name, "n_layers": n_layers, "batch": B, "seq": S, "losses": losses,
           "step_ms": dts, "warm_step_ms": step_ms, "peak_gib": peak,
           "launches_per_step": per_step, "launch_split": split}
    del trainer
    return out


def training_phase(seed: int, gen) -> dict:
    """Phase 7; returns its numbers and the kernel gradients' rows."""
    t0 = time.perf_counter()
    print("[train] kernel gradients against autograd through the plain versions, f32 "
          "(flash also bf16)")
    grads = [run_grad_case(cs) for cs in grad_cases(gen)]
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] whole-model f32 gates, {GATE_TOKENS[0]} x {GATE_TOKENS[1]} tokens")
    gates = [model_grad_gate(seed, arch, depth, kernels) for arch, depth, kernels in TRAIN_GATES]
    gc.collect()
    torch.cuda.empty_cache()
    print("[train] launch/train.py at full width and depth")
    entry = train_entry(seed)
    gc.collect()
    torch.cuda.empty_cache()
    learn = learning_gate(seed)
    gc.collect()
    torch.cuda.empty_cache()
    resume = resume_gate(seed)
    gc.collect()
    torch.cuda.empty_cache()
    recurrent = [recurrent_training(seed, **spec) for spec in TRAIN_RECURRENT]
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[train] phase 7 took {wall:.1f} s")
    return {"kernel_grads": grads, "f32_gates": gates, "train": entry, "learning": learn,
            "resume": resume, "recurrent": recurrent, "wall_s": wall}


def _sha16(text: str) -> str:
    import hashlib

    return hashlib.sha256(text.encode()).hexdigest()[:16]


def fabric_fingerprints() -> dict:
    """The golden fingerprints, computed by the port as the reference's
    tests/test_program.py computes them (the deprecated shims included)."""
    import warnings

    from repro_torch.core import schedules as sched
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.traffic import (Trace, TrafficEvent, collective_storm,
                                              fcl_storm, mixed_storm, replay, summa_storm)
    from repro_torch.core.overlap import ag_matmul_noc_trace, matmul_rs_noc_trace
    from repro_torch.core.summa import summa_noc_trace, summa_program
    from repro_torch.core.topology import Coord, Mesh2D

    def events(evs):
        return _sha16(json.dumps([e.to_dict() for e in evs], sort_keys=True))

    def replayed(res):
        return _sha16(json.dumps([res.makespan, [s.done_cycle for s in res.streams],
                                  [round(s.inject_cycle, 6) for s in res.streams],
                                  res.phase_end]))

    row8 = [Coord(x, 0) for x in range(8)]
    row4 = [Coord(x, 0) for x in range(4)]
    mesh4, mesh8 = Mesh2D(4, 4), Mesh2D(8, 8)
    got = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for s in FABRIC_SCHEDULES:
            got[f"broadcast_{s}"] = events(sched.broadcast_noc_events(
                row8, 2, 8192, schedule=s, chunks=4, params=PAPER_MICRO))
            got[f"all_reduce_{s}"] = events(sched.all_reduce_noc_events(
                row8, 8192, schedule=s, params=PAPER_MICRO))
        got["summa4_native"] = _sha16(summa_noc_trace(mesh4, 2048, schedule="native").to_json())
        got["summa4_tree"] = _sha16(summa_noc_trace(mesh4, 2048, schedule="tree").to_json())
        got["summa16_native"] = _sha16(
            summa_noc_trace(Mesh2D(16, 16), 2048, schedule="native").to_json())
        got["ag_ring"] = _sha16(ag_matmul_noc_trace(mesh4, row4, 2048).to_json())
        got["rs_ring"] = _sha16(matmul_rs_noc_trace(mesh4, row4, 2048).to_json())
    got["summa_storm8"] = _sha16(summa_storm(mesh8, tile_bytes=2048, iters=2,
                                             interval=3.0).to_json())
    got["fcl_storm8"] = _sha16(fcl_storm(mesh8, tile_bytes=1024, phases=2).to_json())
    got["mixed_storm8"] = _sha16(mixed_storm(mesh8, phases=2).to_json())
    got["collective_storm8"] = _sha16(collective_storm(mesh8, tile_bytes=2048,
                                                       phases=2).to_json())
    gap = Trace(4, 4, [  # mixed kinds, sw + hw barriers, a phase-numbering gap
        TrafficEvent("unicast", phase=0, nbytes=1024, src=(0, 0), dst=(3, 0)),
        TrafficEvent("barrier", phase=0, dst=(0, 0), flavor="sw",
                     sources=tuple((x, 0) for x in range(4))),
        TrafficEvent("barrier", phase=1, dst=(0, 0), sources=tuple((x, 0) for x in range(4))),
        TrafficEvent("multicast", phase=3, nbytes=2048, src=(1, 1), dst=(0, 0),
                     x_mask=3, y_mask=3, start=2.5),
        TrafficEvent("reduction", phase=3, nbytes=512, dst=(2, 2),
                     sources=((0, 0), (1, 2), (3, 3))),
    ])
    summa4 = summa_program(mesh4, 2048, schedule="native").to_trace()
    for name, trace in (("summa4", summa4), ("gap", gap)):
        for mode in ("barrier", "window"):
            got[f"replay_{name}_{mode}"] = replayed(replay(trace, params=PAPER_MICRO, mode=mode))
    return got


def fabric_phase(walls: dict) -> dict:
    """Phase 8: the goldens, the paper's claims, phase 3's schedules as
    fabric programs beside its measured walls, and the overlap gate."""
    from repro_torch.core import schedules as sched
    from repro_torch.core.noc import calibrate
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.program import ProgramBuilder, run_program
    from repro_torch.core.overlap import ag_matmul_program, matmul_rs_program
    from repro_torch.core.summa import summa_program
    from repro_torch.core.topology import Coord, Mesh2D

    t0 = time.perf_counter()
    print("[fabric] the port's flit-level simulator on the host; cycles are the modelled "
          "fabric's (PAPER_MICRO), not the card's")
    want = {**GOLDEN_EMITTERS, **GOLDEN_TRACES, **GOLDEN_REPLAYS}
    got = fabric_fingerprints()
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad or len(got) != len(want):
        fail(f"fabric goldens differ (got, want): {bad}")
    print(f"  {len(want)} golden fingerprints reproduced (emitters, traces, replays)")

    claims = calibrate.all_claims()
    for c in claims:
        print(f"  claim {c.name}: paper {c.paper_value:g}, achieved {c.achieved:.4f}"
              f" {'ok' if c.ok else 'FAIL'}")
    failed = [c.name for c in claims if not c.ok]
    if failed:
        fail(f"paper claims not met: {failed}")

    def makespan(prog):
        return run_program(prog, PAPER_MICRO, mode="op").makespan

    def beside(kind, cycles, suffix):
        """Each schedule's simulated cycles and, for each baseline, the
        simulated native speed-up beside phase 3's warm-wall ratio."""
        card = {s: walls.get(f"{kind} {s} {suffix}", {}).get("ms") for s in cycles}
        rows = {}
        for s, cyc in cycles.items():
            rows[s] = {"cycles": cyc, "card_warm_ms": card[s]}
            line = f"  {kind} {s} {suffix}: {cyc:g} cycles"
            if s != "native":
                sim = cyc / cycles["native"]
                ratio = card[s] / card["native"] if card[s] and card["native"] else None
                rows[s].update(sim_speedup=sim, card_ratio=ratio)
                shown = f"{ratio:.3f}x" if ratio is not None else "not measured"
                line += f"; native {sim:.3f}x faster simulated, card warm wall {shown}"
            print(line)
        return rows

    mesh4, mesh8 = Mesh2D(4, 4), Mesh2D(8, 8)
    row8 = [Coord(x, 0) for x in range(8)]
    summa = beside("summa", {s: makespan(summa_program(mesh4, FABRIC_BYTES, schedule=s))
                             for s in FABRIC_SCHEDULES}, "4x4")
    print("  summa ring: no fabric emitter (the reference has none); card only")

    def all_reduce(s):
        b = ProgramBuilder(mesh8)
        sched.all_reduce_ops(b, row8, nbytes=FABRIC_BYTES, schedule=s)
        return makespan(b.build())

    fcl = beside("fcl", {s: all_reduce(s) for s in FABRIC_SCHEDULES}, "x8")
    rings = {}
    for name, prog in (("ag_matmul", ag_matmul_program(mesh8, row8, FABRIC_BYTES)),
                       ("matmul_rs", matmul_rs_program(mesh8, row8, FABRIC_BYTES))):
        rings[name] = {"cycles": makespan(prog), "card_warm_ms": walls.get(f"{name} x8", {}).get("ms")}
        print(f"  {name} ring of 8: {rings[name]['cycles']:g} cycles")

    prog = summa_program(Mesh2D(OVERLAP_SIDE, OVERLAP_SIDE), OVERLAP_TILE, iters=OVERLAP_ITERS,
                         compute_cycles="model")
    op = makespan(prog)
    barrier = run_program(prog, PAPER_MICRO, mode="barrier").makespan
    comm = makespan(prog.comm_only())
    comp = makespan(prog.compute_only())
    lower = max(comm, comp)
    overlap = {"op": op, "barrier": barrier, "comm_only": comm, "compute_only": comp,
               "overlap_ratio": barrier / op, "headroom_vs_lower_bound": op / lower}
    print(f"  overlap, SUMMA {OVERLAP_SIDE}x{OVERLAP_SIDE}, {OVERLAP_ITERS} iterations of "
          f"{OVERLAP_TILE} B with modelled compute: op {op:g} cycles, barrier {barrier:g} "
          f"({barrier / op:.4f}x), lower bound {lower:g} (op at {op / lower:.4f}x)")
    if not op < barrier:
        fail(f"per-op execution ({op}) does not beat the barrier form ({barrier})")
    if not op >= lower:
        fail(f"per-op makespan {op} below max(comm-only, compute-only) = {lower}")

    wall = time.perf_counter() - t0
    print(f"[fabric] phase 8 took {wall:.2f} s (budget {FABRIC_BUDGET_S:g} s)")
    if wall > FABRIC_BUDGET_S:
        fail(f"phase 8 took {wall:.1f} s, over its budget of {FABRIC_BUDGET_S:g} s")
    return {"units": "simulated cycles (PAPER_MICRO fabric), not card time",
            "goldens": len(want), "claims": {c.name: [c.paper_value, c.achieved]
                                              for c in claims},
            "tile_bytes": FABRIC_BYTES, "summa_4x4": summa, "fcl_all_reduce_x8": fcl,
            "rings_x8": rings, "overlap": overlap, "host_s": wall}


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
    print_ptxas(report)
    spills = kernel_spills(report)
    print(f"  gemm, wkv, mma.sync flash and rglru_scan kernels (registers, spill bytes; "
          f"0 spills expected): {spills}")
    spilled = {k: v for k, v in spills.items() if k.startswith(("flash_mma", "rglru"))
               and v.get("spill_bytes")}
    if spilled:
        fail(f"the flash or rglru_scan kernel spills: {spilled}")
    _build.library()
    mma = tensor_core_sass(path)
    print(f"  tensor-core instructions in the SASS (HGMMA, HMMA for flash_mma_kernel): {mma}")
    if not all(mma.values()):
        fail(f"a tensor-core kernel issues no HGMMA / HMMA: {mma}")

    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)

    # 2. Kernels against their plain versions.
    print("[kernels] against the plain versions, on the card")
    gemm_rows = [run_case(cs) for cs in gemm_cases(gen)]
    reduce_rows = [run_case(cs) for cs in reduce_cases(gen)]
    lsb_and_barrier()
    flash_rows = [run_case(cs) for cs in flash_cases(gen)]
    rglru_rows = [run_case(cs) for cs in rglru_cases(gen)]
    from repro_torch.kernels.rwkv6 import wkv_launch_info
    for dtype, hd in ((torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 32)):
        print(f"  wkv launch at hd {hd} {str(dtype).split('.')[-1]}: "
              f"{wkv_launch_info(dtype, hd)}")
    wkv_rows = [run_case(cs) for cs in wkv_cases(gen)]
    torch.cuda.empty_cache()

    # 3. The main path; only its launches count.
    print(f"[main path] yi-6b widths: d_model {D_MODEL}, {N_HEADS} heads x {HEAD_DIM}, "
          f"d_ff {D_FF}, {TOKENS} tokens")
    torch.cuda.reset_peak_memory_stats()
    gemm.launches = 0
    gemm.route_launches.update(dict.fromkeys(gemm.route_launches, 0))
    reduce_nway.launches = 0
    walls = main_path(gen)
    launches = {"gemm": gemm.route_launches["cuda_core"],
                "gemm_wgmma": gemm.route_launches["tensor_core"],
                "reduce_nway": reduce_nway.launches}
    print(f"  launches on the main path: {launches} (f32: the tensor-core gemm is on no "
          f"main path); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("gemm", "reduce_nway"):
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main path")
    torch.cuda.empty_cache()

    # 4-6. Serving yi-6b, recurrentgemma-2b and rwkv6-3b; only each one's
    # served requests' launches count, and each kernel's entry takes them from
    # the first model that serves through it.  flash_attention's mma_sync
    # route counts the f32 checks of that phase, its tensor-core route the
    # bf16 serve.
    serving = {}
    for spec in SERVES:
        served = serving[spec["arch"]] = serve_phase(args.seed, **spec)
        for name, n in served["launches"].items():
            if name in served["route_launches"]:
                f32_counts, bf16_counts = (served["f32_route_launches"][name],
                                           served["route_launches"][name])
                launches.setdefault(name, f32_counts["mma_sync"])
                launches.setdefault(name + "_wgmma", bf16_counts["tensor_core"])
            else:
                launches.setdefault(name, n)

    # 7. Training; its launches are gated inside the phase.
    training = training_phase(args.seed, gen)
    grad_rows = {(r["kernel"], r["route"]): r for r in training["kernel_grads"]}

    # 8. The fabric programs of the main path, on the host.
    fabric = fabric_phase(walls)

    # 9. Result lines.  Each route of a kernel is an entry of its own.
    def entry(name, source, replaces, rows, route=None):
        if route is not None:
            rows = [r for r in rows if r["route"] == route]
        main_row = rows[0]  # the main-path shape of this kernel
        return {"name": name, "route": "cuda", "kernel_route": route, "source": source,
                "replaces": replaces,
                "launches": launches[name], "max_abs_err": main_row["max_abs_err"],
                "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
                "bound_cuda_core_ms": main_row.get("bound_cuda_core_ms"),
                "library_ms": main_row["library_ms"], "case": main_row["case"],
                "grad": grad_rows.get((name.replace("_wgmma", ""), route)), "cases": rows}

    speedups(gemm_rows, flash_rows)
    kernels = [
        entry("gemm", "src/repro_torch/kernels/csrc/gemm.cu",
              "src/repro/kernels/gemm.py:48", gemm_rows, "cuda_core"),
        entry("gemm_wgmma", "src/repro_torch/kernels/csrc/gemm_wgmma.cu",
              "src/repro/kernels/gemm.py:48", gemm_rows, "tensor_core"),
        entry("reduce_nway", "src/repro_torch/kernels/csrc/reduce_nway.cu",
              "src/repro/kernels/reduce_nway.py:38", reduce_rows),
        entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:67", flash_rows, "mma_sync"),
        entry("flash_attention_wgmma", "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
              "src/repro/kernels/flash_attention.py:67", flash_rows, "tensor_core"),
        entry("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru.py:44", rglru_rows),
        entry("wkv", "src/repro_torch/kernels/csrc/wkv.cu",
              "src/repro/kernels/rwkv6.py:54", wkv_rows),
    ]
    print(json.dumps({"main_path": walls}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"fabric": fabric}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
