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
6a. serve moonshot-v1-16b-a3b (the capacity-routed MoE: 64 experts,
   top-6) in the same way, but for its f32 checks, which run at full
   width and 4 layers on a model built apart and freed before the full
   one (an f32 copy of all 48 layers would not fit the card): the count of
   (layer, token) routing choices that differ between the kernel run and
   the plain run is printed, and should a flip fail the logits gate, the
   plain run is repeated with the kernel run's routing pinned; the decode
   gate runs at ``capacity_factor=64`` (no drops), as the reference's own
   gate.  Then the bf16 serve at full depth (48 layers, 52.3 GiB of
   weights), twice, with ``flash_attention`` launched 48 times per prefill
   on its tensor-core route;
6b. phi3.5-moe at full width and 2 layers in f32: the same checks, no
   serve (84 GB in bf16 at full depth);
6c. whisper-base at full width and depth (6 encoder and 6 decoder layers
   over 1500 frames, 4 sequences): f32 prefill logits through
   ``flash_attention`` (the decoder's causal self-attention; the
   bidirectional encoder and the cross-attention are plain) against plain
   attention, decode at 447 against a prefill of 448 (whisper's text
   context), then in bf16 two greedy generations through ``prefill`` and
   ``decode_step`` (4 prompts of 416 tokens, 32 new), equal, with 6
   tensor-core launches per prefill;
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
   and rwkv6-3b (4 layers) at full width in bf16, 6 steps each, then at
   full depth (26 and 32 layers) 2 steps each, and whisper-base at full
   width and depth in bf16 (2 x 2048 tokens over 1500 frames, 6 steps,
   every flash launch on the tensor-core route); the f32
   gradient gates also of moonshot-v1-16b-a3b (2 layers, the plain run on
   the kernel run's expert choices, flips counted) and whisper-base (full
   depth, 1500 frames, 448 tokens), each printing its worst leaf;
8. the fabric programs of the main path, on the host, through the port's
   own copy of the NoC substrate (program IR, flit-level simulator):
   reproduce the 21 golden fingerprints of the legacy emitters, traces and
   replays; check every numeric claim of the paper (``all_claims``); emit
   phase 3's schedules as programs at 32 KiB (SUMMA on 4x4, FCL's
   all-reduce, ``ag_matmul`` and ``matmul_rs`` over a row of 8) and print
   their simulated cycles and native-over-baseline speed-ups beside phase
   3's measured warm-wall ratios (printed, held to nothing); the overlap
   gate (the 8x8 SUMMA with modelled compute beats its barrier form and
   stays at or above max(comm-only, compute-only)); then the simulator's
   runtime half at the reference's largest documented sizes, each result
   pinned to the reference's: the 64x64 collective storm on ``heap``,
   ``shard:1x2:1`` and ``shard::W`` (W = min(4, CPUs)) and the 128x128
   storm on ``shard::W`` and ``shard:1x2:1``, whose run pauses at half its
   makespan to write a checkpoint that is restored and resumed on
   ``shard::W`` to the uninterrupted run; a mid-run link fault on the
   16x16 storm; a Collector on a 16x16 transpose, equal on ``heap`` and
   ``shard:2x2:W``; and a sweep through a ``SimulationServer`` with 2 fork
   workers, cold, warm (memo hits) and after a restart on its store (store
   hits).  A shard run that asked for fork workers fails if it had fewer,
   or respawned, retried or degraded one; all within ``FABRIC_BUDGET_S``
   of host time;
9. data-parallel training: (9a) qwen1.5-0.5b at full width and depth in
   bf16 on a stacked mesh of 4 members on the card (4 x 2048 tokens, one
   sequence a member), int8-compressed gradients (``compressed_mean``: one
   ``reduce_nway`` pmax per reference leaf), 12 steps on one repeated
   batch: phase 7's learning gate on member 0's loss, at least ``DP_KEEP``
   of the uncompressed one-card trainer's reduction of the whole batch's
   loss, 192
   tensor-core flash launches a step; step time, tokens/s, peak, the idle
   share of a profiled step, the int8 payload; (9b) ``compressed_mean`` on
   9a's gradient shapes bit-equal to its plain version, with its device
   time and launches; (9c) the rank mesh under NCCL at world size 1
   (``file://`` rendezvous in a temporary directory): every axis function
   and 2 DP trainer steps (2 layers, f32) equal to the stacked mesh's;
   (9d) ``largest_pow2_mesh`` over 8 and 5 members, qwen's parameters
   re-meshed (4, 2) -> (2, 2) under ZeRO-1 specs and back bit-equal, and
   each member's loss at 2 layers finite, their mean the whole batch's;
10. model-parallel serving: (10a) yi-6b at full width and depth on a
   stacked ("data", "model") = (2, 4) mesh, tensor-parallel (weights laid
   out by ``shard_model`` under ``make_policy``, replicated over "data"),
   and (10b) moonshot-v1-16b-a3b at full width and depth on (1, 4),
   expert-parallel (16 experts and 4 heads a member, the dispatch and
   combine ``all_to_all``): each with f32 checks at ``TP_CHECK_LAYERS`` on
   a model built apart (sharded against unsharded prefill logits and a
   decode after it, within SERVE_RTOL of max|logits|; moonshot at
   capacity_factor 64 with its routing flips counted), then phase 4's
   requests in bf16 twice, equal, ``reduce_nway`` launched, every prefill's
   flash launches on the tensor-core route, the peak under ``TP_PEAK_GIB``;
   the tokens that agree with phase 4's serve (printed, not gated), rows
   dropped by member in an untimed prefill, a profiled prefill and decode
   step beside the unsharded phase's, and the psum (first held against the
   plain f32 sum at the bf16 activation's and the f32 aux's shapes) and
   ``all_to_all`` device ms beside their byte bounds; (10c) the rank mesh
   under NCCL at world size 1: ``all_to_all`` and a dense and an MoE
   sharded smoke prefill equal to the stacked mesh's;
11. model-parallel training: (11a) qwen1.5-0.5b at full width and depth in
   bf16 on a stacked (2, 4) ("data", "model") mesh, sequence-parallel,
   through ``Trainer(policy=, mesh=)``: 12 steps of 4 x 2048 tokens on one
   repeated batch, phase 7's learning gate, 48 tensor-core flash launches a
   step, ``reduce_nway`` launched by the backward pass (counted apart from
   the forward's), the peak under ``MP_PEAK_GIB``; step time, tokens/s,
   MFU, peak and the idle share of a profiled step beside phases 7 and 9a,
   the launches split into forward, recompute, backward and the copies'
   sum, and the backward's sum at this shape (held against the plain sum,
   timed beside its byte bound and ``torch.sum``); (11b) the f32 gradient
   gates at full width and 2 layers, each global gradient leaf against the
   unsharded model's within TRAIN_RTOL of its max|g|: qwen on (2, 4) with
   sequence parallelism off and on, moonshot-v1-16b-a3b on (1, 4)
   expert-parallel at capacity_factor 64 (the cross-entropy; routing pinned
   to the sharded run's, flips counted); then moonshot at 2 layers in bf16,
   sharded, 4 steps; (11c) the rank mesh under NCCL at world size 1: a
   smoke config's sharded loss, gradients and 2 trainer steps (losses and
   parameters) bit-equal to the stacked mesh's, the first step's global
   norm and clip scale printed as hex floats;
12. sharded serving and training of the other three families, each laid
   out by ``shard_model`` under ``make_policy`` on a stacked ("data",
   "model") mesh: (12a) recurrentgemma-2b on (2, 4), rwkv6-3b on (1, 4) and
   whisper-base on (2, 4), each with f32 gates at full width on a model
   built apart (the hybrid at 3 layers, rwkv6 at 4, whisper at full
   depth: sharded prefill logits with sequence parallelism off and on, and
   a decode step after each, within SERVE_RTOL of max|logits| of the
   unsharded model's), then the bf16 serve at full depth twice, equal
   (the hybrid and rwkv6: phase 4's requests through ``Server(policy=,
   mesh=)``; whisper: phase 6c's generation), with ``rglru_scan``, ``wkv``
   and tensor-core flash launched their counts a prefill, ``reduce_nway``
   launched, the peak under ``TP_PEAK_GIB``; prefill, decode, tokens/s,
   peak, a profiled prefill and decode step, and the hybrid's ``xw``
   gather and row-parallel psum beside their byte bounds; yi-6b's
   sequence-parallel prefill at ``TP_CHECK_LAYERS`` against the same
   without it; (12b) the f32 gradient gates on (2, 4), sequence
   parallelism off and on (the hybrid at 3 layers, rwkv6 at 2, whisper at
   full depth), each global gradient leaf within TRAIN_RTOL of its max|g|,
   then bf16 ``Trainer(policy=, mesh=)`` on (1, 4), sequence-parallel: the
   hybrid at 6 layers on one repeated batch with phase 7's learning gate,
   rwkv6 at 4 layers, 4 steps; (12c) the rank mesh under NCCL at world
   size 1: each family's smoke prefill, loss and gradients equal to the
   stacked mesh's;
13. the launch dry run (``launch/``): (13a) the nine cells of
   ``tests/progs/dryrun_smoke_prog.py`` at full size on the production
   mesh (16, 16), the train cells on (2, 16, 16) too, traced on the
   kernels' path (meta tensors, each kernel through its op): status,
   bottleneck, roofline fraction on the H100's constants, bytes a member,
   FLOPs, collective bytes by kind, predicted launches, trace seconds;
   every cell must trace with FLOPs and bytes above zero; (13b)
   qwen1.5-0.5b's ``train_4k`` at full width and depth cut to 8 x 2048 on a
   stacked (2, 4) mesh through ``build_cell``: 3 real bf16 steps (step ms,
   a profiled step's device busy and idle, peak), then the same cell
   traced, whose FLOPs must equal a ``FlopCounterMode`` count of a real
   step, whose input bytes a member (from the specs) the real inputs'
   over the members, and whose predicted ``flash_attention`` and
   ``reduce_nway`` launches a real step's counters; the H100 roofline
   terms and the predicted peak are printed beside the card's numbers;
   (13c) gemma3-12b at full width and 4 layers, f32, batch 1, a cache of
   32768 cut on its sequence over "data" on a stacked (4, 2) mesh: decode
   after a prefill within 1e-5 of max|logits| of the unsplit decode, its
   ms a step; (13d) yi-6b at full width and 4 layers, one bf16 prefill of
   4 x 2048 with ``attn_bf16_logits`` (the plain bf16-logit path) and
   without it (the wgmma flash route), logits within 2e-2 of max|logits|,
   both prefill ms and peaks;
14. the port's examples (``src/repro_torch/examples``): ``quickstart``,
   ``fault_tolerance`` and ``distributed_gemm`` in this process through
   ``main(["--device", "cuda"])``, each with the kernel counters set to 0
   before it and read after (``flash_attention`` on its ``mma_sync`` route
   for the first two, ``gemm`` on its CUDA-core route and ``reduce_nway``
   for the third must have launched), and ``collective_schedules``,
   ``telemetry`` and ``service`` as ``python -m`` subprocesses under a
   timeout (exit 0); each is gated on its pinned lines (the reference's
   cycles, bytes and rows), quickstart on a loss a nat below ln(vocab) and
   12 in-vocabulary tokens, fault_tolerance on its checkpoint steps,
   distributed_gemm on every max_err within 2e-4; SUMMA's us a call is
   printed per schedule;
15. print the ``{"training": ...}`` line, the ``{"fabric": ...}`` line, the
   ``{"data_parallel": ...}`` line, the ``{"model_parallel": ...}`` line,
   the ``{"model_parallel_training": ...}`` line, the
   ``{"model_parallel_families": ...}`` line, the ``{"launch": ...}`` line,
   the ``{"examples": ...}`` line, the ``{"kernels": [...]}``
   line, one entry per route of each kernel (with its gradient's method and
   times where it has one, and its launches in each model's phase,
   ``launches_by_model``), and, last, the ``{"ok": true, ...}`` line.

It exits non-zero, printing no result, when no CUDA card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
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
    # The MoE transformers (phases 6a-6b): moonshot's f32 checks at 4 of its
    # 48 layers (an f32 copy of the full model, 112 GB, would not fit the
    # card), then its bf16 serve at full depth (52.3 GiB of weights);
    # phi3.5-moe (84 GB in bf16 at full depth) only its f32 checks at 2.
    dict(arch="moonshot_v1_16b", kernels={"flash_attention": 48}, gate=WAVE, check_layers=4),
    dict(arch="phi3_5_moe", kernels={"flash_attention": 32}, gate=WAVE, check_layers=2,
         serve=False),
)
# whisper-base (phase 6c): 4 sequences over the encoder's 1500 frames, the
# decode gate at the last position of its text context (n_text_ctx = 448,
# arXiv:2212.04356), and generation of MAX_NEW tokens after prompts that
# end MAX_NEW short of it.
WHISPER_SEQS, WHISPER_TEXT_CTX = 4, 448
WHISPER_PROMPT = WHISPER_TEXT_CTX - MAX_NEW
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
# moonshot-v1-16b-a3b's gate takes the kernel run's expert choices in the
# plain run (a router near-tie tipped by the kernel's rounding moves a
# token to another expert, whose gradient then differs by that token's
# share); the flips are counted.  whisper-base runs at full depth over its
# 1500 frames with a full text context of 448 tokens.
GATE_TOKENS = (1, 1024)
TRAIN_RTOL = 1e-3
TRAIN_GATES = (("qwen1_5_0_5b", 2, ("flash_attention",)),
               ("recurrentgemma_2b", 3, ("rglru_scan", "flash_attention")),
               ("rwkv6_3b", 2, ("wkv",)),
               ("moonshot_v1_16b", 2, ("flash_attention",)),
               ("whisper_base", None, ("flash_attention",)))
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
# The same at full depth, 2 steps each (checks, not timings): the hybrid's
# 26 layers are 18 recurrent and 8 attention, rwkv6 has 32.  Their f32 AdamW
# moments are 26.5 and 23.1 GB (3.31 and 2.88 B parameters); the trainer
# donates the old moments to the update, or the hybrid's would not fit.
RECURRENT_FULL_STEPS = 2
TRAIN_RECURRENT_FULL = (
    dict(arch="recurrentgemma_2b", n_layers=26, steps=RECURRENT_FULL_STEPS,
         launches={"rglru_scan": 54, "rglru_scan[backward]": 18, "flash_attention": 16,
                   "flash_attention[tensor_core]": 16}),
    dict(arch="rwkv6_3b", n_layers=32, steps=RECURRENT_FULL_STEPS, launches={"wkv": 64}),
)
# whisper-base at full width and depth in bf16 through Trainer._step_fn (its
# loss takes frames, which the token sources of Trainer.fit do not give):
# B sequences of 1500 random frames and S tokens, on one repeated batch.
WHISPER_TRAIN_TOKENS, WHISPER_TRAIN_STEPS = (2, WAVE), 6
# Data-parallel training (phase 9).  9a: qwen1.5-0.5b at full width and
# depth in bf16 on a stacked ("data",) mesh of 4 members on the card, one
# sequence of 2048 tokens each, int8-compressed gradients, phase 7's learning
# gate (LEARN_STEPS on one repeated batch, LEARN_DROP nats), and after it
# the whole batch's loss against the uncompressed one-card trainer's from
# the same weights on the same batches: the compressed run must keep at
# least DP_KEEP of the one-card run's loss reduction.  (The reference's tiny
# gate, |difference| < 0.5 after 40 steps, holds on the CPU; at full width
# the compressed run falls behind: 3.07 of 3.98 nats, a 0.92-nat gap, on
# an H100 80GB HBM3 at 700 W.  Likely cause, not measured: one int8 scale
# per layer-stacked leaf rounds a quiet layer's elements to 0 until their
# residual builds up.)  9b: compressed_mean on 9a's gradient shapes,
# bit-equal to its plain version.  9c: the rank mesh under NCCL at world size 1 (NCCL
# refuses two ranks on one card), equal to the stacked mesh, then the DP
# trainer at DP_RANK_LAYERS layers in f32 for 2 steps.  9d: elastic
# re-mesh of 8 stacked members to the 5 survivors' (2, 2), qwen's
# parameters round-tripped bit-equal, one loss at 2 layers on the new mesh.
DP_MEMBERS, DP_KEEP = 4, 0.5
DP_RANK_LAYERS, DP_RANK_TOKENS = 2, (1, WAVE)
ELASTIC_LAYERS, ELASTIC_TOKENS = 2, (2, WAVE)
# Model-parallel serving (phase 10), each model on a stacked ("data",
# "model") mesh on the card, laid out by shard_model under make_policy:
# yi-6b tensor-parallel over (2, 4) (weights replicated over "data"), and
# moonshot-v1-16b-a3b expert-parallel over (1, 4) (16 of its 64 experts and
# 4 of its 16 heads a member).  The f32 checks at TP_CHECK_LAYERS on a
# model built apart: sharded against unsharded prefill logits and a decode
# after it, within SERVE_RTOL of max|logits| (the MoE at capacity_factor
# 64, where the expert-parallel MoE drops no row and equals the local one);
# then phase 4's requests at full depth in bf16, twice, equal.  The peak
# must stay under TP_PEAK_GIB (moonshot's 52.3 GiB of weights are on the
# card once).  10c: the rank mesh under NCCL at world size 1.
TP_SERVES = (
    dict(arch="yi_6b", mesh=(2, 4), tag="tp yi-6b (2,4)"),
    dict(arch="moonshot_v1_16b", mesh=(1, 4), tag="ep moonshot (1,4)"),
)
TP_CHECK_LAYERS, TP_PEAK_GIB = 4, 60.0
TP_RANK_TOKENS = (2, 64)
# Model-parallel training (phase 11).  11a: qwen1.5-0.5b at full width and
# depth in bf16 on a stacked ("data", "model") = MP_MESH mesh on the card,
# sequence-parallel (make_policy(seq_parallel=True)), through
# Trainer(policy=, mesh=): phase 7's batch (TRAIN_BATCH x TRAIN_SEQ) and
# learning gate (LEARN_STEPS on one repeated batch, LEARN_DROP nats),
# reduce_nway launched by the backward pass (the transposes of the
# sequence gathers and of the loss's psums), the tensor-core flash
# launches a step (the 8 members' heads in one launch a layer, forward and
# remat recompute), the peak under MP_PEAK_GIB.  11b: the f32 gradient
# gates at full width and MP_GATE_LAYERS layers, each global gradient leaf
# (the copies' shares summed) against the unsharded model's within
# TRAIN_RTOL of its max|g| (phase 7's gate): qwen on MP_MESH with sequence
# parallelism off and on; moonshot-v1-16b-a3b on MP_MOE_MESH,
# expert-parallel at capacity_factor 64 (the cross-entropy's gradients:
# the aux loss is averaged over the members' token slices, as the
# reference's, so it is not the unsharded model's), with the unsharded
# run's routing pinned to the sharded run's and the flips counted; then
# moonshot at MP_GATE_LAYERS layers in bf16, sharded, MP_MOE_STEPS steps.
# 11c: the rank mesh under NCCL at world size 1, MP_RANK_STEPS sharded
# steps of a smoke config equal to the stacked mesh's.
MP_MESH, MP_MOE_MESH, MP_PEAK_GIB = (2, 4), (1, 4), 72.0
MP_GATE_LAYERS, MP_GATE_TOKENS = 2, (2, 1024)
MP_MOE_STEPS, MP_RANK_STEPS = 4, 2
# Sharded execution of the other three families (phase 12), each on a
# stacked ("data", "model") mesh on the card under make_policy.  12a: the
# f32 gates on a model built apart at full width and FAMILY_SERVES'
# check_layers (None: full depth; the hybrid's 3 hold one attention layer):
# the sharded prefill logits, with sequence parallelism off and on, and a
# decode step after each, within SERVE_RTOL of max|logits| of the
# unsharded model's; yi-6b's sequence-parallel prefill at TP_CHECK_LAYERS
# against the same without it; then the bf16 serve at full depth (the
# hybrid and rwkv6: phase 4's requests through Server(policy=, mesh=);
# whisper: phase 6c's generation through prefill / decode_step), twice,
# equal, each kernel launched its count a prefill, the peak under
# TP_PEAK_GIB.  12b: the f32 gradient gates on FAMILY_GRAD_MESH at
# FAMILY_GRAD_LAYERS (each global leaf within TRAIN_RTOL of its max|g|),
# sequence parallelism off and on; then bf16 Trainer(policy=, mesh=) runs
# on FAMILY_TRAIN_MESH, sequence-parallel, on phase 7's RECURRENT_TOKENS:
# the hybrid at 6 layers, LEARN_STEPS steps on one repeated batch with
# phase 7's learning gate; rwkv6 at 4 layers, 4 steps.  (1, 4) keeps the
# laid-out AdamW state at one copy of the model.  12c: the rank mesh under
# NCCL at world size 1, each family's smoke config equal to the stacked
# mesh.  The phase aims at FAMILY_BUDGET_S.
FAMILY_SERVES = (
    dict(arch="recurrentgemma_2b", mesh=(2, 4), tag="tp recurrentgemma-2b (2,4)",
         check_layers=3, kernels={"rglru_scan": 18, "flash_attention": 8}),
    dict(arch="rwkv6_3b", mesh=(1, 4), tag="tp rwkv6-3b (1,4)", check_layers=4,
         kernels={"wkv": 32}),
    dict(arch="whisper_base", mesh=(2, 4), tag="tp whisper-base (2,4)", check_layers=None,
         kernels={"flash_attention": 6}),
)
FAMILY_GRAD_MESH, FAMILY_TRAIN_MESH = (2, 4), (1, 4)
FAMILY_GRAD_LAYERS = {"recurrentgemma_2b": 3, "rwkv6_3b": 2, "whisper_base": None}
FAMILY_TRAIN = (dict(arch="recurrentgemma_2b", n_layers=6, steps=LEARN_STEPS, learn=True),
                dict(arch="rwkv6_3b", n_layers=4, steps=4, learn=False))
FAMILY_BUDGET_S = 150.0
# the served tokens of phases 4-6a whose full model drew the seed's first
# weights (phase 10 builds the same model), for phase 10's agreement count
SERVED_TOKENS = {}
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
# The simulator's runtime half (phase 8) at the reference's largest documented
# sizes: the collective storm of benchmarks/bench_engine.py (storm64, storm128:
# one phase of 2 KiB tiles) on the heap and region-sharded engines, a 128x128
# checkpoint and resume, bench_resilience.py's mid-run fault (16x16 storm, the
# link (7,8)->(8,8) dies at a third of the pristine makespan), a Collector on
# bench_telemetry.py's 16x16 transpose (xy, 2 VCs) and bench_service.py's grid
# through a SimulationServer.  The pinned numbers are the reference's results,
# which tests/test_torch_noc_copies.py recomputes with repro.
STORM_TILE = 2048
FABRIC_PINNED = {
    "storm64_makespan": 147,
    "storm128_makespan": 211,
    "storm128_snapshot_sha256": "534e9ff1cf63f427",
    "midrun_pristine": 99,
    "midrun_static": 154,
    "midrun_fault": 134,
    "midrun_relowered": 1,
    "midrun_dropped": 0,
    "telemetry_peak_utilization": 0.8664,
}
TELEMETRY_CASE = {"pattern": "transpose", "rate": 0.18, "nbytes": 256, "packets_per_node": 8,
                  "seed": 0}
SERVICE_GRID = {"mesh": (8, 8), "pattern": "transpose",
                "rates": [0.02, 0.04, 0.06, 0.08, 0.1, 0.12], "packets_per_node": 4, "seed": 7}
# Phase 8 took 45.5-51.6 host s on an H100 machine's 8 CPUs; the budget is
# twice the slowest, a bound that catches a hung server or fork worker
# without failing on a noisy host.  A worker the supervisor finds wedged
# (after its 60 s op deadline) fails the phase through the respawn check.
FABRIC_BUDGET_S = 105.0
# Phase 14: the port's examples (src/repro_torch/examples).  The three that
# touch the card run in this process through main(["--device", "cuda"]),
# each with the kernel counters set to 0 before it and read after; the
# three host-only ones run as `python -m` subprocesses under a timeout.
# Each is gated as the CPU tests gate it (tests/test_torch_examples_*.py):
# the lines pinned below (the reference's numbers: examples/*.py on the
# host), quickstart's last loss a nat below ln(vocab), fault_tolerance's
# checkpoint steps, distributed_gemm's max_err within the main-path 2e-4.
EXAMPLES_CARD = {"quickstart": ("flash_attention[mma_sync]",),
                 "fault_tolerance": ("flash_attention[mma_sync]",),
                 "distributed_gemm": ("gemm[cuda_core]", "reduce_nway")}
EXAMPLES_HOST = ("collective_schedules", "telemetry", "service")
EXAMPLE_PINNED = {
    "distributed_gemm": ("per-op gated (comm/compute overlap): 2183 cycles",
                         "barrier-serialized baseline:         2446 cycles  (1.12x slower)",
                         "comm-only 361 / compute-only 2091 cycles"),
    "fault_tolerance": ("storm completes degraded: makespan 91 -> 158 (1.74x)",
                        "surviving 4x8 submesh at (0,0)",
                        "24-unicast workload, makespan 200",
                        "checkpoint at cycle 100 (28754 bytes, sha256 cc913ce65598",
                        "makespan 200 -> 207",
                        "respawned 1x, replayed its epoch log, makespan 200"),
    "collective_schedules": ("     1Ki      302      302      216       71     3.04       tree",
                             "simulator: 570 cycles; model: 570 cycles",
                             "10 ops, makespan 808 cycles"),
    "telemetry": ("makespan 561, 30720 busy beats",
                  "makespan 561 -> 629, peak link utilization 0.114 -> 0.203"),
    "service": ("bit-identical to saturation_sweep: OK",
                "rate 0.02 -> mean latency 74.2 cycles", "rate 0.12 -> mean latency 91.5 cycles",
                "rows on disk: 3", "resumed and completed: 6 rows, 3 served from the store, "
                "3 computed after restart", "authenticated TCP client: 2 rows"),
}
EXAMPLE_TIMEOUT_S, EXAMPLES_AIM_S = 150, 120.0
EXAMPLE_RTOL = 2e-4


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
        # phase 6a's moonshot wave (4 sequences x 16 heads of 128), and
        # phase 6c's whisper decoder (4 x 8 heads of 64; its bf16 prompts
        # and f32 text context)
        case(4 * 16, WAVE, 128, 0, bf16, BF16_RTOL, 20, atol=1e-5),
        case(4 * 8, WHISPER_PROMPT, 64, 0, bf16, BF16_RTOL, 20, atol=1e-5),
        case(4 * 8, WHISPER_TEXT_CTX, 64, 0, f32, 1e-4, 20),
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
    return {"device_ms": busy, "launches": sum(r[2] for r in rows), "top": short[:6]}


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


def build_model(fam, cfg, gen, tag: str = "serve"):
    """``fam.init`` on the card; prints the model's shape; returns (model, n_params)."""
    t0 = time.perf_counter()
    model = fam.init(gen, cfg, DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim} (kv {cfg.n_kv_heads}), d_ff {cfg.d_ff}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts else "")
          + (f", {cfg.encoder_layers} encoder layers over {cfg.encoder_len} frames"
             if cfg.encoder_layers else "")
          + f", vocab {cfg.vocab}; {n_params / 1e9:.3f} B parameters in "
          f"{str(cfg.param_dtype).split('.')[-1]}, initialised in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return model, n_params


def logits_check(out: dict, key: str, name: str, got, ref, gate: bool = True) -> bool:
    """``got`` within SERVE_RTOL x max|ref| of ``ref``: records the numbers
    in ``out[key]``; fails, or returns False when not ``gate``."""
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, or not finite")
    err = rel_err(got, ref)[0]
    scale = ref.abs().max().item()
    ok = err <= SERVE_RTOL * scale
    if not ok and gate:
        fail(f"{name}: max_abs_err {err:.3e} above {SERVE_RTOL} x max|logits| {scale:.3e}")
    print(f"  {name}: max_abs_err {err:.3e}, max|logits| {scale:.3e} "
          f"(ratio {err / scale:.3e} {'<=' if ok else 'above'} {SERVE_RTOL})", flush=True)
    out[key] = {"max_abs_err": err, "max_abs": scale}
    return ok


@contextlib.contextmanager
def routing(replay=None):
    """Record each MoE layer's routing, ``(gate_vals, gate_idx, aux)`` in
    call order, into the list yielded; with ``replay`` (such a list), hand
    the router's callers those in place of its own."""
    from unittest import mock

    from repro_torch.models import mlp as mlp_mod

    real, record = mlp_mod._route, []

    def route(params, xf, cfg):
        got = real(params, xf, cfg) if replay is None else replay[len(record)]
        record.append(got)
        return got

    with mock.patch.object(mlp_mod, "_route", route):
        yield record


def routing_flips(a: list, b: list) -> int:
    """(layer, token) routing choices that differ between two records."""
    return sum(int((ra[1] != rb[1]).any(-1).sum()) for ra, rb in zip(a, b))


def profile_calls(out: dict, calls: dict):
    """A warm and a profiled run of each of ``calls`` (name -> fn, in order),
    into ``out["profiled_<name>"]``: walls, peak memory, device busy time
    and the idle share against the unprofiled warm wall (as in phase 3:
    the profiler's own host overhead stretches the profiled wall)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for name, fn in calls.items():
            walls = {}
            for run in ("warm", "profiled"):
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
                    if run == "profiled" else contextlib.nullcontext()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                with prof:
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[run] = (time.perf_counter() - t) * 1e3
                if run == "warm":
                    call_peak = torch.cuda.max_memory_allocated() / 2**30
            br = device_breakdown(prof)
            idle = 1 - br["device_ms"] / walls["warm"]
            top = ", ".join(f"{k} {ms:.2f} ms x{n}" for k, ms, n in br["top"])
            print(f"  {name}: warm wall {walls['warm']:.2f} ms (profiled {walls['profiled']:.2f}), "
                  f"peak device memory {call_peak:.2f} GiB, device busy {br['device_ms']:.2f} ms "
                  f"(idle {idle:.1%}): {top}", flush=True)
            out[f"profiled_{name}"] = {"wall_ms": walls["warm"], "idle_share": idle,
                                       "profiled_wall_ms": walls["profiled"],
                                       "peak_gib": call_peak, **br}


def serve_phase(seed: int, arch: str, kernels: dict, gate: int, check_layers: int = 0,
                serve: bool = True) -> dict:
    """One model at full width and depth: the f32 checks, then the bf16
    serve; returns its numbers.

    ``kernels`` maps each kernel on the model's path to its launches per
    prefill; ``gate`` is the decode gate's position.  ``check_layers`` cuts
    the f32 checks' model to that depth, built apart (and freed) before the
    full bf16 one, where an f32 copy of the full model would not fit the
    card; ``serve=False`` stops after the checks.  With experts, the
    decode gate runs at ``capacity_factor=64`` (no drops), as the
    reference's own gate does: capacity drops legitimately differ between
    a prefill batch and a decode batch.
    """
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_family
    from repro_torch.runtime.server import Request, Server

    wrappers = model_kernels()
    cfg = get_config(arch)
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers}

    # f32 checks: the kernels against their plain versions, and the cache gate.
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
                                n_layers=check_layers or cfg.n_layers)
    if check_layers:
        model32, out["check_params"] = build_model(fam, cfg32, gen, "f32 checks")
        out["check_layers"] = check_layers
    else:
        model, out["n_params"] = build_model(fam, cfg, gen)
        model32 = copy.deepcopy(model).to(torch.float32)
    per32 = {name: per * cfg32.n_layers // cfg.n_layers for name, per in kernels.items()}
    x = torch.randint(0, cfg.vocab, (SLOTS, max(WAVE, gate) + 1), generator=gen, device=DEVICE)

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
        with routing() as routed_kernel:
            logits, cache = fam.prefill(model32, x[:, :WAVE], cfg32, max_len=MAX_LEN)
        for name, per in per32.items():
            if wrappers[name].launches - before[name] != per:
                fail(f"f32 prefill launched {name} {wrappers[name].launches - before[name]} "
                     f"times, not {per}")
        with plain_kernels(kernels), routing() as routed_plain:
            plain_logits, _ = fam.prefill(model32, x[:, :WAVE], cfg32)
        name = (f"f32 prefill logits, {' + '.join(kernels)} vs plain, {SLOTS} x {WAVE}"
                + (f", {cfg32.n_layers} of {cfg.n_layers} layers" if check_layers else ""))
        # A kernel's f32 rounding (~1e-6 relative) can tip a near-tie in a
        # router's top-k, and a changed pick shifts the capacity ranks.
        flips = routing_flips(routed_kernel, routed_plain)
        if cfg.n_experts:
            out["routing_flips"] = flips
            print(f"  routing: {flips} of {len(routed_kernel)} x {SLOTS * WAVE} (layer, token) "
                  f"choices differ between the kernel and the plain run", flush=True)
        if not logits_check(out, "prefill_f32", name, logits, plain_logits, gate=not flips):
            # Pin the routing to the kernel run's, so that the check still
            # isolates the kernels.
            del plain_logits
            with plain_kernels(kernels), routing(replay=routed_kernel):
                plain_logits, _ = fam.prefill(model32, x[:, :WAVE], cfg32)
            out["prefill_f32_unpinned"] = out.pop("prefill_f32")
            logits_check(out, "prefill_f32", name + ", routing pinned to the kernel run's",
                         logits, plain_logits)
        del plain_logits, routed_kernel, routed_plain
        # With experts, no capacity drops in the gate (the reference's own gate).
        cfg_gate = dataclasses.replace(cfg32, capacity_factor=64.0) if cfg.n_experts else cfg32
        if gate != WAVE or cfg_gate is not cfg32:
            del cache
            _, cache = fam.prefill(model32, x[:, :gate], cfg_gate, max_len=gate + 1)
        dec = fam.decode_step(model32, cache, x[:, gate:gate + 1], gate, cfg_gate)[0]
        del cache
        full = fam.prefill(model32, x[:, :gate + 1], cfg_gate, max_len=gate + 1)[0]
        logits_check(out, "decode_gate_f32", f"f32 decode at {gate} vs prefill of {gate + 1}"
                     + (" (capacity_factor 64)" if cfg.n_experts else ""), dec, full)
    del model32, logits, dec, full
    f32_routes = {name: dict(w.route_launches) for name, w in routed.items()}
    for name, counts in f32_routes.items():
        if counts["tensor_core"] or not counts["mma_sync"]:
            fail(f"f32 checks launched {name} by route {counts}: f32 takes the mma_sync route")
    gc.collect()
    torch.cuda.empty_cache()
    if not serve:
        out["f32_route_launches"] = f32_routes
        return out
    if check_layers:
        model, out["n_params"] = build_model(fam, cfg, gen)

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
    state = {}

    def prefill():
        state["logits"], state["cache"] = fam.prefill(model, tokens, cfg, max_len=MAX_LEN)

    def decode():
        nxt = state["logits"].argmax(-1)[:, None]
        fam.decode_step(model, state["cache"], nxt, tokens.shape[1], cfg)

    profile_calls(out, {"prefill": prefill, "decode": decode})
    del state
    if not check_layers:  # the full model's weights were the seed's first draws
        SERVED_TOKENS[arch] = runs[0]["out"]
    for r in runs:
        del r["out"]
    out.update(runs=runs, launches=launches, route_launches=serve_routes,
               f32_route_launches=f32_routes, prefills=n_prefills, peak_gib=peak,
               resident_gib=resident, prompt_lens=[int(n) for n in lens])
    # The timed wrappers hold the server's bound methods: a reference cycle
    # that keeps the model alive until the collector runs.
    del model, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_phase(seed: int) -> dict:
    """whisper-base at full width and depth (phase 6c): the f32 checks, then
    two bf16 greedy generations driven through ``prefill`` and
    ``decode_step`` (the ``Server`` serves token prompts only); returns its
    numbers."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper as fam

    flash = model_kernels()["flash_attention"]
    cfg = get_config("whisper_base")
    per = cfg.n_layers  # the decoder's causal self-attention; the rest is plain
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    model32, n_params = build_model(fam, cfg32, gen, "whisper")
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
           "n_params": n_params}
    B, n_ctx, plen = WHISPER_SEQS, WHISPER_TEXT_CTX, WHISPER_PROMPT
    frames = torch.randn(B, cfg.encoder_len, cfg.d_model, generator=gen, device=DEVICE) * 0.1
    x = torch.randint(0, cfg.vocab, (B, n_ctx), generator=gen, device=DEVICE)

    def batch(tokens):
        return {"frames": frames, "tokens": tokens}

    zero_counts({"flash_attention": flash})
    with torch.inference_mode():
        logits, _ = fam.prefill(model32, batch(x), cfg32)
        if flash.launches != per:
            fail(f"whisper f32 prefill launched flash_attention {flash.launches} times, not {per}")
        with plain_kernels(["flash_attention"]):
            plain, _ = fam.prefill(model32, batch(x), cfg32)
        logits_check(out, "prefill_f32", f"f32 prefill logits, flash_attention vs plain, {B} x "
                     f"{n_ctx} tokens over {cfg.encoder_len} frames", logits, plain)
        gate = n_ctx - 1
        _, cache = fam.prefill(model32, batch(x[:, :gate]), cfg32, max_len=n_ctx)
        dec = fam.decode_step(model32, cache, x[:, gate:], gate, cfg32)[0]
        logits_check(out, "decode_gate_f32", f"f32 decode at {gate} vs prefill of {n_ctx}",
                     dec, logits)
    f32_routes = dict(flash.route_launches)
    if f32_routes != {"mma_sync": 2 * per, "tensor_core": 0}:
        fail(f"whisper f32 checks launched flash_attention by route {f32_routes}, not "
             f"{2 * per} on mma_sync")
    del model32, logits, plain, cache, dec
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: greedy generation of MAX_NEW tokens after prompts of plen, twice.
    model, _ = build_model(fam, cfg, gen, "whisper")
    prompts = torch.randint(0, cfg.vocab, (B, plen), generator=gen, device=DEVICE)
    times = {"prefill": [], "decode": []}

    def timed(key, fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        times[key].append((time.perf_counter() - t) * 1e3)
        return r

    def generate():
        logits, cache = timed("prefill", fam.prefill, model, batch(prompts), cfg,
                              max_len=n_ctx)
        toks = [logits[:, :cfg.vocab].argmax(-1)]
        for step in range(1, MAX_NEW):
            logits, cache = timed("decode", fam.decode_step, model, cache, toks[-1][:, None],
                                  plen + step - 1, cfg)
            toks.append(logits[:, :cfg.vocab].argmax(-1))
        return torch.stack(toks, 1).tolist()

    zero_counts({"flash_attention": flash})
    torch.cuda.reset_peak_memory_stats()
    runs, outs = [], []
    with torch.inference_mode():
        for run in ("cold", "warm"):
            for key in times:
                times[key] = []
            t = time.perf_counter()
            outs.append(generate())
            wall = (time.perf_counter() - t) * 1e3
            n_tok = B * MAX_NEW
            runs.append({"run": run, "wall_ms": wall, "tokens": n_tok,
                         "tokens_per_s": n_tok / wall * 1e3, "prefill_ms": times["prefill"][0],
                         "decode_ms_per_step": sum(times["decode"]) / len(times["decode"]),
                         "decode_steps": len(times["decode"])})
            print(f"  generate ({run}): {B} x {plen} prompt tokens over {cfg.encoder_len} frames, "
                  f"{n_tok} tokens in {wall:.1f} ms ({n_tok / wall * 1e3:.1f} tok/s); prefill "
                  f"{times['prefill'][0]:.2f} ms, decode {runs[-1]['decode_ms_per_step']:.2f} ms "
                  f"per step over {len(times['decode'])} steps", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if outs[0] != outs[1]:
        fail("whisper: a second generation gave other tokens")
    if not all(0 <= tok < cfg.vocab for o in outs[0] for tok in o):
        fail("whisper: a token outside [0, vocab)")
    launches, routes = flash.launches, dict(flash.route_launches)
    if launches != 2 * per or routes != {"mma_sync": 0, "tensor_core": 2 * per}:
        fail(f"whisper bf16 generation launched flash_attention {launches} times by route "
             f"{routes}, not {per} tensor-core launches per prefill")
    print(f"  generated twice, same tokens; flash_attention by route {routes} over 2 prefills "
          f"(f32 checks: {f32_routes}); peak device memory {peak:.2f} GiB", flush=True)
    state = {}

    def prefill():
        state["logits"], state["cache"] = fam.prefill(model, batch(prompts), cfg,
                                                      max_len=n_ctx)

    def decode():
        fam.decode_step(model, state["cache"], state["logits"].argmax(-1)[:, None], plen, cfg)

    profile_calls(out, {"prefill": prefill, "decode": decode})
    out.update(runs=runs, launches={"flash_attention": launches},
               route_launches={"flash_attention": routes},
               f32_route_launches={"flash_attention": f32_routes}, prefills=2, peak_gib=peak)
    del model, state
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


@contextlib.contextmanager
def pinned_routing(choices: list, flips: list):
    """The MoE router's expert choices taken from ``choices`` (``routing()``
    records, in call order), its gate values and aux loss recomputed from
    this run's probabilities, so that gradients flow as through the real
    router; each call appends to ``flips`` the count of tokens whose own
    choices differ."""
    from unittest import mock

    import torch.nn.functional as F

    from repro_torch.models import mlp as mlp_mod

    real, calls = mlp_mod._route, []

    def route(params, xf, cfg):
        own = real(params, xf, cfg)[1]
        idx = choices[len(calls)][1]
        calls.append(1)
        flips.append(int((own != idx).any(-1).sum()))
        probs = torch.softmax(xf.float() @ params["router"], dim=-1)
        vals = probs.gather(-1, idx)
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        ce = F.one_hot(idx.reshape(-1), cfg.n_experts).sum(0).float() / idx.numel()
        return vals, idx, cfg.n_experts * torch.sum(probs.mean(0) * ce)

    with mock.patch.object(mlp_mod, "_route", route):
        yield


def model_grad_gate(seed: int, arch: str, depth, kernels) -> dict:
    """One family at full width, ``depth`` layers (None: all), in f32: the
    loss and every parameter's gradient through the kernels against the
    plain versions, within TRAIN_RTOL of max|.| (of each leaf).  whisper
    takes random frames and its full text context; the MoE's plain run
    takes the kernel run's expert choices (``pinned_routing``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_family

    cfg = dataclasses.replace(get_config(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cfg = cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = fam.init(gen, cfg, DEVICE, trainable=True)
    B, S = (GATE_TOKENS[0], WHISPER_TEXT_CTX) if cfg.family == "whisper" else GATE_TOKENS
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=DEVICE)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "whisper":
        batch["frames"] = torch.randn(B, cfg.encoder_len, cfg.d_model, generator=gen,
                                      device=DEVICE) * 0.1
    params = list(model.parameters())
    wrappers = model_kernels()

    def value_and_grads():
        loss = fam.loss_fn(model, batch, cfg)
        return loss.item(), torch.autograd.grad(loss, params)

    moe = bool(cfg.n_experts)
    before = launch_counts(wrappers)
    with routing() if moe else contextlib.nullcontext() as choices:
        loss, grads = value_and_grads()
    launched = moved(before, launch_counts(wrappers))
    if not all(launched.get(k) for k in kernels):
        fail(f"{arch} f32 gate: launches {launched}, not every one of {kernels}")
    flips = []
    with plain_kernels(kernels), \
            pinned_routing(choices, flips) if moe else contextlib.nullcontext():
        plain_loss, plain_grads = value_and_grads()
    if not abs(loss - plain_loss) <= TRAIN_RTOL * abs(plain_loss):
        fail(f"{arch} f32 gate: loss {loss} against plain {plain_loss}")
    worst, worst_name = 0.0, None
    for (name, _), g, w in zip(model.named_parameters(), grads, plain_grads):
        err, scale = (g - w).abs().max().item(), w.abs().max().item()
        if not bool(torch.isfinite(g).all()) or not err <= TRAIN_RTOL * scale:
            fail(f"{arch} f32 gate: gradient of {name} off by {err:.3e}, max|g_plain| {scale:.3e}")
        if scale and err / scale >= worst:
            worst, worst_name = err / scale, name
    routed = f"; {sum(flips)} routing flips over {len(flips)} router calls" if moe else ""
    print(f"  {arch} ({cfg.n_layers} layers, f32, {B} x {S}): loss {loss:.6f} "
          f"(plain {plain_loss:.6f}); worst gradient leaf {worst_name} at {worst:.3e} of its "
          f"max|g_plain| (<= {TRAIN_RTOL}); launches {launched}{routed}", flush=True)
    out = {"arch": arch, "n_layers": cfg.n_layers, "tokens": [B, S], "loss": loss,
           "plain_loss": plain_loss, "worst_grad_rel": worst, "worst_leaf": worst_name,
           "launches": launched}
    if moe:
        out["routing_flips"] = sum(flips)
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


def split_launches(loss_of, params, wrappers=None) -> tuple[dict, tuple]:
    """Launches of one loss (``loss_of()``) and its gradient, by kernel: in
    the forward, in the backward's remat recompute, and by the backward
    itself; and the gradients of ``params``."""
    wrappers = wrappers or model_kernels()
    c0 = launch_counts(wrappers)
    loss = loss_of()
    c1 = launch_counts(wrappers)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    c2 = launch_counts(wrappers)
    out = {}
    for name in wrappers:
        fwd, during = c1[name] - c0[name], c2[name] - c1[name]
        bwd = c2.get(f"{name}[backward]", 0) - c1.get(f"{name}[backward]", 0)
        if fwd or during:
            out[name] = {"forward": fwd, "recompute": during - bwd, "backward": bwd}
    return out, grads


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
    split = split_launches(lambda: trainer.family.loss_fn(model, batch, cfg),
                           list(model.parameters()))[0]
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


def recurrent_training(seed: int, arch: str, n_layers: int, launches: dict,
                       steps: int = RECURRENT_STEPS) -> dict:
    """A recurrent family at full width, ``n_layers`` layers, bf16:
    ``steps`` steps, each with the kernel ``launches`` given."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    B, S = RECURRENT_TOKENS
    wrappers = model_kernels()
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=3e-4), warmup=2,
                                         total_steps=steps), device=DEVICE)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed, branching=4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    trainer.fit(src, steps=steps, seed=seed)
    per_step = {k: v / steps for k, v in launch_counts(wrappers).items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    if not all(map(math.isfinite, losses)):
        fail(f"{arch} training: losses {losses}")
    if per_step != launches:
        fail(f"{arch} training: launches per step {per_step}, not {launches}")
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    split = split_launches(lambda: trainer.family.loss_fn(trainer.state[0], batch, cfg),
                           list(trainer.state[0].parameters()))[0]
    warm = dts[2:] or dts[-1:]
    step_ms = statistics.median(warm)
    print(f"  train {cfg.name} ({n_layers} layers, bf16, {B} x {S}): losses "
          f"{[round(x, 4) for x in losses]}; warm step {step_ms:.1f} ms (median of steps "
          f"{steps - len(warm) + 1}-{steps}); peak {peak:.2f} GiB; launches per step "
          f"{per_step}, split {split}", flush=True)
    out = {"arch": cfg.name, "n_layers": n_layers, "batch": B, "seq": S, "losses": losses,
           "step_ms": dts, "warm_step_ms": step_ms, "peak_gib": peak,
           "launches_per_step": per_step, "launch_split": split}
    del trainer
    return out


def whisper_training(seed: int) -> dict:
    """whisper-base at full width and depth in bf16: WHISPER_TRAIN_STEPS
    optimizer steps on one repeated batch (random frames and tokens), finite
    losses, every flash launch on the tensor-core route."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("whisper_base")
    B, S = WHISPER_TRAIN_TOKENS
    wrappers = model_kernels()
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=3e-4), warmup=2,
                                         total_steps=WHISPER_TRAIN_STEPS), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    _, _, batch = family_inputs(cfg, gen, B, S)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt_state, err_state = trainer.init_state(seed)
    zero_counts(wrappers)
    losses, dts = [], []
    for _ in range(WHISPER_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt_state, err_state, metrics = trainer._step_fn(model, opt_state, batch,
                                                                err_state)
        losses.append(float(metrics["loss"]))
        dts.append((time.perf_counter() - t) * 1e3)
    per_step = {k: v / WHISPER_TRAIN_STEPS for k, v in launch_counts(wrappers).items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    flash = per_step.get("flash_attention", 0)
    if not all(map(math.isfinite, losses)):
        fail(f"whisper bf16 training: losses {losses}")
    if not flash or per_step.get("flash_attention[tensor_core]") != flash:
        fail(f"whisper bf16 training: flash launches a step {per_step}, not all on the "
             "tensor-core route")
    step_ms = statistics.median(dts[2:])
    print(f"  train {cfg.name} (full depth, bf16, {B} x {S} tokens, {cfg.encoder_len} frames): "
          f"losses {[round(x, 4) for x in losses]}; warm step {step_ms:.1f} ms (median of "
          f"steps 3-{WHISPER_TRAIN_STEPS}); peak {peak:.2f} GiB; launches per step {per_step}",
          flush=True)
    del trainer, model, opt_state, err_state
    return {"arch": cfg.name, "batch": B, "seq": S, "frames": cfg.encoder_len,
            "losses": losses, "step_ms": dts, "warm_step_ms": step_ms, "peak_gib": peak,
            "launches_per_step": per_step}


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
    print("[train] checks at full depth: the recurrent families, whisper-base in bf16")
    recurrent_full = []
    for spec in TRAIN_RECURRENT_FULL:
        recurrent_full.append(recurrent_training(seed, **spec))
        gc.collect()
        torch.cuda.empty_cache()
    whisper = whisper_training(seed)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[train] phase 7 took {wall:.1f} s")
    return {"kernel_grads": grads, "f32_gates": gates, "train": entry, "learning": learn,
            "resume": resume, "recurrent": recurrent, "recurrent_full_depth": recurrent_full,
            "whisper_bf16": whisper, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 9: data-parallel training
# ---------------------------------------------------------------------------


def dp_training(seed: int) -> dict:
    """9a: qwen1.5-0.5b, full width and depth, bf16, compressed DP over a
    stacked mesh of DP_MEMBERS on the card, against the one-card trainer."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.models.convert import reference_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("qwen1_5_0_5b")
    steps, B, S = LEARN_STEPS, DP_MEMBERS, TRAIN_SEQ
    src = _Repeat(SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed + 1,
                                    branching=4))
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    tcfg = TrainerConfig(compress_grads=True, dp_axis="data", adamw=AdamWConfig(lr=LEARN_LR),
                         warmup=2, total_steps=steps)
    mesh = Mesh((DP_MEMBERS,), ("data",), device=DEVICE)
    trainer = Trainer(cfg, tcfg, mesh=mesh)
    wrappers = {**model_kernels(), "reduce_nway": reduce_nway}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    trainer.fit(src, steps=steps, seed=seed)
    counts = launch_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    per_step = {k: v / steps for k, v in counts.items() if v}
    params = dict(trainer.state[0].named_parameters())
    leaves = reference_leaves(params, cfg)
    shapes = {leaf: (len(names),) * ("*" in leaf) + tuple(params[names[0]].shape)
              for leaf, names in leaves.items()}
    want = {"flash_attention": 2 * cfg.n_layers * B,
            "flash_attention[tensor_core]": 2 * cfg.n_layers * B, "reduce_nway": len(leaves)}
    if per_step != want:
        fail(f"dp train: launches per step {per_step}, not {want} (flash forward and remat "
             "recompute per member on the tensor-core route; one pmax per reference leaf)")
    if not all(map(math.isfinite, losses)) or not losses[-1] <= losses[0] - LEARN_DROP:
        fail(f"dp train: member 0's loss {losses}, not {LEARN_DROP} nats lower in {steps} steps")
    with torch.no_grad():
        dp_loss = trainer.family.loss_fn(trainer.state[0], batch, cfg).item()
    prof = profiled_step(trainer, batch)
    step_ms = statistics.median(dts[2:])
    numel = sum(math.prod(s) for s in shapes.values())
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    one = Trainer(cfg, dataclasses.replace(tcfg, compress_grads=False, dp_axis=None),
                  device=DEVICE)
    one.fit(src, steps=steps, seed=seed)
    with torch.no_grad():
        one_loss = one.family.loss_fn(one.state[0], batch, cfg).item()
    one_losses = [m["loss"] for m in one.metrics_log if "loss" in m]
    start_loss = one_losses[0]  # the whole batch's, at the initial weights
    del one
    kept = (start_loss - dp_loss) / (start_loss - one_loss)
    top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof["top"][:5])
    print(f"  dp train {cfg.name} full ({cfg.n_layers} layers, bf16), stacked mesh of "
          f"{DP_MEMBERS} x 1 x {S} tokens, int8 compressed: member 0's losses "
          f"{[round(x, 4) for x in losses]}; whole-batch loss {start_loss:.4f} -> {dp_loss:.4f}, "
          f"the one-card uncompressed run's -> {one_loss:.4f} (|diff| "
          f"{abs(dp_loss - one_loss):.4f}; {kept:.1%} of its reduction kept, at least "
          f"{DP_KEEP:.0%}); warm step {step_ms:.1f} ms (median of steps 3-{steps}), "
          f"{B * S / step_ms * 1e3:.0f} tokens/s; peak {peak:.2f} GiB; launches per step "
          f"{per_step}; {len(leaves)} reference leaves, int8 payload {numel} B a member "
          f"({4 * numel} B in f32); profiled step: wall {prof['wall_ms']:.1f} ms, device "
          f"{prof['device_ms']:.1f} ms (idle {prof['idle_share']:.1%}): {top}", flush=True)
    if not kept >= DP_KEEP:
        fail(f"dp train: the compressed run kept {kept:.1%} of the one-card run's loss "
             f"reduction, under {DP_KEEP:.0%}")
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "members": DP_MEMBERS, "seq": S,
            "steps": steps, "losses": losses, "one_card_losses": one_losses,
            "start_loss": start_loss, "whole_batch_loss": dp_loss,
            "one_card_whole_batch_loss": one_loss, "kept": kept, "keep_gate": DP_KEEP,
            "step_ms": dts, "warm_step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
            "peak_gib": peak, "launches_per_step": per_step, "launches": counts,
            "leaves": len(leaves), "int8_payload_bytes": numel, "profiled_step": prof,
            "leaf_shapes": {k: list(v) for k, v in shapes.items()}}


def plain_compressed_mean(grads: dict, errs: dict, n: int):
    """``compressed_mean`` over dim 0 of each leaf, written out: the pmax is
    ``amax`` over the member dim and the int32 sum exact."""
    means, new = {}, {}
    for k, g in grads.items():
        g32 = g.float() + errs[k]
        amax = g32.abs().flatten(1).amax(-1).amax(0)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        summed = q.to(torch.int32).sum(0, dtype=torch.int64).to(torch.int32)
        means[k] = (summed.float() * scale / n).to(g.dtype).expand(g.shape)
        new[k] = g32 - q * scale
    return means, new


def dp_compress_case(seed: int, shapes: dict) -> dict:
    """9b: ``compressed_mean`` on stacked bf16 gradients of 9a's leaves, with
    f32 residuals: bit-equal to its plain version; its device time, launches
    and byte bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.mesh import Mesh
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.optim import compressed_mean

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    n = DP_MEMBERS
    grads, errs = {}, {}
    for k, shape in shapes.items():
        spread = torch.rand((n,) + (1,) * len(shape), generator=gen, device=DEVICE) + 0.5
        grads[k] = (torch.randn((n,) + tuple(shape), generator=gen, device=DEVICE) * 1e-3
                    * spread).to(torch.bfloat16)
        errs[k] = torch.randn((n,) + tuple(shape), generator=gen, device=DEVICE) * 1e-6
    mesh = Mesh((n,), ("data",), device=DEVICE)

    def run():
        with mesh:
            return compressed_mean(grads, "data", errs)

    before = reduce_nway.launches
    mean, new = run()
    torch.cuda.synchronize()
    if reduce_nway.launches - before != len(shapes):
        fail(f"compressed_mean: {reduce_nway.launches - before} reduce_nway launches, "
             f"not one per leaf ({len(shapes)})")
    pmean, pnew = plain_compressed_mean(grads, errs, n)
    for k in shapes:
        if not (torch.equal(mean[k], pmean[k]) and torch.equal(new[k], pnew[k])):
            fail(f"compressed_mean of {k} differs from its plain version")
    del mean, new, pmean, pnew
    ms = time_ms(run, 3)
    plain_ms = time_ms(lambda: plain_compressed_mean(grads, errs, n), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    br = device_breakdown(prof)
    numel = sum(g.numel() for g in grads.values())
    # read bf16 gradients and f32 residuals; write bf16 means and f32 residuals
    nbytes = numel * (2 + 4 + 2 + 4)
    bound_ms = nbytes / PEAK_BYTES * 1e3
    top = ", ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in br["top"])
    print(f"  compressed_mean on {n} x {numel // n} gradients in {len(shapes)} leaves (bf16, f32 "
          f"residuals): bit-equal to the plain version; {ms:.3f} ms (plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms bytes); profiled: device {br['device_ms']:.3f} ms in "
          f"{br['launches']} launches: {top}", flush=True)
    del grads, errs
    return {"leaves": len(shapes), "numel": numel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "device_ms": br["device_ms"], "launches": br["launches"],
            "top": br["top"]}


def _axis_cases():
    """Every axis function on one axis ``a``, by name: (dtype, fn(x))."""
    from repro_torch.core import mesh as M

    def k():
        return M.current().stacked

    cases = {f"psum {str(dt).split('.')[-1]}": (dt, lambda x: M.psum(x, "data"))
             for dt in (torch.float32, torch.bfloat16, torch.int32, torch.float16,
                        torch.float64)}
    cases.update({
        "pmax": (torch.float32, lambda x: M.pmax(x, "data")),
        "psum_scatter tiled": (torch.float32, lambda x: M.psum_scatter(x, "data")),
        "psum_scatter": (torch.float32, lambda x: M.psum_scatter(
            x.narrow(k(), 0, 1), "data", tiled=False)),
        "all_gather tiled": (torch.float32, lambda x: M.all_gather(x, "data")),
        "all_gather": (torch.float32, lambda x: M.all_gather(x, "data", tiled=False)),
        "ppermute": (torch.float32, lambda x: M.ppermute(x, "data", [(0, 0)])),
        "axis_index": (torch.float32, lambda x: M.lift(M.axis_index("data"), x) + 0 * x),
        "take and put": (torch.float32, lambda x: M.put(x, M.axis_index("data"), M.take(
            x, M.axis_index("data"), k()) * 2, k())),
    })
    return cases


def dp_rank_backend(seed: int) -> dict:
    """9c: the rank mesh under NCCL at world size 1 against the stacked mesh
    of one member: every axis function, then 2 steps of the DP trainer at
    DP_RANK_LAYERS layers in f32, equal."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh, RankMesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        ranked = RankMesh((1,), ("data",), device=DEVICE, init_method=f"file://{tmp}/rendezvous",
                          rank=0)
        try:
            nccl = ".".join(map(str, torch.cuda.nccl.version()))
            print(f"  NCCL {nccl}, world size {dist.get_world_size()}, backend "
                  f"{dist.get_backend()}, rank mesh {ranked!r}", flush=True)
            stacked = Mesh((1,), ("data",), device=DEVICE)
            for name, (dtype, fn) in _axis_cases().items():
                x = torch.randn(8, 64, generator=gen, device=DEVICE)
                x = (x * 2**20).to(dtype) if dtype == torch.int32 else x.to(dtype)
                with ranked:
                    got = fn(x)
                with stacked:
                    want = fn(x[None])[0]
                if not (got.dtype == want.dtype and torch.equal(got, want)):
                    fail(f"rank mesh under NCCL: {name} differs from the stacked mesh")
            cfg = dataclasses.replace(get_config("qwen1_5_0_5b"), n_layers=DP_RANK_LAYERS,
                                      param_dtype=torch.float32, compute_dtype=torch.float32)
            B, S = DP_RANK_TOKENS
            src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed + 4)
            tcfg = TrainerConfig(compress_grads=True, dp_axis="data",
                                 adamw=AdamWConfig(lr=1e-3), warmup=1, total_steps=10)
            runs = {}
            for kind, mesh in (("ranks", ranked), ("stacked", stacked)):
                tr = Trainer(cfg, tcfg, mesh=mesh)
                model, _ = tr.fit(src, steps=2, seed=seed)
                runs[kind] = ([m["loss"] for m in tr.metrics_log if "loss" in m],
                              {k: p.detach().clone() for k, p in model.named_parameters()})
                del tr, model
            if runs["ranks"][0] != runs["stacked"][0] or any(
                    not torch.equal(p, runs["stacked"][1][k]) for k, p in runs["ranks"][1].items()):
                fail(f"DP trainer on the NCCL rank mesh: losses {runs['ranks'][0]} against the "
                     f"stacked mesh's {runs['stacked'][0]}, or parameters not equal")
        finally:
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    print(f"  rank mesh (NCCL, 1 rank): {len(_axis_cases())} axis functions equal to the stacked "
          f"mesh; DP trainer ({DP_RANK_LAYERS} layers, f32, {B} x {S}) 2 steps, losses "
          f"{runs['ranks'][0]}, parameters equal; {wall:.1f} s", flush=True)
    return {"nccl": nccl, "axis_functions": len(_axis_cases()), "losses": runs["ranks"][0],
            "wall_s": wall}


def dp_elastic(seed: int) -> dict:
    """9d: qwen's parameters on the (4, 2) mesh of 8 stacked members,
    re-meshed to the 5 survivors' (2, 2) under ZeRO-1 specs and back,
    bit-equal; then each member's loss on its rows at ELASTIC_LAYERS layers
    on the (2, 2) mesh, finite, their mean the whole batch's."""
    from repro_torch.configs import get_config
    from repro_torch.core import mesh as M
    from repro_torch.data import SyntheticLMSource
    from repro_torch.models import get_family
    from repro_torch.optim import opt_state_specs
    from repro_torch.runtime.elastic import largest_pow2_mesh, reshard

    cfg = get_config("qwen1_5_0_5b")
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    model = fam.init(gen, cfg, DEVICE)
    params = {k: p.detach() for k, p in model.named_parameters()}
    mesh8 = largest_pow2_mesh(range(8), model_max=2, device=DEVICE)
    mesh4 = largest_pow2_mesh(range(5), model_max=2, device=DEVICE)
    if (mesh8.shape, mesh4.shape) != ((4, 2), (2, 2)):
        fail(f"largest_pow2_mesh: {mesh8.shape} over 8, {mesh4.shape} over 5")
    specs = opt_state_specs({k: () for k in params}, params,
                            axis_sizes={"data": mesh8.size("data")})["m"]
    on8 = reshard(params, specs, mesh8)
    on4 = reshard(on8, specs, mesh4, src=mesh8)
    del on8
    for k, p in params.items():
        if not torch.equal(M.unshard(on4[k], mesh4, specs[k]), p):
            fail(f"elastic: {k} did not come back bit-equal from (4, 2) -> (2, 2)")
    sharded = sum(1 for s in specs.values() if any(s))
    del on4, model, params
    cut = dataclasses.replace(cfg, n_layers=ELASTIC_LAYERS)
    small = fam.init(gen, cut, DEVICE)
    member = fam.init(gen, cut, DEVICE)
    on4 = reshard({k: p.detach() for k, p in small.named_parameters()}, {}, mesh4)
    B, S = ELASTIC_TOKENS
    src = SyntheticLMSource(vocab=cut.vocab, seq_len=S, global_batch=B, seed=seed + 5)
    whole = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    rows = {k: M.shard(v, mesh4, ("data",)) for k, v in whole.items()}
    losses = torch.empty(mesh4.shape)
    with torch.no_grad():
        for i in range(mesh4.shape[0]):
            for j in range(mesh4.shape[1]):
                for k, p in member.named_parameters():
                    p.copy_(on4[k][i, j])
                losses[i, j] = fam.loss_fn(member, {k: v[i, j] for k, v in rows.items()}, cut)
        want = fam.loss_fn(small, whole, cut).item()
    got = losses[:, 0].mean().item()
    if not bool(torch.isfinite(losses).all()) or not abs(got - want) <= 1e-3 * abs(want):
        fail(f"elastic: member losses {losses.tolist()}, mean {got} against the whole batch's "
             f"{want}")
    wall = time.perf_counter() - t0
    print(f"  elastic: (4, 2) over 8 members, (2, 2) over 5 survivors; qwen's {len(specs)} "
          f"parameters ({sharded} under ZeRO-1 specs over 'data') bit-equal after 8 -> 4 -> "
          f"global; members' losses at {ELASTIC_LAYERS} layers {[round(x, 4) for x in losses.flatten().tolist()]}, "
          f"mean {got:.5f} against the whole batch's {want:.5f}; {wall:.1f} s", flush=True)
    return {"meshes": [list(mesh8.shape), list(mesh4.shape)], "parameters": len(specs),
            "zero1_sharded": sharded, "losses": losses.flatten().tolist(), "whole_loss": want,
            "wall_s": wall}


def dp_phase(seed: int) -> dict:
    """Phase 9; returns its numbers."""
    t0 = time.perf_counter()
    print("[dp] 9a: compressed data-parallel training on a stacked mesh of "
          f"{DP_MEMBERS}, qwen1.5-0.5b full width and depth")
    train = dp_training(seed)
    gc.collect()
    torch.cuda.empty_cache()
    print("[dp] 9b: compressed_mean on 9a's gradient shapes against its plain version")
    compress = dp_compress_case(seed, train.pop("leaf_shapes"))
    gc.collect()
    torch.cuda.empty_cache()
    print("[dp] 9c: the rank mesh under NCCL")
    ranks = dp_rank_backend(seed)
    gc.collect()
    torch.cuda.empty_cache()
    print("[dp] 9d: elastic re-mesh")
    elastic = dp_elastic(seed)
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"[dp] phase 9 took {wall:.1f} s")
    return {"train": train, "compressed_mean": compress, "rank_backend": ranks,
            "elastic": elastic, "wall_s": wall}


def ep_routing_global(record: list, B: int, S: int) -> list:
    """``routing()`` records of an expert-parallel run on a (1, tp) mesh as
    the unsharded run's: each member's routed tokens (its slice of the
    sequence, or all of them) back in global (b, s) order."""
    out = []
    for vals, idx, aux in record:
        vals, idx = vals[0], idx[0]  # the one member of "data"
        if idx.shape[1] != B * S:  # sliced: member m routed s in [m S/tp, (m+1) S/tp)
            tp = idx.shape[0]
            vals, idx = (t.unflatten(1, (B, S // tp)).transpose(0, 1).reshape(B * S, -1)
                         for t in (vals, idx))
        else:
            vals, idx = vals[0], idx[0]
        out.append((vals, idx, aux.reshape(-1)[0]))
    return out


@contextlib.contextmanager
def ep_drops():
    """Rows each member drops at capacity, summed on the card over the MoE
    layers called inside (the yielded dict's "rows", one per member)."""
    from unittest import mock

    from repro_torch.models import mlp as mlp_mod

    real, seen = mlp_mod._dispatch_indices, {}

    def dispatch(gate_idx, E, C):
        got = real(gate_idx, E, C)
        dropped = (~got[3]).sum(-1)
        seen["rows"] = dropped if "rows" not in seen else seen["rows"] + dropped
        return got

    with mock.patch.object(mlp_mod, "_dispatch_indices", dispatch):
        yield seen


def collective_costs(cfg, mesh, policy, B: int, S: int) -> dict:
    """Device ms (CUDA events) of phase 10's collectives at a prefill
    wave's shapes in bf16, each beside its byte bound: the psum after a
    row-parallel product (``reduce_nway`` over the model axis: every
    member's rows read, one sum written) and, with experts, the dispatch
    and combine ``all_to_all`` (a copy: every byte read and written).
    Before it is timed, each psum is held against the plain sum of the
    same input: the bf16 activation's, and the f32 aux loss's (one value
    per member, as the expert-parallel MoE's ``pmean`` sums it)."""
    from repro_torch.core import mesh as M
    from repro_torch.models.mlp import moe_capacity

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    tp, dp = mesh.size("model"), mesh.size("data")
    out = {}

    def row(name, fn, nbytes):
        ms = time_ms(fn, 10)
        out[name] = {"ms": ms, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes}
        print(f"  {name}: {ms:.4f} ms, byte bound {out[name]['bound_ms']:.4f} ms "
              f"({nbytes / 2**20:.1f} MiB)", flush=True)

    def held(x, axis, rtol, atol):
        """psum over ``axis`` against the f32 sum of the same members, cast
        back, element by element: |got - want| <= rtol * |want| + atol."""
        d = mesh.dim(axis)
        got = M.psum(x, axis)
        want = x.float().sum(d, keepdim=True).to(x.dtype).expand(x.shape)
        torch.cuda.synchronize()
        kind = "bf16" if x.dtype == torch.bfloat16 else "f32"
        name = f"psum over {axis} of {tuple(x.shape)} {kind}"
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name}: gave {tuple(got.shape)} {got.dtype}, plain {tuple(want.shape)} "
                 f"{want.dtype}")
        diff = (got.float() - want.float()).abs()
        ratio = (diff / (rtol * want.float().abs() + atol)).max().item()
        if not ratio <= 1.0:
            fail(f"{name}: max_abs_err {diff.max().item():.3e} at {ratio:.3f} of its limit "
                 f"{rtol:.3e} x |plain| + {atol} per element")
        out[f"{name} held"] = {"max_abs_err": diff.max().item(), "limit_ratio": ratio}
        print(f"  {name}: max_abs_err {diff.max().item():.3e} ({ratio:.3f} of {rtol:.3e} x "
              f"|plain| + {atol} per element) against the plain sum", flush=True)

    with mesh:
        # the f32 aux, one value per member: summed over 4 members in f32
        # in another order, ~4 * 2^-24 relative apart
        aux = torch.rand(mesh.shape, generator=gen, device=DEVICE)
        for axis in ("data", "model"):
            held(aux, axis, 1e-5, 1e-6)
        y = torch.randn(mesh.shape + (B // dp, S, cfg.d_model), generator=gen, device=DEVICE,
                        dtype=torch.bfloat16)
        held(y, "model", BF16_RTOL, 1e-5)  # phase 2's bf16 add rule
        row(f"psum over model of {tuple(y.shape)} bf16", lambda: M.psum(y, "model"),
            y.numel() * 2 * (1 + 1 / tp))
        del y
        if cfg.n_experts:
            tokens = B // dp * (S // tp if S % tp == 0 else S)
            C = moe_capacity(cfg, tokens)
            buf = torch.randn(mesh.shape + (cfg.n_experts, C, cfg.d_model), generator=gen,
                              device=DEVICE, dtype=torch.bfloat16)
            row(f"dispatch all_to_all of {tuple(buf.shape)} bf16",
                lambda: M.all_to_all(buf, "model", 0, 1), buf.numel() * 2 * 2)
            back = M.all_to_all(buf, "model", 0, 1)
            row(f"combine all_to_all of {tuple(back.shape)} bf16",
                lambda: M.all_to_all(back, "model", 1, 0), back.numel() * 2 * 2)
            del buf, back
    torch.cuda.empty_cache()
    return out


def tp_serve(seed: int, arch: str, mesh_shape: tuple, tag: str, unsharded: dict) -> dict:
    """10a / 10b: one model laid out on a stacked mesh: the f32 checks at
    TP_CHECK_LAYERS against the unsharded model, then phase 4's bf16 serve
    at full depth, twice; returns its numbers."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model
    from repro_torch.runtime.server import Request, Server

    cfg = get_config(arch)
    fam = get_family(cfg)
    mesh = Mesh(mesh_shape, ("data", "model"), device=DEVICE)
    policy = make_policy(cfg, mesh)
    out = {"arch": cfg.name, "mesh": list(mesh_shape), "n_layers": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()

    # f32 checks on a model built apart: sharded against unsharded.
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
                                n_layers=TP_CHECK_LAYERS)
    if cfg.n_experts:  # no row dropped: the expert-parallel MoE equals the local one
        cfg32 = dataclasses.replace(cfg32, capacity_factor=64.0)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    model32, _ = build_model(fam, cfg32, gen, "tp f32 checks")
    x = torch.randint(0, cfg.vocab, (SLOTS, WAVE + 1), generator=gen, device=DEVICE)
    with torch.inference_mode():
        with routing() as routed_plain:
            want, cache = fam.prefill(model32, x[:, :WAVE], cfg32, max_len=WAVE + 1)
        want_dec = fam.decode_step(model32, cache, x[:, WAVE:], WAVE, cfg32)[0]
        del cache
        sharded = shard_model(copy.deepcopy(model32), mesh, policy)
        with routing() as routed_tp:
            got, cache = fam.prefill(sharded, x[:, :WAVE], cfg32, policy, max_len=WAVE + 1)
        got_dec = fam.decode_step(sharded, cache, x[:, WAVE:], WAVE, cfg32, policy)[0]
        del cache, sharded
        name = (f"f32 prefill logits, sharded on {mesh_shape} vs unsharded, {SLOTS} x {WAVE}, "
                f"{TP_CHECK_LAYERS} of {cfg.n_layers} layers"
                + (" (capacity_factor 64)" if cfg.n_experts else ""))
        flips = 0
        if cfg.n_experts:
            routed_tp = ep_routing_global(routed_tp, SLOTS, WAVE)
            flips = routing_flips(routed_tp, routed_plain[:len(routed_tp)])
            out["routing_flips"] = flips
            print(f"  routing: {flips} of {len(routed_tp)} x {SLOTS * WAVE} (layer, token) "
                  f"choices differ between the sharded and the unsharded run", flush=True)
        if not logits_check(out, "prefill_f32", name, got, want, gate=not flips):
            pinned = []
            with pinned_routing(routed_tp, pinned):
                want, _ = fam.prefill(model32, x[:, :WAVE], cfg32, max_len=WAVE + 1)
            out["prefill_f32_unpinned"] = out.pop("prefill_f32")
            logits_check(out, "prefill_f32", name + ", routing pinned to the sharded run's",
                         got, want)
        logits_check(out, "decode_f32", f"f32 decode at {WAVE} after the prefill, sharded vs "
                     "unsharded", got_dec, want_dec)
    del model32, got, want, got_dec, want_dec, routed_plain, routed_tp
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 serving at full depth: phase 4's weights and requests.
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model, out["n_params"] = build_model(fam, cfg, gen, tag)
    t0 = time.perf_counter()
    shard_model(model, mesh, policy)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2**30
    print(f"  laid out on {mesh!r} in {out['shard_s']:.2f} s: {resident:.2f} GiB resident",
          flush=True)
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, REQUESTS)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
    server = Server(cfg, model, max_len=MAX_LEN, device=DEVICE, policy=policy)
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
    flash_attention.launches, reduce_nway.launches = 0, 0
    flash_attention.route_launches.update(dict.fromkeys(flash_attention.route_launches, 0))
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
            fail(f"{tag} serve: a request did not finish with its tokens")
        if not all(0 <= tok < cfg.vocab for o in tokens for tok in o):
            fail(f"{tag} serve: a token outside [0, vocab)")
        runs.append({"run": run, "wall_ms": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall * 1e3,
                     "prefill_ms": list(times["prefill"]),
                     "decode_ms_per_step": sum(times["decode"]) / len(times["decode"]),
                     "decode_steps": len(times["decode"]), "out": tokens})
        print(f"  {tag} serve ({run}): {n_tok} tokens in {wall:.1f} ms ({n_tok / wall * 1e3:.1f} "
              f"tok/s); prefill ms per wave {[round(m, 2) for m in times['prefill']]}, decode "
              f"{runs[-1]['decode_ms_per_step']:.2f} ms per step over {len(times['decode'])} "
              f"steps", flush=True)
    n_prefills = sum(len(r["prefill_ms"]) for r in runs)
    launches = {"flash_attention_wgmma": flash_attention.route_launches["tensor_core"],
                "flash_attention_mma_sync": flash_attention.route_launches["mma_sync"],
                "reduce_nway": reduce_nway.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if runs[0]["out"] != runs[1]["out"]:
        fail(f"{tag} serve: a second run gave other tokens")
    if launches["flash_attention_wgmma"] != cfg.n_layers * n_prefills or \
            launches["flash_attention_mma_sync"]:
        fail(f"{tag} serve launched flash_attention {launches} over {n_prefills} prefills, not "
             f"{cfg.n_layers} tensor-core launches per prefill")
    if launches["reduce_nway"] <= 0:
        fail(f"{tag} serve never launched reduce_nway")
    if peak > TP_PEAK_GIB:
        fail(f"{tag}: peak device memory {peak:.2f} GiB above {TP_PEAK_GIB}")
    agree = None
    if arch in SERVED_TOKENS:
        pairs = [(a, b) for ra, rb in zip(runs[0]["out"], SERVED_TOKENS[arch])
                 for a, b in zip(ra, rb)]
        agree = sum(a == b for a, b in pairs)
        print(f"  {agree} of {len(pairs)} tokens equal to the unsharded serve's (phase 4; not "
              f"gated: a bf16 sum taken in another order can tip an argmax)", flush=True)
    print(f"  served twice, same tokens; launches {launches} over {n_prefills} prefills "
          f"(reduce_nway {launches['reduce_nway'] / n_prefills:.1f} per prefill, decode steps "
          f"included); peak device memory {peak:.2f} GiB ({resident:.2f} GiB resident)",
          flush=True)

    # One profiled prefill and decode step of the first wave, and the
    # unsharded phase's numbers on the same card beside them.
    wave = [[0] * (max(map(len, prompts[:SLOTS])) - len(p)) + p for p in prompts[:SLOTS]]
    tokens = torch.tensor(wave, dtype=torch.int64, device=DEVICE)
    state = {}
    reduce_nway.launches = 0

    def prefill():
        state.clear()  # one cache at a time
        state["logits"], state["cache"] = fam.prefill(model, tokens, cfg, policy,
                                                      max_len=MAX_LEN)

    def decode():
        nxt = state["logits"].argmax(-1)[:, None]
        fam.decode_step(model, state["cache"], nxt, tokens.shape[1], cfg, policy)

    with torch.inference_mode(), ep_drops() as dropped:  # untimed: the drops counted
        prefill()
        torch.cuda.synchronize()
    out["reduce_nway_per_prefill"] = reduce_nway.launches
    drops = dropped["rows"].flatten().tolist() if "rows" in dropped else None
    if drops:
        print(f"  rows dropped by member at capacity, summed over the {cfg.n_layers} MoE "
              f"layers of the first wave's prefill: {drops}", flush=True)
    profile_calls(out, {"prefill": prefill, "decode": decode})
    for call in ("prefill", "decode"):
        base = unsharded.get(f"profiled_{call}")
        if base:
            print(f"  {call}: device {out[f'profiled_{call}']['device_ms']:.2f} ms, idle "
                  f"{out[f'profiled_{call}']['idle_share']:.1%} sharded; unsharded (phase "
                  f"{'4' if arch == 'yi_6b' else '6a'}) device {base['device_ms']:.2f} ms, idle "
                  f"{base['idle_share']:.1%}", flush=True)
    del state
    out["collectives"] = collective_costs(cfg, mesh, policy, SLOTS, tokens.shape[1])
    for r in runs:
        del r["out"]
    out.update(runs=runs, launches=launches, prefills=n_prefills, peak_gib=peak,
               resident_gib=resident, rows_dropped_by_member=drops, agree_with_unsharded=agree,
               prompt_lens=[int(n) for n in lens])
    del model, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_rank_backend(seed: int) -> dict:
    """10c: the rank mesh under NCCL at world size 1 against the stacked
    mesh of one member: ``all_to_all`` over a one-member axis, and the
    sharded prefill of a dense and an MoE smoke model (f32), equal."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model

    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_tp_") as tmp:
        ranked = M.RankMesh((1, 1), ("data", "model"), device=DEVICE,
                            init_method=f"file://{tmp}/rendezvous", rank=0)
        try:
            stacked = M.Mesh((1, 1), ("data", "model"), device=DEVICE)
            x = torch.randn(8, 6, 4, generator=gen, device=DEVICE).to(torch.bfloat16)
            for split, concat in ((0, 1), (1, 0)):
                with ranked:
                    got = M.all_to_all(x, "model", split, concat)
                with stacked:
                    want = M.all_to_all(x[None, None], "model", split, concat)[0, 0]
                if not torch.equal(got, want):
                    fail(f"rank mesh under NCCL: all_to_all {split}->{concat} differs")
            prefills = {}
            for arch in ("yi_6b", "moonshot_v1_16b"):
                cfg = get_smoke_config(arch)
                fam = get_family(cfg)
                base = fam.init(torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
                tokens = torch.randint(0, cfg.vocab, TP_RANK_TOKENS, generator=gen, device=DEVICE)
                got = {}
                for kind, mesh in (("ranks", ranked), ("stacked", stacked)):
                    policy = make_policy(cfg, mesh)
                    model = shard_model(copy.deepcopy(base), mesh, policy)
                    got[kind] = fam.prefill(model, tokens, cfg, policy)[0]
                if not torch.equal(got["ranks"], got["stacked"]):
                    fail(f"rank mesh under NCCL: {arch} sharded prefill differs from the "
                         f"stacked mesh's by {(got['ranks'] - got['stacked']).abs().max().item()}")
                prefills[arch] = got["ranks"].abs().max().item()
        finally:
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    print(f"  rank mesh (NCCL, 1 rank, (1, 1)): all_to_all equal to the stacked mesh; sharded "
          f"smoke prefills {sorted(prefills)} equal (max|logits| {prefills}); {wall:.1f} s",
          flush=True)
    return {"prefills": prefills, "wall_s": wall}


def tp_phase(seed: int, serving: dict, smi: str) -> dict:
    """Phase 10 (``smi``: the card's name and power limit); returns its numbers."""
    t0 = time.perf_counter()
    out = {}
    for part, spec in zip("ab", TP_SERVES):
        print(f"[tp] 10{part}: {spec['tag']}, {spec['arch']} at full width and depth on a "
              f"stacked {spec['mesh']} mesh; card {smi}", flush=True)
        out[spec["tag"]] = tp_serve(seed, spec["arch"], spec["mesh"], spec["tag"],
                                    serving.get(spec["arch"], {}))
    print(f"[tp] 10c: the rank mesh under NCCL; card {smi}", flush=True)
    out["rank_backend"] = tp_rank_backend(seed)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    out["card"] = smi
    print(f"[tp] phase 10 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: model-parallel training
# ---------------------------------------------------------------------------


def mp_training(seed: int, phase7: dict, phase9: dict) -> dict:
    """11a: qwen1.5-0.5b, full width and depth, bf16, sequence-parallel on a
    stacked MP_MESH mesh through ``Trainer(policy=, mesh=)``."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config("qwen1_5_0_5b")
    steps, B, S = LEARN_STEPS, TRAIN_BATCH, TRAIN_SEQ
    mesh = Mesh(MP_MESH, ("data", "model"), device=DEVICE)
    policy = make_policy(cfg, mesh, seq_parallel=True)
    src = _Repeat(SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed + 1,
                                    branching=4))
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = tt.init(torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
    flops = train_flops(model, cfg, B, S)  # of the global model, as phase 7's
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=LEARN_LR), warmup=2,
                                         total_steps=steps), model=model, mesh=mesh,
                      policy=policy)
    del model  # the trainer keeps it (0.93 GB) and lays out a copy
    wrappers = {**model_kernels(), "reduce_nway": reduce_nway}
    zero_counts(wrappers)
    trainer.fit(src, steps=steps, seed=seed)
    counts = launch_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    per_step = {k: v / steps for k, v in counts.items() if v}
    want_flash = {"flash_attention": 2 * cfg.n_layers,
                  "flash_attention[tensor_core]": 2 * cfg.n_layers}
    got_flash = {k: per_step.get(k, 0) for k in want_flash}
    if got_flash != want_flash:
        fail(f"mp train: flash launches per step {got_flash}, not {want_flash} (the members' "
             "heads in one launch a layer, forward and remat recompute, tensor-core route)")
    if not per_step.get("reduce_nway[backward]", 0) > 0:
        fail(f"mp train: reduce_nway never launched by the backward pass ({per_step})")
    if not all(map(math.isfinite, losses)) or not losses[-1] <= losses[0] - LEARN_DROP:
        fail(f"mp train: losses {losses}, not {LEARN_DROP} nats lower in {steps} steps")
    if not peak < MP_PEAK_GIB:
        fail(f"mp train: peak {peak:.2f} GiB, not under {MP_PEAK_GIB}")
    split = mp_split_launches(trainer, batch)
    prof = profiled_step(trainer, batch)
    step_ms = statistics.median(dts[2:])
    laid_out = sum(p.numel() for p in trainer.state[0].parameters())
    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "mesh": list(MP_MESH),
           "seq_parallel": True, "batch": B, "seq": S, "steps": steps, "losses": losses,
           "step_ms": dts, "warm_step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
           "model_tflop_per_step": flops / 1e12, "mfu": flops / (step_ms / 1e3) / PEAK_BF16,
           "peak_gib": peak, "laid_out_params": laid_out, "launches_per_step": per_step,
           "launches": counts, "launch_split": split, "profiled_step": prof}
    top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof["top"][:5])
    print(f"  mp train {cfg.name} full ({cfg.n_layers} layers, bf16) on a stacked {MP_MESH} "
          f"mesh, sequence-parallel, {B} x {S} tokens: losses {[round(x, 4) for x in losses]} "
          f"(at least {LEARN_DROP} nats lower); warm step {step_ms:.1f} ms (median of steps "
          f"3-{steps}), {out['tokens_per_s']:.0f} tokens/s, MFU {out['mfu']:.2%} of {flops / 1e12:.2f} "
          f"model TFLOP a step; peak {peak:.2f} GiB (under {MP_PEAK_GIB}); {laid_out / 1e9:.3f} B "
          f"laid-out parameters; launches per step {per_step}; split {split}; profiled step: "
          f"wall {prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms (idle "
          f"{prof['idle_share']:.1%}): {top}", flush=True)
    p7, p9 = phase7["train"], phase9["train"]
    print(f"  beside phase 7 (one card, unsharded): warm step {p7['warm_step_ms']:.1f} ms, "
          f"{p7['tokens_per_s']:.0f} tokens/s, MFU {p7['mfu']:.2%}, peak {p7['peak_gib']:.2f} GiB, "
          f"idle {p7['profiled_step']['idle_share']:.1%}; phase 9a (4 stacked DP members): "
          f"{p9['warm_step_ms']:.1f} ms, {p9['tokens_per_s']:.0f} tokens/s, peak "
          f"{p9['peak_gib']:.2f} GiB, idle {p9['profiled_step']['idle_share']:.1%}", flush=True)
    out["grad_row"] = backward_psum_cost(cfg, mesh, B, S)
    out["grad_row"]["backward_launches_per_step"] = per_step["reduce_nway[backward]"]
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mp_split_launches(trainer, batch) -> dict:
    """``split_launches`` of one sharded loss and gradient, and the
    ``reduce_nway`` launches of the copies' sum (``sum_copies``)."""
    from repro_torch.core import mesh as M
    from repro_torch.kernels.reduce_nway import reduce_nway

    model = trainer.state[0]
    params = dict(model.named_parameters())
    out, grads = split_launches(lambda: trainer._loss(model, batch), list(params.values()),
                                {**model_kernels(), "reduce_nway": reduce_nway})
    before = reduce_nway.launches
    for k, g in zip(params, grads):
        M.sum_copies(g, trainer.mesh, trainer._layout[1][k])
    torch.cuda.synchronize()
    out["reduce_nway"]["sum_copies"] = reduce_nway.launches - before
    return out


def backward_psum_cost(cfg, mesh, B: int, S: int) -> dict:
    """The backward's sum at 11a's shape, the transpose of the gather of S
    before attention and the MLP: ``reduce_nway`` over the model axis of
    the (*mesh, B / data, S, d) bf16 cotangent, held against the plain f32
    sum of the same input (phase 2's bf16 add rule), then timed beside its
    byte bound and ``torch.sum`` over the same dim."""
    from repro_torch.core import mesh as M

    gen = torch.Generator(device=DEVICE).manual_seed(13)
    tp, dp = mesh.size("model"), mesh.size("data")
    d = mesh.dim("model")
    g = torch.randn(mesh.shape + (B // dp, S, cfg.d_model), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    got = M.axis_sum(g, d)
    want = g.float().sum(d).to(g.dtype)
    diff = (got.float() - want.float()).abs()
    ratio = (diff / (BF16_RTOL * want.float().abs() + 1e-5)).max().item()
    if not ratio <= 1.0:
        fail(f"backward psum of {tuple(g.shape)}: max_abs_err {diff.max().item():.3e} at "
             f"{ratio:.3f} of its limit")
    nbytes = g.numel() * 2 * (1 + 1 / tp)
    row = {"grad": "reduce_nway add is an autograd.Function (the cotangent broadcast); the "
                   "stacked mesh's psum and all_gather transpose to a sum over the axis' dim "
                   "through the kernel (core/mesh.py _Broadcast), a rank mesh's to the "
                   "transposed collective",
           "case": f"backward psum over model of {tuple(g.shape)} bf16",
           "bwd_ms": time_ms(lambda: M.axis_sum(g, d), 10),
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
           "library_ms": time_ms(lambda: g.sum(d), 10), "max_abs_err": diff.max().item(),
           "limit_ratio": ratio}
    print(f"  {row['case']}: {row['bwd_ms']:.4f} ms, byte bound {row['bound_ms']:.4f} ms, "
          f"torch.sum {row['library_ms']:.4f} ms; max_abs_err {row['max_abs_err']:.3e} "
          f"({ratio:.3f} of the bf16 limit) against the plain f32 sum", flush=True)
    del g, got, want, diff
    return row


def mp_grad_gate(seed: int, arch: str, mesh_shape: tuple, seq_parallel: bool) -> dict:
    """11b: ``arch`` at full width, MP_GATE_LAYERS layers, f32, laid out on a
    stacked ``mesh_shape`` mesh: the sharded loss's global gradient leaves
    against the unsharded model's, within TRAIN_RTOL of each leaf's max|g|.
    The MoE runs at capacity_factor 64 and is held on the cross-entropy
    alone, its unsharded run on the sharded run's expert choices."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.models.common import chunked_cross_entropy
    from repro_torch.models.convert import global_grads, reference_leaves, shard_model
    from repro_torch.models.parallel import Members

    cfg = dataclasses.replace(get_config(arch), n_layers=MP_GATE_LAYERS,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    moe = bool(cfg.n_experts)
    if moe:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    model = tt.init(gen, cfg, DEVICE, trainable=True)
    B, S = MP_GATE_TOKENS
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=DEVICE)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    mesh = Mesh(mesh_shape, ("data", "model"), device=DEVICE)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    sharded = shard_model(copy.deepcopy(model), mesh, policy).requires_grad_(True)
    names = [n for n, _ in sharded.named_parameters()]

    def sharded_loss():
        if not moe:
            return tt.loss_fn(sharded, batch, cfg, policy)
        with mesh:
            mb = Members(policy)
            x, _ = tt._forward_tp(sharded, batch["tokens"], cfg, mb)
            return mb.backward_loss(chunked_cross_entropy(
                mb.gather_seq(x), sharded.head, mb.shard_batch(batch["labels"]), cfg, mb))

    with routing() if moe else contextlib.nullcontext() as routed:
        loss = sharded_loss()
        got = global_grads(sharded, dict(zip(names, torch.autograd.grad(
            loss, list(sharded.parameters())))))
    del sharded
    flips = []
    with pinned_routing(ep_routing_global(routed, B, S), flips) if moe             else contextlib.nullcontext():
        if moe:
            hidden, _ = tt.forward(model, batch["tokens"], cfg)
            want_loss = chunked_cross_entropy(hidden, model.head, batch["labels"], cfg)
        else:
            want_loss = tt.loss_fn(model, batch, cfg)
        plain = dict(zip(names, torch.autograd.grad(want_loss, list(model.parameters()))))
    want = {leaf: torch.stack([plain[n] for n in ns]) if "*" in leaf else plain[ns[0]]
            for leaf, ns in reference_leaves(plain, cfg).items()}
    if not abs(loss.item() - want_loss.item()) <= TRAIN_RTOL * abs(want_loss.item()):
        fail(f"{arch} sharded f32 gate: loss {loss.item()} against {want_loss.item()}")
    worst, worst_leaf = 0.0, None
    for leaf, g in got.items():
        err, scale = (g - want[leaf]).abs().max().item(), want[leaf].abs().max().item()
        if not bool(torch.isfinite(g).all()) or not err <= TRAIN_RTOL * scale or \
                not g.abs().max().item() > 0:
            fail(f"{arch} sharded f32 gate: gradient of {leaf} off by {err:.3e}, max|g_plain| "
                 f"{scale:.3e}, or zero")
        if scale and err / scale >= worst:
            worst, worst_leaf = err / scale, leaf
    tag = f"{arch} on {mesh_shape}, sequence parallelism {'on' if seq_parallel else 'off'}"
    routed_note = f"; {sum(flips)} routing flips over {len(flips)} router calls" if moe else ""
    print(f"  {tag} ({cfg.n_layers} layers, f32, {B} x {S}{', capacity_factor 64, the '
          'cross-entropy' if moe else ''}): loss {loss.item():.6f} (unsharded "
          f"{want_loss.item():.6f}); worst global gradient leaf {worst_leaf} at {worst:.3e} of "
          f"its max|g_unsharded| (<= {TRAIN_RTOL}){routed_note}", flush=True)
    out = {"arch": arch, "mesh": list(mesh_shape), "seq_parallel": seq_parallel,
           "loss": loss.item(), "unsharded_loss": want_loss.item(), "worst_grad_rel": worst,
           "worst_leaf": worst_leaf}
    if moe:
        out["routing_flips"] = sum(flips)
    del model, got, plain, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mp_moe_training(seed: int) -> dict:
    """11b: moonshot-v1-16b-a3b at full width, MP_GATE_LAYERS layers, bf16,
    expert- and sequence-parallel on a stacked MP_MOE_MESH mesh,
    MP_MOE_STEPS steps through ``Trainer(policy=, mesh=)``."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("moonshot_v1_16b"), n_layers=MP_GATE_LAYERS)
    mesh = Mesh(MP_MOE_MESH, ("data", "model"), device=DEVICE)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed, branching=4)
    wrappers = {**model_kernels(), "reduce_nway": reduce_nway}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(wrappers)
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=3e-4), warmup=2,
                                         total_steps=MP_MOE_STEPS), mesh=mesh,
                      policy=make_policy(cfg, mesh, seq_parallel=True))
    trainer.fit(src, steps=MP_MOE_STEPS, seed=seed)
    per_step = {k: v / MP_MOE_STEPS for k, v in launch_counts(wrappers).items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    if not all(map(math.isfinite, losses)):
        fail(f"mp moe training: losses {losses}")
    if not per_step.get("flash_attention[tensor_core]") or \
            not per_step.get("reduce_nway[backward]"):
        fail(f"mp moe training: launches per step {per_step}")
    step_ms = statistics.median(dts[1:])
    print(f"  mp train {cfg.name} ({cfg.n_layers} layers, bf16, {B} x {S}) on a stacked "
          f"{MP_MOE_MESH} mesh, expert- and sequence-parallel: losses "
          f"{[round(x, 4) for x in losses]}; warm step {step_ms:.1f} ms (median of steps 2-"
          f"{MP_MOE_STEPS}); peak {peak:.2f} GiB; launches per step {per_step}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "mesh": list(MP_MOE_MESH),
            "batch": B, "seq": S, "losses": losses, "step_ms": dts, "warm_step_ms": step_ms,
            "peak_gib": peak, "launches_per_step": per_step}


def mp_rank_backend(seed: int) -> dict:
    """11c: the rank mesh under NCCL at world size 1 against the stacked mesh
    of one member: the sharded loss's global gradients of a smoke config,
    then MP_RANK_STEPS steps of ``Trainer(policy=, mesh=)``, bit-equal.  The
    first step's global norm and clip scale of each mesh are printed as hex
    floats, and the first leaf whose moment or new parameter differs."""
    from unittest import mock

    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.data import SyntheticLMSource
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import global_grads, shard_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.runtime import trainer as trainer_mod
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    first_steps = {}

    def recorded(kind):
        """adamw_update, its first call's norm, scale and results kept."""
        def update(params, grads, state, cfg_, lr_scale=1.0, layout=None, **kw):
            new, opt, metrics = adamw_mod.adamw_update(params, grads, state, cfg_, lr_scale,
                                                       layout, **kw)
            if kind not in first_steps:
                gnorm = metrics["grad_norm"]
                scale = torch.clamp(cfg_.grad_clip / (gnorm + 1e-9), max=1.0)
                first_steps[kind] = {"global_norm": gnorm.item(), "scale": scale.item(),
                                     "m": {k: t.clone() for k, t in opt["m"].items()},
                                     "v": {k: t.clone() for k, t in opt["v"].items()},
                                     "new": {k: t.detach().clone() for k, t in new.items()}}
            return new, opt, metrics
        return update

    t0 = time.perf_counter()
    cfg = get_smoke_config("qwen1_5_0_5b")
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=seed + 4)
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    base = tt.init(torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_mp_") as tmp:
        ranked = M.RankMesh((1, 1), ("data", "model"), device=DEVICE,
                            init_method=f"file://{tmp}/rendezvous", rank=0)
        try:
            stacked = M.Mesh((1, 1), ("data", "model"), device=DEVICE)
            runs = {}
            for kind, mesh in (("ranks", ranked), ("stacked", stacked)):
                policy = make_policy(cfg, mesh)
                model = shard_model(copy.deepcopy(base), mesh, policy).requires_grad_(True)
                loss = tt.loss_fn(model, batch, cfg, policy)
                names = [n for n, _ in model.named_parameters()]
                grads = global_grads(model, dict(zip(names, torch.autograd.grad(
                    loss, list(model.parameters())))))
                tr = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=1,
                                                total_steps=10), model=base, mesh=mesh,
                             policy=policy)
                with mock.patch.object(trainer_mod, "adamw_update", recorded(kind)):
                    trained, _ = tr.fit(src, steps=MP_RANK_STEPS, seed=seed)
                params = {k: p.detach().clone() for k, p in trained.named_parameters()}
                losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
                runs[kind] = (loss.item(), grads, losses, params)
                del model, tr, trained
        finally:
            dist.destroy_process_group()
    (loss_r, grads_r, losses_r, params_r), (loss_s, grads_s, losses_s, params_s) = \
        runs["ranks"], runs["stacked"]
    params_s = {k: p.reshape(params_r[k].shape) for k, p in params_s.items()}
    if not (loss_r == loss_s and losses_r == losses_s
            and all(torch.equal(g, grads_s[k]) for k, g in grads_r.items())):
        fail(f"rank mesh under NCCL: the sharded loss {loss_r}, trainer losses {losses_r} or "
             f"gradients differ from the stacked mesh's ({loss_s}, {losses_s})")
    r1, s1 = first_steps["ranks"], first_steps["stacked"]
    first_diff = {}
    for part in ("m", "v", "new"):
        first_diff[part] = next((k for k, t in r1[part].items()
                                 if not torch.equal(t, s1[part][k].reshape(t.shape))), None)
    print(f"  rank mesh (NCCL) against the stacked mesh, step 1: global_norm "
          f"{r1['global_norm'].hex()} / {s1['global_norm'].hex()}, scale {r1['scale'].hex()} / "
          f"{s1['scale'].hex()}; first differing leaf of m, v, new parameters: {first_diff}")
    params_diff = max((p - params_s[k]).abs().max().item() for k, p in params_r.items())
    if not all(torch.equal(p, params_s[k]) for k, p in params_r.items()):
        fail(f"rank mesh under NCCL: parameters after {MP_RANK_STEPS} steps differ from the "
             f"stacked mesh's by {params_diff:.3e}")
    wall = time.perf_counter() - t0
    print(f"  rank mesh (NCCL, 1 rank, (1, 1)): sharded smoke loss {loss_r:.6f}, its "
          f"{len(grads_r)} global gradient leaves, {MP_RANK_STEPS} trainer steps' losses "
          f"{losses_r} and the parameters after them equal to the stacked mesh's; "
          f"{wall:.1f} s", flush=True)
    return {"loss": loss_r, "losses": losses_r, "params_max_abs_diff": params_diff,
            "step1": {k: {"global_norm": r["global_norm"].hex(), "scale": r["scale"].hex()}
                      for k, r in (("ranks", r1), ("stacked", s1))},
            "step1_first_differing": first_diff, "wall_s": wall}


def mp_phase(seed: int, phase7: dict, phase9: dict, smi: str) -> dict:
    """Phase 11 (``smi``: the card's name and power limit); returns its numbers."""
    t0 = time.perf_counter()
    out = {"card": smi}
    print(f"[mp train] 11a: qwen1.5-0.5b at full width and depth on a stacked {MP_MESH} mesh, "
          f"sequence-parallel; card {smi}", flush=True)
    out["train"] = mp_training(seed, phase7, phase9)
    print(f"[mp train] 11b: f32 gradient gates at full width, {MP_GATE_LAYERS} layers; then "
          f"moonshot in bf16; card {smi}", flush=True)
    out["f32_gates"] = [mp_grad_gate(seed, "qwen1_5_0_5b", MP_MESH, sp) for sp in (False, True)]
    out["f32_gates"].append(mp_grad_gate(seed, "moonshot_v1_16b", MP_MOE_MESH, True))
    out["moe_train"] = mp_moe_training(seed)
    print(f"[mp train] 11c: the rank mesh under NCCL; card {smi}", flush=True)
    out["rank_backend"] = mp_rank_backend(seed)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[mp train] phase 11 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 12: sharded serving and training of the hybrid, rwkv6 and whisper
# ---------------------------------------------------------------------------


def family_inputs(cfg, gen, B: int, S: int):
    """(prompt of B x S tokens, the next token, a loss batch of the same
    tokens): whisper's carry B sequences of frames (phase 6c's scale)."""
    x = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen, device=DEVICE)
    batch = {"tokens": x[:, :S], "labels": x[:, 1:]}
    prompt = x[:, :S]
    if cfg.family == "whisper":
        frames = torch.randn(B, cfg.encoder_len, cfg.d_model, generator=gen, device=DEVICE) * 0.1
        batch["frames"] = frames
        prompt = {"frames": frames, "tokens": prompt}
    return prompt, x[:, S:], batch


def family_f32_gates(seed: int, cfg, mesh, check_layers, out: dict):
    """12a's f32 gates: ``cfg`` at full width and ``check_layers`` (None:
    full depth), built apart: the sharded prefill logits with sequence
    parallelism off and on and a decode step after each, against the
    unsharded model's, within SERVE_RTOL of max|logits|."""
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model

    fam = get_family(cfg)
    cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
                                n_layers=check_layers or cfg.n_layers)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    model32, out["check_params"] = build_model(fam, cfg32, gen, "tp f32 checks")
    B, S = (WHISPER_SEQS, WHISPER_TEXT_CTX) if cfg.family == "whisper" else (SLOTS, WAVE)
    prompt, nxt, _ = family_inputs(cfg32, gen, B, S)
    where = (f"{B} x {S}" + (f" over {cfg.encoder_len} frames" if cfg.family == "whisper" else "")
             + f", {cfg32.n_layers} of {cfg.n_layers} layers")
    with torch.inference_mode():
        want, cache = fam.prefill(model32, prompt, cfg32, max_len=S + 1)
        want_dec = fam.decode_step(model32, cache, nxt, S, cfg32)[0]
        del cache
        for sp in (False, True):
            policy = make_policy(cfg32, mesh, seq_parallel=sp)
            sharded = shard_model(copy.deepcopy(model32), mesh, policy)
            got, cache = fam.prefill(sharded, prompt, cfg32, policy, max_len=S + 1)
            got_dec = fam.decode_step(sharded, cache, nxt, S, cfg32, policy)[0]
            del cache, sharded
            mode = "sequence-parallel" if sp else "tensor-parallel"
            logits_check(out, f"prefill_f32{'_sp' if sp else ''}",
                         f"f32 prefill logits, {mode} on {mesh.shape} vs unsharded, {where}",
                         got, want)
            logits_check(out, f"decode_f32{'_sp' if sp else ''}",
                         f"f32 decode at {S} after the {mode} prefill vs unsharded", got_dec,
                         want_dec)
            del got, got_dec
    del model32, want, want_dec
    gc.collect()
    torch.cuda.empty_cache()


def yi_seq_parallel_check(seed: int) -> dict:
    """The transformer's sequence-parallel prefill on the card: yi-6b at
    full width and TP_CHECK_LAYERS in f32 on a stacked (2, 4) mesh, its
    prefill logits with sequence parallelism against the same without it,
    within SERVE_RTOL of max|logits|."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import shard_model

    cfg = dataclasses.replace(get_config("yi_6b"), param_dtype=torch.float32,
                              compute_dtype=torch.float32, n_layers=TP_CHECK_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)
    model, _ = build_model(tt, cfg, gen, "tp f32 checks")
    mesh = Mesh((2, 4), ("data", "model"), device=DEVICE)
    x = torch.randint(0, cfg.vocab, (SLOTS, WAVE), generator=gen, device=DEVICE)
    logits = {}
    with torch.inference_mode():
        for sp in (False, True):
            policy = make_policy(cfg, mesh, seq_parallel=sp)
            sharded = shard_model(copy.deepcopy(model), mesh, policy)
            logits[sp] = tt.prefill(sharded, x, cfg, policy)[0]  # through _prefill_tp
            del sharded
    out = {}
    logits_check(out, "prefill_f32_sp", f"yi-6b f32 _prefill_tp, sequence-parallel vs not, on "
                 f"(2, 4), {SLOTS} x {WAVE}, {TP_CHECK_LAYERS} of 32 layers", logits[True],
                 logits[False])
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xw_gather_cost(cfg, mesh, policy, B: int, S: int) -> dict:
    """The hybrid's gather of the conv output over the model axis at a
    prefill wave's shape, (*mesh, B / data, S, w / tp) bf16 -> (*mesh,
    B / data, S, w) as the recurrent block calls it (``Members.gather``),
    first held against the members' blocks in member order, then timed
    with CUDA events beside its byte bound (every member's block read once,
    every member's whole written)."""
    from repro_torch.models.parallel import Members

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    tp, dp = mesh.size("model"), mesh.size("data")
    w = cfg.lru_width or cfg.d_model
    xw = torch.randn(mesh.shape + (B // dp, S, w // tp), generator=gen, device=DEVICE,
                     dtype=torch.bfloat16)
    with mesh:
        mb = Members(policy)
        got = mb.gather(xw, -1)
        want = xw.movedim(1, -2).flatten(-2)  # column block j: member j's xw
        if not torch.equal(got, want.unsqueeze(1).expand(got.shape)):
            fail("the hybrid's xw gather is not the members' blocks in member order")
        ms = time_ms(lambda: mb.gather(xw, -1), 10)
    nbytes = xw.numel() * 2 * (1 + tp)
    row = {"case": f"all_gather over model of {tuple(xw.shape)} bf16 on the last dim", "ms": ms,
           "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes}
    print(f"  {row['case']} (held against the members' blocks): {ms:.4f} ms, byte bound "
          f"{row['bound_ms']:.4f} ms ({nbytes / 2**20:.1f} MiB)", flush=True)
    del xw, got, want
    torch.cuda.empty_cache()
    return row


def family_serve(seed: int, spec: dict, unsharded: dict) -> dict:
    """12a for one family: the f32 gates, then the bf16 serve at full width
    and depth on a stacked mesh (the hybrid and rwkv6 through
    ``Server(policy=, mesh=)``, whisper's generation through ``prefill`` /
    ``decode_step``), twice, equal; returns its numbers."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model
    from repro_torch.runtime.server import Request, Server

    arch, tag = spec["arch"], spec["tag"]
    cfg = get_config(arch)
    fam = get_family(cfg)
    whisper = cfg.family == "whisper"
    mesh = Mesh(spec["mesh"], ("data", "model"), device=DEVICE)
    policy = make_policy(cfg, mesh)
    out = {"arch": cfg.name, "mesh": list(spec["mesh"]), "n_layers": cfg.n_layers}
    torch.cuda.reset_peak_memory_stats()
    family_f32_gates(seed, cfg, mesh, spec["check_layers"], out)

    # bf16 at full depth: the unsharded phase's weights, laid out, freed.
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model, out["n_params"] = build_model(fam, cfg, gen, tag)
    t0 = time.perf_counter()
    shard_model(model, mesh, policy)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2**30
    print(f"  laid out on {mesh!r} in {out['shard_s']:.2f} s: {resident:.2f} GiB resident",
          flush=True)
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

    if whisper:
        B, plen, n_ctx = WHISPER_SEQS, WHISPER_PROMPT, WHISPER_TEXT_CTX
        frames = torch.randn(B, cfg.encoder_len, cfg.d_model, generator=gen, device=DEVICE) * 0.1
        prompt = {"frames": frames,
                  "tokens": torch.randint(0, cfg.vocab, (B, plen), generator=gen, device=DEVICE)}
        prefill_fn = timed(lambda: fam.prefill(model, prompt, cfg, policy, max_len=n_ctx),
                           "prefill")
        decode_fn = timed(lambda c, t, p: fam.decode_step(model, c, t, p, cfg, policy), "decode")

        @torch.inference_mode()
        def serve():
            logits, cache = prefill_fn()
            toks = [logits[:, :cfg.vocab].argmax(-1)]
            for step in range(1, MAX_NEW):
                logits, cache = decode_fn(cache, toks[-1][:, None], plen + step - 1)
                toks.append(logits[:, :cfg.vocab].argmax(-1))
            return torch.stack(toks, 1).tolist()
        lens = [plen] * B
    else:
        rng = np.random.default_rng(seed)
        lens = [int(n) for n in rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, REQUESTS)]
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)] for n in lens]
        server = Server(cfg, model, max_len=MAX_LEN, device=DEVICE, policy=policy)
        server._prefill = timed(server._prefill, "prefill")
        server._decode = timed(server._decode, "decode")

        def serve():
            done = server.serve([Request(prompt=p, max_new=MAX_NEW) for p in prompts],
                                batch_slots=SLOTS)
            if not all(r.done and len(r.out) == MAX_NEW for r in done):
                fail(f"{tag} serve: a request did not finish with its tokens")
            return [r.out for r in done]

    wrappers = {**model_kernels(), "reduce_nway": reduce_nway}
    zero_counts(wrappers)
    runs = []
    for run in ("cold", "warm"):
        for key in times:
            times[key] = []
        t = time.perf_counter()
        tokens = serve()
        wall = (time.perf_counter() - t) * 1e3
        n_tok = sum(len(o) for o in tokens)
        if not all(0 <= tok < cfg.vocab for o in tokens for tok in o):
            fail(f"{tag} serve: a token outside [0, vocab)")
        runs.append({"run": run, "wall_ms": wall, "tokens": n_tok,
                     "tokens_per_s": n_tok / wall * 1e3, "prefill_ms": list(times["prefill"]),
                     "decode_ms_per_step": sum(times["decode"]) / len(times["decode"]),
                     "decode_steps": len(times["decode"]), "out": tokens})
        print(f"  {tag} serve ({run}): {n_tok} tokens in {wall:.1f} ms ({n_tok / wall * 1e3:.1f} "
              f"tok/s); prefill ms per wave {[round(m, 2) for m in times['prefill']]}, decode "
              f"{runs[-1]['decode_ms_per_step']:.2f} ms per step over {len(times['decode'])} "
              f"steps", flush=True)
    counts = launch_counts(wrappers)
    n_prefills = sum(len(r["prefill_ms"]) for r in runs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if runs[0]["out"] != runs[1]["out"]:
        fail(f"{tag} serve: a second run gave other tokens")
    for name, per in spec["kernels"].items():
        want = per * n_prefills
        if counts[name] != want or (name == "flash_attention"
                                    and counts["flash_attention[tensor_core]"] != want):
            fail(f"{tag} serve launched {name} {counts[name]} times over {n_prefills} prefills, "
                 f"not {per} a prefill (flash on its tensor-core route): {counts}")
    if counts["reduce_nway"] <= 0:
        fail(f"{tag} serve never launched reduce_nway")
    if peak > TP_PEAK_GIB:
        fail(f"{tag}: peak device memory {peak:.2f} GiB above {TP_PEAK_GIB}")
    launches = {"rglru_scan": counts["rglru_scan"], "wkv": counts["wkv"],
                "flash_attention_wgmma": counts["flash_attention[tensor_core]"],
                "flash_attention_mma_sync": counts["flash_attention[mma_sync]"],
                "reduce_nway": counts["reduce_nway"]}
    print(f"  served twice, same tokens; launches {launches} over {n_prefills} prefills; peak "
          f"device memory {peak:.2f} GiB ({resident:.2f} GiB resident)", flush=True)

    # One profiled prefill and decode step of the first wave, beside the
    # unsharded phase's numbers on the same card.
    if whisper:
        wave, S, max_len = prompt, plen, n_ctx
    else:
        width = max(lens[:SLOTS])
        wave = torch.tensor([[0] * (width - len(p)) + p for p in prompts[:SLOTS]],
                            dtype=torch.int64, device=DEVICE)
        S, max_len = width, MAX_LEN
    state = {}

    def prefill():
        state.clear()  # one cache at a time
        state["logits"], state["cache"] = fam.prefill(model, wave, cfg, policy, max_len=max_len)

    def decode():
        nxt = state["logits"].argmax(-1)[:, None]
        fam.decode_step(model, state["cache"], nxt, S, cfg, policy)

    profile_calls(out, {"prefill": prefill, "decode": decode})
    for call in ("prefill", "decode"):
        base = unsharded.get(f"profiled_{call}")
        if base:
            print(f"  {call}: device {out[f'profiled_{call}']['device_ms']:.2f} ms, idle "
                  f"{out[f'profiled_{call}']['idle_share']:.1%} sharded; unsharded device "
                  f"{base['device_ms']:.2f} ms, idle {base['idle_share']:.1%}", flush=True)
    del state
    if cfg.family == "rglru_hybrid":
        out["collectives"] = collective_costs(cfg, mesh, policy, SLOTS, S)
        out["collectives"]["xw gather"] = xw_gather_cost(cfg, mesh, policy, SLOTS, S)
    for r in runs:
        del r["out"]
    out.update(runs=runs, launches=launches, prefills=n_prefills, peak_gib=peak,
               resident_gib=resident, prompt_lens=lens)
    del model
    if not whisper:
        del server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_grad_gate(seed: int, arch: str, seq_parallel: bool) -> dict:
    """12b: ``arch`` at full width, FAMILY_GRAD_LAYERS (None: full depth),
    f32, on a stacked FAMILY_GRAD_MESH mesh: the sharded loss and each
    global gradient leaf against the unsharded model's, within TRAIN_RTOL
    of the leaf's max|g|."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import global_grads, reference_leaves, shard_model

    base = get_config(arch)
    cfg = dataclasses.replace(base, n_layers=FAMILY_GRAD_LAYERS[arch] or base.n_layers,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    fam = get_family(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    model = fam.init(gen, cfg, DEVICE, trainable=True)
    B, S = (2, WHISPER_TEXT_CTX) if cfg.family == "whisper" else MP_GATE_TOKENS
    _, _, batch = family_inputs(cfg, gen, B, S)
    mesh = Mesh(FAMILY_GRAD_MESH, ("data", "model"), device=DEVICE)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    sharded = shard_model(copy.deepcopy(model), mesh, policy).requires_grad_(True)
    names = [n for n, _ in sharded.named_parameters()]
    loss = fam.loss_fn(sharded, batch, cfg, policy)
    got = global_grads(sharded, dict(zip(names, torch.autograd.grad(
        loss, list(sharded.parameters())))))
    del sharded
    want_loss = fam.loss_fn(model, batch, cfg)
    plain = dict(zip(names, torch.autograd.grad(want_loss, list(model.parameters()))))
    want = {leaf: torch.stack([plain[n] for n in ns]) if "*" in leaf else plain[ns[0]]
            for leaf, ns in reference_leaves(plain, cfg).items()}
    if not abs(loss.item() - want_loss.item()) <= TRAIN_RTOL * abs(want_loss.item()):
        fail(f"{arch} sharded f32 gate: loss {loss.item()} against {want_loss.item()}")
    worst, worst_leaf = 0.0, None
    for leaf, g in got.items():
        err, scale = (g - want[leaf]).abs().max().item(), want[leaf].abs().max().item()
        if not bool(torch.isfinite(g).all()) or not err <= TRAIN_RTOL * scale:
            fail(f"{arch} sharded f32 gate: gradient of {leaf} off by {err:.3e}, max|g_plain| "
                 f"{scale:.3e}")
        if scale and err / scale >= worst:
            worst, worst_leaf = err / scale, leaf
    print(f"  {arch} on {FAMILY_GRAD_MESH}, sequence parallelism "
          f"{'on' if seq_parallel else 'off'} ({cfg.n_layers} layers, f32, {B} x {S}"
          f"{f' over {cfg.encoder_len} frames' if cfg.family == 'whisper' else ''}): loss "
          f"{loss.item():.6f} (unsharded {want_loss.item():.6f}); worst global gradient leaf "
          f"{worst_leaf} at {worst:.3e} of its max|g_unsharded| (<= {TRAIN_RTOL})", flush=True)
    out = {"arch": arch, "n_layers": cfg.n_layers, "mesh": list(FAMILY_GRAD_MESH),
           "seq_parallel": seq_parallel, "loss": loss.item(), "unsharded_loss": want_loss.item(),
           "worst_grad_rel": worst, "worst_leaf": worst_leaf}
    del model, got, plain, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_training(seed: int, arch: str, n_layers: int, steps: int, learn: bool) -> dict:
    """12b: ``arch`` at full width, ``n_layers`` layers, bf16, sequence-
    parallel on a stacked FAMILY_TRAIN_MESH mesh through
    ``Trainer(policy=, mesh=)`` on phase 7's RECURRENT_TOKENS; with
    ``learn``, on one repeated batch with phase 7's learning gate."""
    import statistics

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.data import SyntheticLMSource
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch.steps import make_policy
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    B, S = RECURRENT_TOKENS
    mesh = Mesh(FAMILY_TRAIN_MESH, ("data", "model"), device=DEVICE)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed + 1,
                            branching=4)
    if learn:
        src = _Repeat(src)
    batch = {k: torch.from_numpy(v).long().to(DEVICE) for k, v in src.batch_at(0).items()}
    wrappers = {**model_kernels(), "reduce_nway": reduce_nway}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=LEARN_LR if learn else 3e-4),
                                         warmup=2, total_steps=steps), mesh=mesh,
                      policy=make_policy(cfg, mesh, seq_parallel=True))
    zero_counts(wrappers)
    trainer.fit(src, steps=steps, seed=seed)
    per_step = {k: v / steps for k, v in launch_counts(wrappers).items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    dts = [m["dt"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    tag = f"mp train {cfg.name} ({n_layers} layers, bf16, {B} x {S}) on {FAMILY_TRAIN_MESH}"
    if not all(map(math.isfinite, losses)):
        fail(f"{tag}: losses {losses}")
    if learn and not losses[-1] <= losses[0] - LEARN_DROP:
        fail(f"{tag}: losses {losses}, not {LEARN_DROP} nats lower in {steps} steps")
    if not peak < MP_PEAK_GIB:
        fail(f"{tag}: peak {peak:.2f} GiB, not under {MP_PEAK_GIB}")
    kernel = "rglru_scan" if cfg.family == "rglru_hybrid" else "wkv"
    if not per_step.get(kernel) or not per_step.get("reduce_nway[backward]"):
        fail(f"{tag}: launches per step {per_step}")
    step_ms = statistics.median(dts[1:])
    out = {"arch": cfg.name, "n_layers": n_layers, "mesh": list(FAMILY_TRAIN_MESH),
           "seq_parallel": True, "batch": B, "seq": S, "steps": steps, "losses": losses,
           "step_ms": dts, "warm_step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
           "peak_gib": peak, "launches_per_step": per_step}
    note = ""
    if learn:
        out["launch_split"] = split_launches(lambda: trainer._loss(trainer.state[0], batch),
                                             list(trainer.state[0].parameters()))[0]
        out["profiled_step"] = prof = profiled_step(trainer, batch)
        top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in prof["top"][:5])
        note = (f"; split {out['launch_split']}; profiled step: wall {prof['wall_ms']:.1f} ms, "
                f"device {prof['device_ms']:.1f} ms (idle {prof['idle_share']:.1%}): {top}")
    print(f"  {tag}, sequence-parallel: losses {[round(x, 4) for x in losses]}"
          f"{f' (at least {LEARN_DROP} nats lower)' if learn else ''}; warm step {step_ms:.1f} "
          f"ms (median of steps 2-{steps}), {out['tokens_per_s']:.0f} tokens/s; peak "
          f"{peak:.2f} GiB (under {MP_PEAK_GIB}); launches per step {per_step}{note}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def family_rank_backend(seed: int) -> dict:
    """12c: the rank mesh under NCCL at world size 1 against the stacked
    mesh of one member: each family's smoke config, its sharded prefill,
    loss and global gradients, equal."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import global_grads, shard_model

    t0 = time.perf_counter()
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_families_") as tmp:
        ranked = M.RankMesh((1, 1), ("data", "model"), device=DEVICE,
                            init_method=f"file://{tmp}/rendezvous", rank=0)
        try:
            stacked = M.Mesh((1, 1), ("data", "model"), device=DEVICE)
            for spec in FAMILY_SERVES:
                arch = spec["arch"]
                cfg = get_smoke_config(arch)
                fam = get_family(cfg)
                base = fam.init(torch.Generator(device=DEVICE).manual_seed(seed), cfg, DEVICE)
                gen = torch.Generator(device=DEVICE).manual_seed(seed + 9)
                prompt, _, batch = family_inputs(cfg, gen, *TP_RANK_TOKENS)
                runs = {}
                for kind, mesh in (("ranks", ranked), ("stacked", stacked)):
                    policy = make_policy(cfg, mesh)
                    model = shard_model(copy.deepcopy(base), mesh, policy).requires_grad_(True)
                    with torch.no_grad():
                        logits = fam.prefill(model, prompt, cfg, policy)[0]
                    loss = fam.loss_fn(model, batch, cfg, policy)
                    names = [n for n, _ in model.named_parameters()]
                    grads = global_grads(model, dict(zip(names, torch.autograd.grad(
                        loss, list(model.parameters())))))
                    runs[kind] = (logits, loss.detach(), grads)
                (lr, sr, gr), (ls, ss, gs) = runs["ranks"], runs["stacked"]
                if not (torch.equal(lr, ls) and torch.equal(sr.reshape(()), ss.reshape(()))
                        and all(torch.equal(g, gs[k]) for k, g in gr.items())):
                    fail(f"rank mesh under NCCL: {arch}'s sharded prefill, loss or gradients "
                         f"differ from the stacked mesh's (logits by "
                         f"{(lr - ls).abs().max().item()}, loss {sr.item()} vs {ss.item()})")
                got[arch] = {"max_logit": lr.abs().max().item(), "loss": sr.item(),
                             "grad_leaves": len(gr)}
        finally:
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    print(f"  rank mesh (NCCL, 1 rank, (1, 1)): each family's sharded smoke prefill, loss and "
          f"global gradients equal to the stacked mesh's {got}; {wall:.1f} s", flush=True)
    return {"families": got, "wall_s": wall}


def family_phase(seed: int, serving: dict, smi: str) -> dict:
    """Phase 12 (``smi``: the card's name and power limit); returns its numbers."""
    t0 = time.perf_counter()
    out = {"card": smi}
    for spec in FAMILY_SERVES:
        print(f"[mp families] 12a: {spec['tag']}, {spec['arch']} at full width and depth on a "
              f"stacked {spec['mesh']} mesh; card {smi}", flush=True)
        out[spec["tag"]] = family_serve(seed, spec, serving.get(spec["arch"], {}))
    print(f"[mp families] 12a: yi-6b's sequence-parallel prefill; card {smi}", flush=True)
    out["yi-6b sequence-parallel prefill"] = yi_seq_parallel_check(seed)
    print(f"[mp families] 12b: f32 gradient gates at full width on {FAMILY_GRAD_MESH}; then "
          f"bf16 training on {FAMILY_TRAIN_MESH}; card {smi}", flush=True)
    out["f32_gates"] = [family_grad_gate(seed, spec["arch"], sp) for spec in FAMILY_SERVES
                        for sp in (False, True)]
    out["train"] = [family_training(seed, **spec) for spec in FAMILY_TRAIN]
    print(f"[mp families] 12c: the rank mesh under NCCL; card {smi}", flush=True)
    out["rank_backend"] = family_rank_backend(seed)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[mp families] phase 12 took {out['wall_s']:.1f} s (aim: under "
          f"{FAMILY_BUDGET_S:g} s; not gated); card {smi}", flush=True)
    return out


# Phase 13: the launch dry run (``launch/``).  13a traces the cells of
# tests/progs/dryrun_smoke_prog.py at full size on the production meshes;
# 13b sets one cell's trace against a real run of it; 13c is the
# sequence-split long-context decode, 13d ``attn_bf16_logits``.
DRY_CASES = (("qwen1_5_0_5b", "train_4k"), ("qwen1_5_0_5b", "decode_32k"),
             ("phi3_5_moe", "train_4k"), ("gemma3_12b", "prefill_32k"),
             ("gemma3_12b", "long_500k"), ("rwkv6_3b", "long_500k"),
             ("recurrentgemma_2b", "decode_32k"), ("whisper_base", "train_4k"),
             ("whisper_base", "decode_32k"))
DRY_CELL = ("qwen1_5_0_5b", "train_4k", 2048, 8)  # 13b: arch, shape, cut to seq x batch
DRY_MESH, DRY_STEPS = (2, 4), 3
SEQ_ARCH, SEQ_LAYERS, SEQ_CACHE, SEQ_MESH = "gemma3_12b", 4, 32768, (4, 2)
SEQ_PROMPT, SEQ_DECODES, SEQ_RTOL = 8192 + 300, 4, 1e-5  # the window spans two blocks
BF16_ARCH, BF16_LAYERS, BF16_WAVE, BF16_RTOL = "yi_6b", 4, (4, 2048), 2e-2
LAUNCH_BUDGET_S = 150.0


def dry_cells(smi: str) -> list:
    """13a: every DRY_CASES cell on (16, 16), the train cells on (2, 16, 16)
    too, traced on the card's path (meta tensors, the kernels' ops)."""
    from repro_torch.launch import dryrun

    jobs = [(a, s, False) for a, s in DRY_CASES] + \
        [(a, s, True) for a, s in DRY_CASES if s == "train_4k"]
    rows = []
    for arch, shape, multi in jobs:
        rec = dryrun.run_cell(arch, shape, multi_pod=multi, verbose=False)
        if rec["status"] != "ok":
            fail(f"dry run {arch} x {shape} ({rec['mesh']}): {rec.get('error', rec)}")
        if not (rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0 and rec["bytes_per_device"] > 0):
            fail(f"dry run {arch} x {shape} ({rec['mesh']}): no FLOPs or bytes: {rec}")
        coll = {k: f"{v / 2**30:.2f} GiB" for k, v in sorted(rec["coll_breakdown"].items())}
        print(f"  [{rec['mesh']}] {arch} x {shape}: {rec['status']}, {rec['bottleneck']}-bound, "
              f"roofline fraction {rec['roofline_fraction']:.3f}, "
              f"{rec['bytes_per_device'] / 2**30:.2f} GiB a member, "
              f"{rec['hlo_flops'] / 1e15:.3f} PFLOP, {rec['hlo_bytes'] / 1e12:.2f} TB moved, "
              f"collectives {coll}, launches {rec['launches']}, traced in {rec['trace_s']} s; "
              f"H100 terms {rec['t_compute'] * 1e3:.1f} / {rec['t_memory'] * 1e3:.1f} / "
              f"{rec['t_collective'] * 1e3:.1f} ms", flush=True)
        rows.append(rec)
    return rows


def _input_bytes(inputs) -> int:
    """The bytes of a cell's laid-out inputs (a Python int counts as int32)."""
    from repro_torch.launch.dryrun import _tensors

    return sum(t.numel() * t.element_size() for t in _tensors(inputs)) + \
        sum(4 for x in inputs if isinstance(x, int))


def dry_vs_card(seed: int) -> dict:
    """13b: DRY_CELL built by ``build_cell`` on a stacked DRY_MESH, run for
    real (bf16) and traced; the trace's FLOPs, input bytes and launches
    against the real step's."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.reduce_nway import reduce_nway
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.steps import build_cell

    arch, shape, S, B = DRY_CELL
    cfg = get_config(arch)
    saved = shapes.SHAPES[shape]
    shapes.SHAPES[shape] = shapes.ShapeCell(shape, "train", S, B)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = Mesh(DRY_MESH, ("data", "model"), device=DEVICE)
        built = build_cell(cfg, shape, mesh)
        model, opt_state, batch = built["make_inputs"](seed=seed)
        members = math.prod(DRY_MESH)
        real_bytes = _input_bytes((model, opt_state, batch)) / members
        wrappers = {"flash_attention": flash_attention, "reduce_nway": reduce_nway}
        losses, walls, launches = [], [], None
        for i in range(DRY_STEPS):
            zero_counts(wrappers)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt_state, metrics = built["step_fn"](model, opt_state, batch)
            losses.append(float(metrics["loss"]))
            walls.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, opt_state, metrics = built["step_fn"](model, opt_state, batch)
            torch.cuda.synchronize()
            profiled_wall = (time.perf_counter() - t) * 1e3
        busy = device_breakdown(prof)
        with FlopCounterMode(display=False) as counter:
            model, opt_state, metrics = built["step_fn"](model, opt_state, batch)
        torch.cuda.synchronize()
        real_flops = counter.get_total_flops()
        losses.append(float(metrics["loss"]))
        del model, opt_state, batch, built, metrics
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh=mesh, mesh_name="x".join(map(str, DRY_MESH)),
                              verbose=False, device=DEVICE)  # the path the real steps took
        trace_s = time.perf_counter() - t
    finally:
        shapes.SHAPES[shape] = saved
    if rec["status"] != "ok":
        fail(f"13b: the trace failed: {rec.get('error')}")
    if rec["hlo_flops"] != real_flops:
        fail(f"13b: the trace counts {rec['hlo_flops']} FLOPs, a real step {real_flops}")
    if rec["input_bytes_per_member"] != real_bytes:
        fail(f"13b: the specs give {rec['input_bytes_per_member']} input bytes a member, the "
             f"real inputs {real_bytes}")
    want = {k: rec["launches"].get(k, 0) for k in wrappers}
    if want != launches:
        fail(f"13b: the trace predicts launches {want}, a real step made {launches}")
    if not all(map(math.isfinite, losses)):
        fail(f"13b: losses {losses}")
    step_ms = walls[-1]
    out = {"arch": cfg.name, "mesh": list(DRY_MESH), "batch": B, "seq": S, "losses": losses,
           "step_ms": walls, "profiled_wall_ms": profiled_wall, "device_ms": busy["device_ms"],
           "idle_share": 1 - busy["device_ms"] / step_ms, "peak_gib": peak,
           "flops": real_flops, "input_bytes_per_member": real_bytes, "launches": launches,
           "trace_s": trace_s, "t_compute_ms": rec["t_compute"] * 1e3,
           "t_memory_ms": rec["t_memory"] * 1e3, "t_collective_ms": rec["t_collective"] * 1e3,
           "predicted_peak_gib_x_members": rec["bytes_per_device"] * members / 2**30,
           "device_over_t_compute": busy["device_ms"] / (rec["t_compute"] * 1e3),
           "record": rec}
    top = ", ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in busy["top"][:5])
    print(f"  13b {cfg.name} full ({cfg.n_layers} layers, bf16), {B} x {S} on a stacked "
          f"{DRY_MESH}: steps {[round(w, 1) for w in walls]} ms, losses "
          f"{[round(x, 4) for x in losses]}; profiled step wall {profiled_wall:.1f} ms, device "
          f"{busy['device_ms']:.1f} ms (idle {out['idle_share']:.1%} of the last step's "
          f"wall): {top}; peak {peak:.2f} GiB", flush=True)
    print(f"  13b gates held: FLOPs {real_flops} (trace = real step, FlopCounterMode), input "
          f"bytes a member {real_bytes:.0f} (specs = real inputs), launches {launches} (trace = "
          f"counters); traced in {trace_s:.1f} s", flush=True)
    print(f"  13b the roofline on the H100's constants against the card: t_compute "
          f"{out['t_compute_ms']:.2f} ms, t_memory {out['t_memory_ms']:.2f} ms, t_collective "
          f"{out['t_collective_ms']:.2f} ms ({rec['bottleneck']}-bound) against {busy['device_ms']:.1f} "
          f"device ms ({out['device_over_t_compute']:.1f}x t_compute); predicted peak x "
          f"{members} members {out['predicted_peak_gib_x_members']:.2f} GiB against "
          f"{peak:.2f} GiB allocated (not gated)", flush=True)
    return out


def seq_split_decode(seed: int) -> dict:
    """13c: SEQ_ARCH at full width and SEQ_LAYERS layers, f32, batch 1, a
    cache of SEQ_CACHE cut over "data" on a stacked SEQ_MESH, against the
    unsplit decode on the same weights."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import shard_model

    cfg = dataclasses.replace(get_config(SEQ_ARCH), n_layers=SEQ_LAYERS,
                              param_dtype=torch.float32, compute_dtype=torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = tt.init(gen, cfg, DEVICE)
    tokens = torch.randint(0, cfg.vocab, (1, SEQ_PROMPT + SEQ_DECODES), generator=gen,
                           device=DEVICE)
    mesh = Mesh(SEQ_MESH, ("data", "model"), device=DEVICE)
    policy = dataclasses.replace(make_policy(cfg, mesh, shard_batch=False),
                                 cache_seq_axis="data")
    split = shard_model(copy.deepcopy(model), mesh, policy)
    want, got, ms = [], [], []
    with torch.no_grad():
        _, cache = tt.prefill(model, tokens[:, :SEQ_PROMPT], cfg, max_len=SEQ_CACHE)
        for t in range(SEQ_DECODES):
            want.append(tt.decode_step(model, cache, tokens[:, SEQ_PROMPT + t:SEQ_PROMPT + t + 1],
                                       SEQ_PROMPT + t, cfg)[0])
        del cache
        _, cache = tt.prefill(split, tokens[:, :SEQ_PROMPT], cfg, policy, max_len=SEQ_CACHE)
        for t in range(SEQ_DECODES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = tt.decode_step(split, cache,
                                           tokens[:, SEQ_PROMPT + t:SEQ_PROMPT + t + 1],
                                           SEQ_PROMPT + t, cfg, policy)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append(logits)
    errs = [rel_err(g, w)[1] for g, w in zip(got, want)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    cache_shape = list(cache.k.shape)
    del model, split, cache
    gc.collect()
    torch.cuda.empty_cache()
    if not max(errs) <= SEQ_RTOL:
        fail(f"13c: the sequence-split decode is {max(errs):.3g} of max|logits| off the "
             f"unsplit one (gate {SEQ_RTOL})")
    out = {"arch": cfg.name, "n_layers": SEQ_LAYERS, "mesh": list(SEQ_MESH), "cache": SEQ_CACHE,
           "prompt": SEQ_PROMPT, "cache_shape": cache_shape, "rel_errs": errs,
           "decode_ms": ms, "peak_gib": peak}
    print(f"  13c {cfg.name} full width, {SEQ_LAYERS} layers, f32, batch 1: a cache of "
          f"{SEQ_CACHE} laid out {cache_shape} (sequence over \"data\") on a stacked {SEQ_MESH}; "
          f"prefill {SEQ_PROMPT}, {SEQ_DECODES} decodes within {max(errs):.2e} of max|logits| "
          f"of the unsplit decode (gate {SEQ_RTOL}); decode "
          f"{[round(x, 2) for x in ms]} ms a step; peak {peak:.2f} GiB", flush=True)
    return out


def bf16_logits_prefill(seed: int) -> dict:
    """13d: BF16_ARCH at full width and BF16_LAYERS layers, one bf16 prefill
    wave with ``attn_bf16_logits`` and without it (the flash kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import transformer as tt

    B, S = BF16_WAVE
    base = dataclasses.replace(get_config(BF16_ARCH), n_layers=BF16_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = tt.init(gen, base, DEVICE)
    tokens = torch.randint(0, base.vocab, (B, S), generator=gen, device=DEVICE)
    out, logits = {"arch": base.name, "n_layers": BF16_LAYERS, "wave": list(BF16_WAVE)}, {}
    for flag in (False, True):
        cfg = dataclasses.replace(base, attn_bf16_logits=flag)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts({"flash_attention": flash_attention})
        with torch.no_grad():
            ms = time_ms(lambda: tt.prefill(model, tokens, cfg), 3)
            logits[flag] = tt.prefill(model, tokens, cfg)[0]
        key = "bf16_logits" if flag else "flash"
        out[key] = {"prefill_ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "flash_launches": dict(flash_attention.route_launches)}
    err = rel_err(logits[True], logits[False])[1]
    out["rel_err"] = err
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if not err <= BF16_RTOL:
        fail(f"13d: bf16 logits are {err:.3g} of max|logits| off the flash kernel's "
             f"(gate {BF16_RTOL})")
    if out["bf16_logits"]["flash_launches"]["tensor_core"] or \
            not out["flash"]["flash_launches"]["tensor_core"]:
        fail(f"13d: flash launches {out['flash']['flash_launches']} without the flag, "
             f"{out['bf16_logits']['flash_launches']} with it")
    f, b = out["flash"], out["bf16_logits"]
    print(f"  13d {base.name} full width, {BF16_LAYERS} layers, bf16 prefill of {B} x {S}: "
          f"flash (wgmma) {f['prefill_ms']:.1f} ms, peak {f['peak_gib']:.2f} GiB; bf16 logits "
          f"(plain, (B, H, S, S) scores) {b['prefill_ms']:.1f} ms, peak {b['peak_gib']:.2f} GiB; "
          f"logits within {err:.2e} of max|logits| (gate {BF16_RTOL})", flush=True)
    return out


def launch_phase(seed: int, smi: str) -> dict:
    """Phase 13 (``smi``: the card's name and power limit); returns its numbers."""
    t0 = time.perf_counter()
    out = {"card": smi}
    print(f"[launch] 13a: the dry run of {len(DRY_CASES)} cells at full size on (16, 16), the "
          f"train cells on (2, 16, 16) too, traced on the kernels' path; card {smi}", flush=True)
    out["dry_run"] = dry_cells(smi)
    out["dry_run_s"] = time.perf_counter() - t0
    print(f"[launch] 13a took {out['dry_run_s']:.1f} s; 13b: {DRY_CELL[0]} {DRY_CELL[1]} cut to "
          f"{DRY_CELL[3]} x {DRY_CELL[2]} on {DRY_MESH}, real against traced; card {smi}",
          flush=True)
    out["against_the_card"] = dry_vs_card(seed)
    print(f"[launch] 13c: the sequence-split decode; card {smi}", flush=True)
    out["seq_split_decode"] = seq_split_decode(seed)
    print(f"[launch] 13d: attn_bf16_logits; card {smi}", flush=True)
    out["bf16_logits"] = bf16_logits_prefill(seed)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[launch] phase 13 took {out['wall_s']:.1f} s (aim: under {LAUNCH_BUDGET_S:g} s; "
          f"not gated); card {smi}", flush=True)
    return out


def _sha16(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def fabric_fingerprints() -> dict:
    """The golden fingerprints, computed by the port as the reference's
    tests/test_program.py computes them (the deprecated shims included)."""
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


def storm_sim(side: int, faults=None):
    """One phase of the collective storm on a ``side`` x ``side`` mesh, lowered
    onto one sim as bench_engine.py's storm128 legs and bench_resilience.py
    lower it (barriers and compute are not fabric traffic)."""
    from repro_torch.core.noc.netsim import NoCSim
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.program import from_trace
    from repro_torch.core.noc.program.lower import add_op, effective_params
    from repro_torch.core.noc.program.ops import BarrierOp, ComputeOp
    from repro_torch.core.noc.traffic import collective_storm
    from repro_torch.core.topology import Mesh2D

    prog = from_trace(collective_storm(Mesh2D(side, side), tile_bytes=STORM_TILE, phases=1))
    p = effective_params(prog, PAPER_MICRO, None, None)
    if faults is not None:
        p = dataclasses.replace(p, faults=faults)
    sim = NoCSim(prog.mesh, p)
    for op in prog.ops:
        if not isinstance(op, (BarrierOp, ComputeOp)):
            add_op(sim, op, op.start, p)
    return sim


def sim_doc(sim) -> str:
    """sha256 of a finished run: each stream's done cycle, VC and arrivals on
    every edge, and the arbitration counter."""
    doc = [[[st.done_cycle, st.vc, sorted([a.x, a.y, b.x, b.y, list(arr)]
                                           for (a, b), arr in st.arrivals.items())]
             for st in sim.streams], sim._rr]
    return hashlib.sha256(json.dumps(doc).encode()).hexdigest()


def shard_run(sim, engine: str, **kw):
    """``sim.run`` on a shard engine, held to what its spec resolves to on
    this mesh (``ShardConfig.resolve``), not to what the run reports: every
    region of the grid, and one fork worker for each up to the number asked
    for, with no respawn, retry or degradation to in-process execution (any of
    which still gives the right cycles), and no warning from the engine.
    Returns the profile, the host seconds and the worker counters."""
    from repro_torch.core.noc.shard import parse_shard_engine

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        prof = sim.run(engine=engine, profile=True, **kw)
        secs = time.perf_counter() - t0
    (gx, gy), asked = parse_shard_engine(engine).resolve(sim.mesh)
    want = min(asked, gx * gy) if asked > 1 and gx * gy > 1 else 0
    workers = {k: getattr(prof, k) for k in ("workers", "worker_respawns", "worker_retries",
                                             "worker_degradations")}
    warned = [str(w.message) for w in caught if "shard engine" in str(w.message)]
    if prof.regions != gx * gy:
        fail(f"{engine}: {prof.regions} regions, not the {gx}x{gy} grid it resolves to")
    if (workers["workers"] != want or workers["worker_respawns"] or workers["worker_retries"]
            or workers["worker_degradations"] or warned):
        fail(f"{engine}: not on the {want} fork workers it asked for: {workers} {warned}")
    return prof, secs, workers


def large_mesh_runs(workers: int, ckpt_path: Path) -> tuple[dict, dict, dict]:
    """The 64x64 and 128x128 storms on the heap and shard engines: each
    makespan is the pinned one and all engines give the same run.  The
    serial shard run of the 128x128 storm pauses at half its makespan, writes
    its snapshot to ``ckpt_path`` and runs on from there."""
    from repro_torch.core.noc.resilience import checkpoint

    rows, docs, ckpt = {}, {}, {}
    for side, engines in ((64, ("heap", "shard:1x2:1", f"shard::{workers}")),
                          (128, (f"shard::{workers}", "shard:1x2:1"))):
        want = FABRIC_PINNED[f"storm{side}_makespan"]
        for engine in engines:
            t0 = time.perf_counter()
            sim = storm_sim(side)
            lower_s = time.perf_counter() - t0
            if engine == "heap":
                t0 = time.perf_counter()
                prof = sim.run(engine=engine, profile=True)
                secs, counts = time.perf_counter() - t0, {}
            elif side == 128 and engine == "shard:1x2:1":
                cut = want // 2
                prof, pause_s, _ = shard_run(sim, engine, stop_at=cut)
                if prof.makespan != cut:
                    fail(f"the 128x128 storm paused at cycle {prof.makespan}, not {cut}")
                t0 = time.perf_counter()
                snap = checkpoint(sim, cut)
                snap.save(ckpt_path)
                ckpt = {"cut": cut, "snapshot_bytes": ckpt_path.stat().st_size,
                        "fingerprint": snap.fingerprint, "save_s": time.perf_counter() - t0}
                rest, rest_s, counts = shard_run(sim, engine, start_cycle=cut)
                prof.absorb(rest)
                secs = pause_s + rest_s
            else:
                prof, secs, counts = shard_run(sim, engine)
            counters = prof.counters()
            rows[f"{side}x{side} {engine}"] = {"makespan": prof.makespan, "streams": len(sim.streams),
                                               "lower_s": lower_s, "run_s": secs,
                                               "counters": counters}
            print(f"  storm {side}x{side} on {engine}: {prof.makespan} cycles, "
                  f"{len(sim.streams)} streams; host {lower_s:.2f} s lowering + {secs:.2f} s "
                  f"run; epochs {counters['epochs']}, boundary reconciliations "
                  f"{counters['boundary_reconciliations']}, regions {counters['regions']}, "
                  f"heap pops {counters['heap_pops']}, workers {counts}")
            if prof.makespan != want:
                fail(f"storm {side}x{side} on {engine}: makespan {prof.makespan}, want {want}")
            docs[(side, engine)] = sim_doc(sim)
            del sim
        if len({d for (s, _), d in docs.items() if s == side}) != 1:
            fail(f"storm {side}x{side}: the engines' runs differ")
    return rows, docs, ckpt


def checkpoint_resume(workers: int, ckpt: dict, ckpt_path: Path, want_doc: str) -> dict:
    """Load the 128x128 storm's snapshot, restore it and resume on the fork
    workers: the same run as the uninterrupted one."""
    from repro_torch.core.noc.resilience import Snapshot, restore

    t0 = time.perf_counter()
    loaded = Snapshot.load(ckpt_path)
    resumed = restore(loaded)
    load_s = time.perf_counter() - t0
    prof, resume_s, counts = shard_run(resumed, f"shard::{workers}", start_cycle=ckpt["cut"])
    row = {**ckpt, "makespan": prof.makespan, "load_restore_s": load_s, "resume_s": resume_s,
           "workers": counts}
    print(f"  checkpoint 128x128 at cycle {ckpt['cut']} of the serial shard run: "
          f"{ckpt['snapshot_bytes']} snapshot bytes (sha256 {ckpt['fingerprint'][:16]}); host "
          f"{ckpt['save_s']:.2f} s snapshot + write, {load_s:.2f} s load + restore, "
          f"{resume_s:.2f} s resume on shard::{workers}: {prof.makespan} cycles")
    if loaded.fingerprint != ckpt["fingerprint"]:
        fail("the 128x128 snapshot read back with another fingerprint")
    if ckpt["fingerprint"][:16] != FABRIC_PINNED["storm128_snapshot_sha256"]:
        fail(f"the 128x128 snapshot's fingerprint {ckpt['fingerprint'][:16]} is not the "
             f"reference's {FABRIC_PINNED['storm128_snapshot_sha256']}")
    if prof.makespan != FABRIC_PINNED["storm128_makespan"] or sim_doc(resumed) != want_doc:
        fail(f"the resumed 128x128 run ({prof.makespan} cycles) is not the uninterrupted one")
    return row


def midrun_fault(workers: int) -> dict:
    """bench_resilience.py's mid-run case: pristine, static-fault and mid-run
    fault makespans and the re-lowered streams are the pinned ones, and the
    mid-run fault gives the same run on the shard engine as on heap."""
    from repro_torch.core.noc.faults.model import FaultSet
    from repro_torch.core.noc.resilience import FaultEvent, FaultTimeline, run_with_timeline
    from repro_torch.core.topology import Coord

    t0 = time.perf_counter()
    dead = FaultSet(dead_links=frozenset({(Coord(7, 8), Coord(8, 8))}))
    pristine = storm_sim(16).run(engine="heap")
    static = storm_sim(16, faults=dead).run(engine="heap")
    timeline = FaultTimeline([FaultEvent(pristine // 3, dead)])
    docs, profs = {}, {}
    for engine in ("heap", f"shard:2x2:{workers}"):
        sim = storm_sim(16)
        profs[engine] = run_with_timeline(sim, timeline, engine=engine, profile=True)
        docs[engine] = sim_doc(sim)
    prof = profs["heap"]
    got = {"midrun_pristine": pristine, "midrun_static": static, "midrun_fault": prof.makespan,
           "midrun_relowered": prof.relowered_streams, "midrun_dropped": prof.dropped_streams}
    secs = time.perf_counter() - t0
    print(f"  mid-run fault, 16x16 storm, link (7,8)->(8,8) dead at cycle {pristine // 3}: "
          f"{got}; host {secs:.2f} s")
    bad = {k: (v, FABRIC_PINNED[k]) for k, v in got.items() if v != FABRIC_PINNED[k]}
    if bad:
        fail(f"mid-run fault differs from the reference's (got, want): {bad}")
    if len(set(docs.values())) != 1 or len({p.makespan for p in profs.values()}) != 1:
        fail("the mid-run fault gives another run on the shard engine than on heap")
    return {**got, "event_cycle": pristine // 3, "host_s": secs}


def telemetry_run(workers: int) -> dict:
    """A Collector on bench_telemetry.py's 16x16 transpose under xy with 2
    VCs, on heap and on the fork workers: equal FabricStats, and the pinned
    peak link utilisation."""
    from repro_torch.core.noc.params import PAPER_MICRO
    from repro_torch.core.noc.telemetry import Collector
    from repro_torch.core.noc.traffic import SyntheticConfig, replay, synthetic_trace
    from repro_torch.core.topology import Mesh2D

    trace = synthetic_trace(Mesh2D(16, 16), SyntheticConfig(**TELEMETRY_CASE))
    stats, secs = {}, {}
    for engine in ("heap", f"shard:2x2:{workers}"):
        col = Collector()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            replay(trace, params=PAPER_MICRO, routing="xy", num_vcs=2, engine=engine,
                   telemetry=col)
            secs[engine] = time.perf_counter() - t0
        warned = [str(w.message) for w in caught if "shard engine" in str(w.message)]
        if warned:
            fail(f"telemetry run on {engine}: {warned}")
        stats[engine] = col.stats()
    base = stats["heap"]
    if any(st != base for st in stats.values()):
        fail("FabricStats differ between heap and the shard engine")
    hot = base.link_table(4)
    peak = hot[0]["utilization"]
    print(f"  telemetry, 16x16 transpose (xy, 2 VCs): busy {base.total_busy_beats()} beats, "
          f"peak link utilisation {peak}; host s {secs}; hottest links:")
    for row in hot:
        print(f"    {row}")
    if peak != FABRIC_PINNED["telemetry_peak_utilization"]:
        fail(f"peak link utilisation {peak}, want {FABRIC_PINNED['telemetry_peak_utilization']}")
    return {"busy_beats": base.total_busy_beats(), "peak_link_utilization": peak,
            "hot_links": hot, "host_s": secs}


def drain(srv) -> bool:
    """Drain ``srv``: True when every job it accepted finished.  The drain
    closes the listening socket, which does not wake the server's thread
    blocked in accept() on it (its close() would wait 5 s for that thread);
    a connection made after the drain wakes it, and it exits."""
    final = srv.drain(timeout=30)
    with contextlib.suppress(OSError), socket.socket(socket.AF_UNIX) as wake:
        wake.connect(srv.path)
    return final["jobs"]["submitted"] == final["jobs"]["done"] and final["queue_depth"] == 0


def service_run(tmp: Path) -> dict:
    """bench_service.py's grid through a SimulationServer with 2 fork
    workers, cold then warm (all memo hits), then a fresh server on the same
    store (all store hits); every row equals a direct saturation_sweep."""
    import multiprocessing

    from repro_torch.core.noc.service import ServiceClient, SimulationServer
    from repro_torch.core.noc.traffic.sweep import saturation_sweep
    from repro_torch.core.topology import Mesh2D

    n = len(SERVICE_GRID["rates"])
    grid = {k: v for k, v in SERVICE_GRID.items() if k not in ("mesh", "pattern", "rates")}
    t0 = time.perf_counter()
    direct = saturation_sweep(Mesh2D(*SERVICE_GRID["mesh"]), SERVICE_GRID["pattern"],
                              SERVICE_GRID["rates"], **grid)
    out = {"direct_s": time.perf_counter() - t0}
    store = str(tmp / "results.jsonl")
    servers = []

    def serve(**kw):
        srv = SimulationServer(chunk_tokens=3, store=store, **kw)
        servers.append(srv)
        return srv

    try:
        srv = serve(workers=2)
        with ServiceClient(srv.path) as cli:
            for leg in ("cold", "warm"):
                t0 = time.perf_counter()
                pts = cli.submit_sweep(**SERVICE_GRID).sweep_points()
                out[f"{leg}_s"] = time.perf_counter() - t0
                if pts != direct:
                    fail(f"the service's {leg} rows differ from the direct sweep")
            first = cli.stats()
        drain(srv)  # flushes the store that the restarted server reads
        srv = serve(workers=0)
        with ServiceClient(srv.path) as cli:
            t0 = time.perf_counter()
            pts = cli.submit_sweep(**SERVICE_GRID).sweep_points()
            out["restart_s"] = time.perf_counter() - t0
            second = cli.stats()
        if pts != direct:
            fail("the restarted service's rows differ from the direct sweep")
    finally:
        drained = [drain(srv) for srv in servers]
        for srv in servers:
            srv.close()
    left = multiprocessing.active_children()
    p1, p2 = first["points"], second["points"]
    out.update(points=n, memo_hits=p1["memo_hits"], computed=p1["computed"],
               workers=first["workers"], degraded=first["degraded"],
               worker_respawns=first["worker_respawns"], chunk_retries=first["chunk_retries"],
               store_hits=p2["store_hits"], restart_computed=p2["computed"])
    print(f"  service, {SERVICE_GRID['mesh']} {SERVICE_GRID['pattern']} grid of {n} rates: "
          f"cold {out['cold_s']:.3f} s, warm {out['warm_s']:.4f} s ({p1['memo_hits']} memo "
          f"hits), restart {out['restart_s']:.4f} s ({p2['store_hits']} store hits), direct "
          f"{out['direct_s']:.3f} s (host); workers {first['workers']}, degraded "
          f"{first['degraded']}, respawns {first['worker_respawns']}, chunk retries "
          f"{first['chunk_retries']}")
    if not all(drained) or left:
        fail(f"a server did not drain (drained {drained}, processes left {left})")
    if (first["workers"] != 2 or first["degraded"] or first["worker_respawns"]
            or first["chunk_retries"]):
        fail(f"the service did not run on its 2 fork workers: {first}")
    if (p1["computed"], p1["memo_hits"]) != (n, n) or (p2["store_hits"], p2["computed"]) != (n, 0):
        fail(f"service accounting: first server {p1}, restarted {p2}")
    return out


def fabric_phase(walls: dict) -> dict:
    """Phase 8: the goldens, the paper's claims, phase 3's schedules as
    fabric programs beside its measured walls, the overlap gate, and the
    simulator's runtime half at the reference's largest sizes."""
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

    # The runtime half: large meshes on the shard engine, checkpoint and
    # resume, a mid-run fault, telemetry and the simulation service.
    workers = min(4, os.cpu_count() or 1)
    print(f"[fabric] runtime half on the host: {os.cpu_count()} CPUs, shard workers {workers}")
    parts = {"paper_half": time.perf_counter() - t0}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fabric_") as tmp:
        ckpt_path = Path(tmp) / "storm128.ckpt.json"
        large, docs, ckpt = part("large_mesh", large_mesh_runs, workers, ckpt_path)
        ckpt = part("checkpoint", checkpoint_resume, workers, ckpt, ckpt_path,
                    docs[(128, f"shard::{workers}")])
        midrun = part("midrun_fault", midrun_fault, workers)
        telemetry = part("telemetry", telemetry_run, workers)
        service = part("service", service_run, Path(tmp))
    print("  host seconds of each part: " + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()))

    wall = time.perf_counter() - t0
    print(f"[fabric] phase 8 took {wall:.2f} s (budget {FABRIC_BUDGET_S:g} s)")
    if wall > FABRIC_BUDGET_S:
        fail(f"phase 8 took {wall:.1f} s, over its budget of {FABRIC_BUDGET_S:g} s")
    return {"units": "simulated cycles (PAPER_MICRO fabric), not card time",
            "goldens": len(want), "claims": {c.name: [c.paper_value, c.achieved]
                                              for c in claims},
            "tile_bytes": FABRIC_BYTES, "summa_4x4": summa, "fcl_all_reduce_x8": fcl,
            "rings_x8": rings, "overlap": overlap, "cpu_count": os.cpu_count(),
            "shard_workers": workers, "large_mesh": large, "checkpoint": ckpt,
            "midrun_fault": midrun, "telemetry": telemetry, "service": service,
            "part_host_s": parts, "host_s": wall}


# ---------------------------------------------------------------------------
# Phase 14: the examples
# ---------------------------------------------------------------------------


def example_pinned(name: str, lines: list):
    """Fail unless every pinned line of example ``name`` is in its output."""
    missing = [t for t in EXAMPLE_PINNED.get(name, ()) if not any(t in ln for ln in lines)]
    if missing:
        fail(f"example {name}: missing the reference's lines {missing}")


def card_example(name: str) -> dict:
    """Example ``name`` through its main on the card: its printed lines
    gated, its kernels' launches counted (they must all have launched)."""
    import importlib
    import io

    from repro_torch.kernels.gemm import gemm
    from repro_torch.kernels.reduce_nway import reduce_nway

    wrappers = {**model_kernels(), "gemm": gemm, "reduce_nway": reduce_nway}
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    zero_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        got = mod.main(["--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts(wrappers).items() if v}
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"    | {ln}")
    example_pinned(name, lines)
    if not all(counts.get(k) for k in EXAMPLES_CARD[name]):
        fail(f"example {name}: launches {counts}, not every one of {EXAMPLES_CARD[name]}")
    out = {"wall_s": wall, "launches": counts}
    if name == "quickstart":
        losses, tokens, vocab = got["losses"], got["tokens"], got["vocab"]
        if not (all(map(math.isfinite, losses)) and losses[-1] < math.log(vocab) - 1.0):
            fail(f"quickstart: losses {losses[0]} -> {losses[-1]}, not a nat below "
                 f"ln({vocab})")
        if len(tokens) != 12 or not all(0 <= t < vocab for t in tokens):
            fail(f"quickstart: generated {tokens}")
        out.update(first_loss=losses[0], last_loss=losses[-1], tokens=tokens)
    elif name == "fault_tolerance":
        want = {"checkpoints": [5, 10, 12], "resumed_at": 13, "ran_to": 20, "recovered_from": 15}
        if got != want:
            fail(f"fault_tolerance: {got}, not the reference's {want}")
        out.update(got)
    else:
        errs = {f"summa {k}": r["max_err"] for k, r in got["summa"].items()}
        errs.update({f"fcl {k}": e for k, e in got["fcl"].items()},
                    ag_matmul=got["ag_matmul"], matmul_rs=got["matmul_rs"])
        if len(errs) != 10 or not all(0.0 <= e <= EXAMPLE_RTOL for e in errs.values()):
            fail(f"distributed_gemm: max_err {errs}, above {EXAMPLE_RTOL}")
        out.update(max_err=errs, summa_us={k: r["us"] for k, r in got["summa"].items()},
                   cost_path=got["cost_path"])
    print(f"  {name}: {wall:.1f} s, launches {counts}", flush=True)
    return out


def host_example(name: str) -> dict:
    """Example ``name`` as ``python -m`` under a timeout: exit 0 and its
    pinned lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                          capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S, env=env,
                          cwd=ROOT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"example {name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    example_pinned(name, lines)
    print(f"  {name} (python -m, host): exit 0, {len(lines)} lines, its pinned lines "
          f"present; {wall:.1f} s", flush=True)
    return {"wall_s": wall, "lines": len(lines)}


def examples_phase(smi: str) -> dict:
    """Phase 14; returns each example's numbers and the phase's wall."""
    t0 = time.perf_counter()
    print("[examples] src/repro_torch/examples: the card ones in-process on the card, the "
          "host ones as python -m")
    out = {}
    for name in EXAMPLES_CARD:
        out[name] = card_example(name)
        gc.collect()
        torch.cuda.empty_cache()
    for name in EXAMPLES_HOST:
        out[name] = host_example(name)
    us = ", ".join(f"{k} {v:.1f}" for k, v in out["distributed_gemm"]["summa_us"].items())
    print(f"  distributed_gemm SUMMA 512^3 on a stacked (2, 2) mesh, us a call (mean of 10 "
          f"after a warm one): {us}; card: {smi}")
    wall = time.perf_counter() - t0
    out["wall_s"] = wall
    print(f"[examples] phase 14 took {wall:.1f} s (aim: under {EXAMPLES_AIM_S:.0f} s, not "
          "gated)", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    started = time.perf_counter()
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

    # 4-6c. Serving yi-6b, recurrentgemma-2b, rwkv6-3b, moonshot-v1-16b-a3b,
    # phi3.5-moe (f32 checks only) and whisper-base; each kernel's entry takes
    # its launches from the first model that runs it, and keeps every
    # model's in ``launches_by_model``.  flash_attention's mma_sync route
    # counts the f32 checks of a phase, its tensor-core route the bf16 serve
    # (or whisper's generation).
    serving, by_model = {}, {}
    for spec in SERVES:
        serving[spec["arch"]] = serve_phase(args.seed, **spec)
    serving["whisper_base"] = whisper_phase(args.seed)
    for arch, served in serving.items():
        counts = {name: c["mma_sync"] for name, c in served["f32_route_launches"].items()}
        for name, n in served.get("launches", {}).items():
            routes = served["route_launches"].get(name)
            counts[name + "_wgmma" if routes else name] = routes["tensor_core"] if routes else n
        for name, n in counts.items():
            launches.setdefault(name, n)
            by_model.setdefault(name, {})[arch] = n

    # 7. Training; its launches are gated inside the phase.
    training = training_phase(args.seed, gen)
    grad_rows = {(r["kernel"], r["route"]): r for r in training["kernel_grads"]}

    # 8. The fabric programs of the main path, on the host.
    fabric = fabric_phase(walls)

    # 9. Data-parallel training; its launches are gated inside the phase and
    # join each kernel's launches_by_model.
    dp = dp_phase(args.seed)
    dp_launches = dp["train"]["launches"]
    by_model.setdefault("reduce_nway", {})["dp_train qwen1.5-0.5b x4"] = \
        dp_launches["reduce_nway"]
    by_model.setdefault("flash_attention_wgmma", {})["dp_train qwen1.5-0.5b x4"] = \
        dp_launches["flash_attention[tensor_core]"]

    # 10. Model-parallel serving; its launches are gated inside the phase
    # and join each kernel's launches_by_model.
    mp = tp_phase(args.seed, serving, smi)
    for spec in TP_SERVES:
        tp_launches = mp[spec["tag"]]["launches"]
        for name in ("reduce_nway", "flash_attention_wgmma"):
            by_model.setdefault(name, {})[spec["tag"]] = tp_launches[name]

    # 11. Model-parallel training; its launches are gated inside the phase and
    # join each kernel's launches_by_model; reduce_nway's gradient row is its.
    mpt = mp_phase(args.seed, training, dp, smi)
    mp_launches, tag = mpt["train"]["launches"], "mp_train qwen1.5-0.5b (2,4) sp"
    by_model.setdefault("reduce_nway", {})[tag] = mp_launches["reduce_nway"]
    by_model["reduce_nway"][tag + " backward"] = mp_launches["reduce_nway[backward]"]
    by_model.setdefault("flash_attention_wgmma", {})[tag] = \
        mp_launches["flash_attention[tensor_core]"]
    grad_rows[("reduce_nway", None)] = mpt["train"]["grad_row"]

    # 12. Sharded serving and training of the hybrid, rwkv6 and whisper; its
    # launches are gated inside the phase and join launches_by_model.
    fams = family_phase(args.seed, serving, smi)
    for spec in FAMILY_SERVES:
        for name, n in fams[spec["tag"]]["launches"].items():
            if n and name != "flash_attention_mma_sync":
                by_model.setdefault(name, {})["12a " + spec["tag"]] = n
    for tr in fams["train"]:
        tag = f"12b mp_train {tr['arch']} {tuple(tr['mesh'])} sp"
        for name, key in (("rglru_scan", "rglru_scan"), ("wkv", "wkv"),
                          ("flash_attention_wgmma", "flash_attention[tensor_core]"),
                          ("reduce_nway", "reduce_nway")):
            if tr["launches_per_step"].get(key):
                by_model.setdefault(name, {})[tag] = tr["launches_per_step"][key] * tr["steps"]

    # 13. The launch dry run, its roofline against the card, the
    # sequence-split decode and bf16 logits; gated inside the phase.
    launch = launch_phase(args.seed, smi)
    tag = f"13b dry-run cell {DRY_CELL[0]} {DRY_MESH}"
    for name, key in (("reduce_nway", "reduce_nway"), ("flash_attention_wgmma", "flash_attention")):
        by_model.setdefault(name, {})[tag] = launch["against_the_card"]["launches"][key]

    # 14. The examples; their launches are gated inside the phase and join
    # launches_by_model.
    examples = examples_phase(smi)
    for name, key in (("flash_attention", "flash_attention[mma_sync]"),
                      ("gemm", "gemm[cuda_core]"), ("reduce_nway", "reduce_nway")):
        for ex in EXAMPLES_CARD:
            if examples[ex]["launches"].get(key):
                by_model.setdefault(name, {})[f"14 examples {ex}"] = examples[ex]["launches"][key]

    # 15. Result lines.  Each route of a kernel is an entry of its own.
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
                "launches_by_model": by_model.get(name, {}),
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
    print(f"[chip_smoke] phases 1-14 took {time.perf_counter() - started:.1f} s")
    print(json.dumps({"main_path": walls}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"fabric": fabric}))
    print(json.dumps({"data_parallel": dp}))
    print(json.dumps({"model_parallel": mp}))
    print(json.dumps({"model_parallel_training": mpt}))
    print(json.dumps({"model_parallel_families": fams}))
    print(json.dumps({"launch": launch}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
