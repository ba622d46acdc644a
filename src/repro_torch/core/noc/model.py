"""The paper's analytical runtime models.

Implements, verbatim, Equations (1)-(9) and the 2-D generalizations
(10)-(15), together with the optimal-batch-count search the paper assumes
("the optimal batch size is assumed for the seq implementation") and the
``best software implementation on a case-by-case basis'' selection used in
Section 4.3.

All times are in cycles; ``n`` is a transfer size in *beats* (64 B each).

Multicast (one row, ``c`` clusters; Section 4.2.2):
  T_naive = sum_{i=1..c}     (alpha_i + n*beta + delta)      - delta     (1)
  T_seq   = sum_{i=1..k+c-1} (alpha_i + (n/k)*beta + delta)  - delta     (2)
  T_tree  = sum_{i=0..log2 c}(alpha_i + n*beta + delta)      - 2*delta   (3)
  T_hw    = alpha + (n + c - 1)*beta                                     (4)

Reduction (one row, ``c`` clusters; Section 4.2.3), with
``t_m = alpha_m + (n/k) beta_m`` and ``t_c = alpha_c + (n/k) beta_c``:
  T_seq   = t_m + 2(c-2) max(t_m,t_c) + k t_c + (2(c-2)+k) delta         (5)
  T_tree  = {t_m + delta + (k-1)[max(t_m,t_c)+delta] + t_c} log2 c       (6)

2-D forms: Eqs (10)-(15) in Appendix B.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.noc.params import NoCParams


def _log2i(v: int) -> int:
    if v < 1 or (v & (v - 1)) != 0:
        raise ValueError(f"expected a power of two, got {v}")
    return v.bit_length() - 1


# ---------------------------------------------------------------------------
# Stage-distance helpers.  alpha_i depends on the hop distance of the DMA
# transfer performed at stage i (round trip, Section 2.2).
# ---------------------------------------------------------------------------


def _naive_stage_hops(c: int, fetch_hops: int = 1) -> list[int]:
    """Naive-sequential 1-D multicast: initial fetch + c-1 neighbour copies."""
    return [fetch_hops] + [1] * (c - 1)


def _tree_stage_hops(c: int, fetch_hops: int = 1) -> list[int]:
    """Binary-tree 1-D multicast: fetch, then halving distances c/2, ..., 1."""
    return [fetch_hops] + [c >> (i + 1) for i in range(_log2i(c))]


# ---------------------------------------------------------------------------
# Multicast models (Eqs 1-4 and 10-13).
# ---------------------------------------------------------------------------


def multicast_naive(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    """Eq (1) / Eq (10): naive sequential multicast to a c x r sub-grid."""
    hops = _naive_stage_hops(c)
    if r > 1:
        hops += [1] * (r - 1)  # column copies, pipelined per Fig. 11
    return sum(p.alpha(h) + n * p.beta + p.delta for h in hops) - p.delta


def multicast_seq(p: NoCParams, n: int, c: int, r: int = 1, k: int | None = None) -> float:
    """Eq (2) / Eq (11): pipelined sequential multicast with k batches."""

    def at_k(k: int) -> float:
        stages = k + c - 1 + (r - 1 if r > 1 else 0)
        # All stage transfers are neighbour copies except the initial fetch.
        total = 0.0
        for i in range(stages):
            h = 1
            total += p.alpha(h) + (n / k) * p.beta + p.delta
        return total - p.delta

    if k is not None:
        return at_k(k)
    return min(at_k(k) for k in _k_candidates(n))


def multicast_tree(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    """Eq (3) / Eq (12): binary-tree multicast."""
    hops = _tree_stage_hops(c)
    if r > 1:
        hops += [r >> (i + 1) for i in range(_log2i(r))]
    return sum(p.alpha(h) + n * p.beta + p.delta for h in hops) - 2 * p.delta


def multicast_hw(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    """Eq (4) / Eq (13): in-network multicast (single pipelined stream)."""
    drain = (c - 1) + (r - 1)
    return p.alpha(1) + (n + drain) * p.beta


def multicast_sw_best(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    """min(T_seq, T_tree) as used throughout Section 4."""
    return min(multicast_seq(p, n, c, r), multicast_tree(p, n, c, r))


# ---------------------------------------------------------------------------
# Reduction models (Eqs 5-6 and 14-15).
# ---------------------------------------------------------------------------


def _tm_tc(p: NoCParams, n: int, k: int) -> tuple[float, float]:
    t_m = p.alpha(1) + (n / k) * p.beta
    t_c = p.alpha_c + (n / k) * p.beta_c
    return t_m, t_c


def reduction_seq(p: NoCParams, n: int, c: int, r: int = 1, k: int | None = None) -> float:
    """Eq (5) / Eq (15): pipelined sequential reduction."""

    def at_k(k: int) -> float:
        t_m, t_c = _tm_tc(p, n, k)
        mx = max(t_m, t_c)
        if r <= 1:
            return t_m + 2 * (c - 2) * mx + k * t_c + (2 * (c - 2) + k) * p.delta
        return (
            t_m
            + 2 * (c - 2) * mx
            + (k - 1) * t_c
            + mx
            + 2 * (r - 2) * mx
            + k * t_c
            + (2 * (c - 2) + 2 * (r - 2) + 2 * k) * p.delta
        )

    if k is not None:
        return at_k(k)
    return min(at_k(k) for k in _k_candidates(n))


def reduction_tree(p: NoCParams, n: int, c: int, r: int = 1, k: int | None = None) -> float:
    """Eq (6) / Eq (14): double-buffered tree reduction."""

    def at_k(k: int) -> float:
        t_m, t_c = _tm_tc(p, n, k)
        mx = max(t_m, t_c)
        stages = _log2i(c) + (_log2i(r) if r > 1 else 0)
        return (t_m + p.delta + (k - 1) * (mx + p.delta) + t_c) * stages

    if k is not None:
        return at_k(k)
    return min(at_k(k) for k in _k_candidates(n))


def reduction_hw(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    """In-network reduction.

    1-D: a single pipelined stream joined along the row,
    ``alpha + (n + c - 1) beta``.  2-D: the routers in the collecting column
    see three-input joins; with the single 2-input wide-reduction unit per
    router (Section 3.1.4) the fully-reduced throughput halves — the paper
    measures a 1.9x slowdown on 32 KiB going 1-D -> 2-D (Section 4.2.3).
    """
    if r <= 1:
        return p.alpha(1) + (n + c - 1) * p.beta
    eff_beta = 2.0 * p.beta  # 3-input joins -> 2 two-input ops per beat
    return p.alpha(1) + (n * eff_beta) + (c - 1 + r - 1) * p.beta


def reduction_sw_best(p: NoCParams, n: int, c: int, r: int = 1) -> float:
    return min(reduction_seq(p, n, c, r), reduction_tree(p, n, c, r))


def _k_candidates(n: int) -> list[int]:
    """Batch counts searched for the optimal-k schedules.

    Dense up to 64 (where the optimum of Eq. 2/5 lives for realistic
    alpha/delta), coarse beyond, always including k = n (the Fig. 5b
    beat-granularity limit)."""
    ks = set(range(1, min(64, max(1, n)) + 1))
    ks.update({80, 96, 128, 192, 256, 384, 512, 768, 1024, max(1, n)})
    return sorted(k for k in ks if k <= max(1, n))


# ---------------------------------------------------------------------------
# GEMM-level models (Section 4.3).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmPoint:
    """One steady-state iteration of a distributed GEMM on an s x s mesh."""

    mesh: int
    t_comp: float
    t_comm_sw: float
    t_comm_hw: float

    @property
    def t_sw(self) -> float:
        return max(self.t_comp, self.t_comm_sw)

    @property
    def t_hw(self) -> float:
        return max(self.t_comp, self.t_comm_hw)

    @property
    def speedup(self) -> float:
        return self.t_sw / self.t_hw

    @property
    def sw_bound(self) -> str:
        return "comm" if self.t_comm_sw > self.t_comp else "comp"

    @property
    def hw_bound(self) -> str:
        return "comm" if self.t_comm_hw > self.t_comp else "comp"


def summa_point(p: NoCParams, mesh: int, tile: int = 16, dtype_bytes: int = 8) -> GemmPoint:
    """SUMMA steady-state iteration (Section 4.3.1, Fig. 9a).

    Each cluster computes a ``tile^3`` sub-problem; A_{i,k} is multicast
    along row i and B_{k,j} along column j.  The software path serializes
    the two collectives on the cluster DMA engine; the hardware path streams
    them from independent memory tiles concurrently (see NoCParams).
    """
    n = p.beats(tile * tile * dtype_bytes)
    t_comp = (tile**3) / (p.gemm_utilization * p.macs_per_cycle)
    one_sw = multicast_sw_best(p, n, mesh)
    one_hw = multicast_hw(p, n, mesh)
    t_comm_sw = 2 * one_sw if p.sw_gemm_serializes_ab else one_sw
    t_comm_hw = max(one_hw, one_hw)  # A and B streams overlap
    return GemmPoint(mesh, t_comp, t_comm_sw, t_comm_hw)


def fcl_point(p: NoCParams, mesh: int, tile: int = 16, dtype_bytes: int = 8) -> GemmPoint:
    """FusedConcatLinear GEMM (Section 4.3.2, Fig. 9b).

    A GEMM distributed along K (one attention head per cluster); the
    partial C tiles are reduced across the full mesh.  The reduction phase
    strictly follows compute (footnote 8), so runtime is additive:
    ``T = T_comp + T_red``.
    """
    n = p.beats(tile * tile * dtype_bytes)
    t_comp = (tile**3) / (p.gemm_utilization * p.macs_per_cycle)
    red_sw = reduction_sw_best(p, n, mesh, r=mesh if mesh > 1 else 1)
    red_hw = reduction_hw(p, n, mesh, r=mesh if mesh > 1 else 1)
    # Additive composition (communication always on the critical path here):
    return GemmPoint(
        mesh,
        t_comp=0.0,  # unused for additive composition; keep totals below
        t_comm_sw=t_comp + red_sw,
        t_comm_hw=t_comp + red_hw,
    )


def fcl_speedup(p: NoCParams, mesh: int, tile: int = 16) -> float:
    pt = fcl_point(p, mesh, tile)
    return pt.t_comm_sw / pt.t_comm_hw


def summa_sweep(p: NoCParams, meshes=(4, 8, 16, 32, 64, 128, 256), tile: int = 16):
    return [summa_point(p, m, tile) for m in meshes]


def fcl_sweep(p: NoCParams, meshes=(2, 4, 8, 16, 32, 64, 128, 256), tile: int = 16):
    return [(m, fcl_speedup(p, m, tile)) for m in meshes]


# ---------------------------------------------------------------------------
# Barrier model (Section 4.2.1, Fig. 2b).
# ---------------------------------------------------------------------------


def barrier_sw(p: NoCParams, clusters: int) -> float:
    return p.barrier_sw(clusters)


def barrier_hw(p: NoCParams, clusters: int) -> float:
    return p.barrier_hw(clusters)


def geomean(vals) -> float:
    vals = [v for v in vals if v > 0]
    return math.exp(sum(math.log(v) for v in vals) / len(vals)) if vals else 0.0
