"""Validation of the paper's numeric claims against the reproduced models.

Each entry declares the claim from the paper, the achieved value from our
models/simulator and an acceptance tolerance.  ``benchmarks.run`` prints
the table; ``tests/test_noc_claims.py`` asserts every row.

Two calibration regimes:

* :func:`all_claims` — the paper's own idle-network microbenchmark and
  GEMM claims (analytical models, no contention).
* :func:`load_claims` — saturation-aware checks: given a measured
  ``traffic.sweep`` curve, validates that at a chosen offered load the
  network still behaves like the calibrated model (latency inflation
  bounded, delivered throughput tracking offered load, load below the
  saturation knee).  This is what lets model alphas/betas be sanity-
  checked *under load*, not just on an idle network.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.noc import energy as noc_energy
from repro_torch.core.noc import model as m
from repro_torch.core.noc.params import NoCParams, PAPER_GEMM, PAPER_MICRO

KIB = 1024
SIZES_1_32K = [1 * KIB, 2 * KIB, 4 * KIB, 8 * KIB, 16 * KIB, 32 * KIB]


@dataclasses.dataclass(frozen=True)
class Claim:
    name: str
    paper_value: float
    achieved: float
    rel_tol: float

    @property
    def ok(self) -> bool:
        if self.paper_value == 0:
            return abs(self.achieved) <= self.rel_tol
        return abs(self.achieved - self.paper_value) <= self.rel_tol * abs(self.paper_value)


def multicast_speedups(p: NoCParams = PAPER_MICRO, c: int = 4, r: int = 1) -> list[float]:
    out = []
    for size in SIZES_1_32K:
        n = p.beats(size)
        out.append(m.multicast_sw_best(p, n, c, r) / m.multicast_hw(p, n, c, r))
    return out


def reduction_speedups(p: NoCParams = PAPER_MICRO, c: int = 4, r: int = 1) -> list[float]:
    out = []
    for size in SIZES_1_32K:
        n = p.beats(size)
        out.append(m.reduction_sw_best(p, n, c, r) / m.reduction_hw(p, n, c, r))
    return out


def all_claims() -> list[Claim]:
    p = PAPER_MICRO
    g = PAPER_GEMM

    # Measurement set mirrors the paper's figures: the 1-D size sweep
    # (Figs 5a/7a) plus the 2-D row sweeps at 32 KiB (Figs 5c/7b).
    def two_d(points_fn):
        n32 = p.beats(32 * KIB)
        return [points_fn(p, n32, 4, r) for r in (2, 4)]

    mc_1d = multicast_speedups(p)
    mc_all = mc_1d + two_d(
        lambda p, n, c, r: m.multicast_sw_best(p, n, c, r) / m.multicast_hw(p, n, c, r)
    )
    rd_1d = reduction_speedups(p)
    rd_all = rd_1d + two_d(
        lambda p, n, c, r: m.reduction_sw_best(p, n, c, r) / m.reduction_hw(p, n, c, r)
    )

    summa = m.summa_sweep(g)
    summa_speedups = [pt.speedup for pt in summa]
    fcl = dict(m.fcl_sweep(g))

    n32 = p.beats(32 * KIB)
    red_1d_32k = m.reduction_hw(p, n32, 4, 1)
    red_2d_32k = m.reduction_hw(p, n32, 4, 4)

    claims = [
        Claim("multicast geomean speedup (abstract: 2.9x, 1-32 KiB)", 2.9,
              m.geomean(mc_all), 0.15),
        Claim("multicast 1D min speedup (4.2.2: 2.3x)", 2.3, min(mc_1d), 0.15),
        Claim("multicast 1D max speedup (4.2.2: 3.2x)", 3.2, max(mc_1d), 0.15),
        Claim("reduction geomean speedup (abstract: 2.5x, 1-32 KiB)", 2.5,
              m.geomean(rd_all), 0.15),
        Claim("reduction 1D min speedup (4.2.3: 2.0x)", 2.0, min(rd_1d), 0.2),
        Claim("reduction 1D max speedup (4.2.3: 3.0x)", 3.0, max(rd_1d), 0.2),
        Claim("2D reduction 32KiB slowdown vs 1D (4.2.3: 1.9x)", 1.9,
              red_2d_32k / red_1d_32k, 0.15),
        Claim("SUMMA max speedup (4.3.1: 3.8x at 256x256)", 3.8,
              max(summa_speedups), 0.15),
        Claim("SUMMA min speedup (4.3.1: 1.1x)", 1.1, min(summa_speedups), 0.15),
        Claim("SUMMA SW memory-bound at 16x16 (bool)", 1.0,
              1.0 if m.summa_point(g, 16).sw_bound == "comm" else 0.0, 0.0),
        Claim("SUMMA HW compute-bound at 256x256 (bool)", 1.0,
              1.0 if m.summa_point(g, 256).hw_bound == "comp" else 0.0, 0.0),
        Claim("FCL max speedup (4.3.2: 2.4x)", 2.4, max(fcl.values()), 0.2),
        Claim("SUMMA energy saving at 256x256 (4.3.3: 1.17x)", 1.17,
              noc_energy.summa_saving(256), 0.05),
        Claim("FCL energy saving at 256x256 (4.3.3: 1.13x)", 1.13,
              noc_energy.fcl_saving(256), 0.05),
        Claim("SW barrier slope (4.2.1: 3.3 cyc/cluster)", 3.3,
              p.barrier_slope_sw, 0.01),
        Claim("HW barrier slope (4.2.1: 1.3 cyc/cluster)", 1.3,
              p.barrier_slope_hw, 0.01),
    ]
    # Table 1 count anchors at 16x16 (kB / kOP)
    t1 = noc_energy.table1(16)
    anchors = [
        ("SUMMA SW", "dma_store_kB", 983.0, 0.05),
        ("SUMMA SW", "hop_kB", 1114.0, 0.05),
        ("SUMMA SW", "gemm_kOP", 1049.0, 0.05),
        ("SUMMA HW", "dma_store_kB", 66.0, 0.05),
        ("SUMMA HW", "hop_kB", 983.0, 0.05),
        ("FCL SW", "dma_load_kB", 524.0, 0.05),
        ("FCL SW", "hop_kB", 4524.0, 0.08),
        ("FCL SW", "sw_reduce_kOP", 65.0, 0.05),
        ("FCL HW", "dca_reduce_kOP", 65.0, 0.05),
        ("FCL HW", "spm_write_kB", 35.0, 0.1),
        ("FCL HW", "hop_kB", 3932.0, 0.08),
    ]
    for row, col, val, tol in anchors:
        claims.append(Claim(f"Table1 {row} {col} ({val})", val, t1[row][col], tol))
    return claims


def load_claims(points, at_rate: float, knee: float = 3.0) -> list[Claim]:
    """Saturation-aware claim checks at one offered load.

    ``points`` is a :func:`repro_torch.core.noc.traffic.sweep.saturation_sweep`
    curve (ascending rates, first point treated as the zero-load
    anchor); ``at_rate`` selects the swept point nearest the requested
    offered load.  Three checks come back as :class:`Claim` rows:

    * the offered load sits below the curve's saturation knee,
    * mean latency at that load is within ``knee``x the zero-load
      latency (the idle-network calibration still predicts it),
    * delivered throughput still tracks offered load linearly
      (throughput/rate within 15% of the zero-load point's ratio).

    Above saturation the latter two fail by construction — which is the
    point: a calibration validated only at idle would silently accept
    them.
    """
    from repro_torch.core.noc.traffic.sweep import saturation_rate

    if not points:
        raise ValueError("load_claims needs a non-empty sweep curve")
    base = points[0]
    pt = min(points, key=lambda q: abs(q.rate - at_rate))
    sat = saturation_rate(points, knee=knee)
    inflation = pt.mean_latency / base.mean_latency if base.mean_latency else 1.0
    tracking = (
        (pt.throughput / base.throughput) * (base.rate / pt.rate)
        if base.throughput and pt.rate else 0.0
    )
    return [
        Claim(f"offered load {pt.rate:g} below saturation knee ({sat:g})",
              1.0, 1.0 if pt.rate < sat else 0.0, 0.0),
        Claim(f"latency inflation at load {pt.rate:g} within {knee:g}x idle",
              1.0, inflation, knee - 1.0),
        Claim(f"throughput tracks offered load at {pt.rate:g}",
              1.0, tracking, 0.15),
    ]


@dataclasses.dataclass(frozen=True)
class CalibrationFit:
    """Least-squares (alpha0, beta) recovered from measured sweep curves.

    ``intercepts`` are the fitted zero-load latencies per payload size
    (as ``(beats, cycles)``); ``residual`` is the RMS error of the
    beats-line fit through them.
    """

    alpha0: float
    beta: float
    intercepts: tuple[tuple[int, float], ...]
    residual: float

    def claims(self, params: NoCParams, rel_tol: float = 0.15) -> list[Claim]:
        """Compare the fitted values against a parameter set's claims."""
        return [
            Claim("fitted alpha0 matches calibration", params.alpha0,
                  self.alpha0, rel_tol),
            Claim("fitted beta matches calibration", params.beta,
                  self.beta, rel_tol),
        ]


def _linear_intercept(points, knee: float) -> float:
    """Zero-load latency of one curve: least-squares intercept of
    ``mean_latency = c + s * rate`` over the pre-knee (linear) points."""
    if not points:
        raise ValueError("fit needs a non-empty sweep curve")
    base = points[0].mean_latency
    lin = [pt for pt in points if pt.mean_latency <= knee * base]
    if len(lin) < 2:
        return lin[0].mean_latency if lin else base
    n = len(lin)
    sx = sum(pt.rate for pt in lin)
    sy = sum(pt.mean_latency for pt in lin)
    sxx = sum(pt.rate * pt.rate for pt in lin)
    sxy = sum(pt.rate * pt.mean_latency for pt in lin)
    den = n * sxx - sx * sx
    if den == 0:
        return sy / n
    slope = (n * sxy - sx * sy) / den
    return (sy - slope * sx) / n


def fit_claims(
    curves,
    mean_hops: float,
    params: NoCParams | None = None,
    knee: float = 3.0,
) -> CalibrationFit:
    """Fit alpha0/beta to measured saturation curves (least squares).

    ``curves`` maps payload ``nbytes`` to a
    :func:`~repro_torch.core.noc.traffic.sweep.saturation_sweep` curve of the
    *same* pattern/seed/mesh; ``mean_hops`` is the mean hop count of the
    swept packet population.  The fit inverts the zero-load unicast
    model: each curve's linear-region intercept is
    ``alpha0 + 3 * hop_cycles * mean_hops + 1 + (beats - 1) * beta``
    (DMA round-trip ``alpha0 + 2h``, then ``h`` route hops, eject, and
    ``beats - 1`` serialization beats), so regressing the intercepts on
    ``beats - 1`` yields beta as the slope and alpha0 from the constant
    term.  This turns :func:`load_claims`'s *validation* of given
    alphas/betas into *recovery* of them from measurements — the ROADMAP
    calibration-fitting item (minimal version: unicast sweeps, uniform
    hop estimate from the caller).

    ``params`` supplies the fixed structural constants (beat size,
    ``hop_cycles``); its alpha0/beta are *not* used by the fit — compare
    them afterwards via :meth:`CalibrationFit.claims`.
    """
    p = params or NoCParams()
    pts: list[tuple[int, float]] = []
    for nbytes in sorted(curves):
        beats = p.beats(nbytes)
        pts.append((beats - 1, _linear_intercept(curves[nbytes], knee)))
    if len(pts) < 2:
        raise ValueError(
            "fit_claims needs curves at >= 2 payload sizes to separate "
            "alpha0 from beta"
        )
    n = len(pts)
    sx = float(sum(x for x, _ in pts))
    sy = sum(y for _, y in pts)
    sxx = float(sum(x * x for x, _ in pts))
    sxy = sum(x * y for x, y in pts)
    den = n * sxx - sx * sx
    if den == 0:
        raise ValueError("fit_claims needs distinct beat counts")
    beta = (n * sxy - sx * sy) / den
    a = (sy - beta * sx) / n
    alpha0 = a - 3.0 * p.hop_cycles * mean_hops - 1.0
    residual = math.sqrt(
        sum((a + beta * x - y) ** 2 for x, y in pts) / n
    )
    return CalibrationFit(
        alpha0=alpha0, beta=beta, intercepts=tuple(pts), residual=residual,
    )


def population_mean_hops(mesh, cfg) -> float:
    """Mean Manhattan hop count of a synthetic packet population — the
    hop estimate :func:`fit_claims` needs for its alpha0 recovery."""
    from repro_torch.core.noc.traffic.patterns import synthetic_population

    pop = synthetic_population(mesh, cfg)
    hops = [
        mesh.hops(src, dst)
        for node in pop.draws
        for _, pair in node
        if pair is not None
        for src, dst in [pair]
    ]
    if not hops:
        raise ValueError("population emitted no packets")
    return sum(hops) / len(hops)


def report_load(points, at_rate: float, knee: float = 3.0) -> str:
    lines = [f"{'claim':64s} {'target':>9s} {'ours':>9s}  ok"]
    for c in load_claims(points, at_rate, knee=knee):
        lines.append(
            f"{c.name:64s} {c.paper_value:9.3f} {c.achieved:9.3f}  "
            f"{'PASS' if c.ok else 'FAIL'}"
        )
    return "\n".join(lines)


def report() -> str:
    lines = [f"{'claim':64s} {'paper':>9s} {'ours':>9s}  ok"]
    for c in all_claims():
        lines.append(f"{c.name:64s} {c.paper_value:9.3f} {c.achieved:9.3f}  {'PASS' if c.ok else 'FAIL'}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report())
