"""Parameter sets for the NoC runtime/energy models.

Two calibrated presets are provided, mirroring the two operating regimes the
paper evaluates:

* ``PAPER_MICRO`` — the collective micro-benchmarks of Section 4.2 (cold
  DMA round-trips from L2 on an otherwise idle network; full barrier
  round-trips between stages).
* ``PAPER_GEMM`` — the steady-state double-buffered GEMM regime of
  Section 4.3 (descriptors pre-programmed, synchronization amortized by the
  hardware barrier), where per-stage overheads are smaller.

The parameter values are calibrated once (see ``calibrate.py``) so that the
models reproduce the paper's claimed speedup ranges; every claim and the
achieved value is reported by ``benchmarks`` and asserted in tests.
"""

from __future__ import annotations

import dataclasses


# Canonical traffic classes and their default VC preference order: unicast
# first (latency-sensitive request traffic), then the collective classes.
# With fewer VCs than classes the tail classes share the last VC, so
# ``num_vcs=2`` already separates unicast from all collective traffic —
# the head-of-line blocking split the mixed storms need.
VC_CLASSES = ("unicast", "multicast", "reduction", "barrier")
_VC_CLASS_INDEX = {c: i for i, c in enumerate(VC_CLASSES)}


@dataclasses.dataclass(frozen=True)
class NoCParams:
    """Cycle-level parameters of the wide/narrow NoC and the clusters."""

    # -- wide network ------------------------------------------------------
    beat_bytes: int = 64          # 512-bit wide network
    beta: float = 1.0             # inverse bandwidth [cycles / beat]
    hop_cycles: float = 1.0       # per-router/link latency [cycles / hop]
    alpha0: float = 50.0          # DMA setup + protocol round-trip base [cycles]

    # -- router microarchitecture -----------------------------------------
    # Routing policy name (see repro.core.noc.routing): "xy" (reference),
    # "yx", "o1turn", "oddeven".  Resolved lazily by NoCSim so this module
    # stays import-light; unknown names raise there.
    routing: str = "xy"
    # Virtual channels: the engines arbitrate one beat per (link, VC) per
    # cycle, so beats in different VCs never block each other.  num_vcs=1
    # with vc_select="class" is bit-identical to the historical
    # whole-link arbitration.
    num_vcs: int = 1
    # Explicit traffic-class -> VC map as (class, vc) pairs (a tuple so
    # the dataclass stays frozen/hashable).  None = the default map:
    # vc = min(class index in VC_CLASSES, num_vcs - 1).
    vc_map: tuple[tuple[str, int], ...] | None = None
    # "class": VC chosen by traffic class (collective isolation).
    # "packet": unicast packets round-robin over all VCs by packet id
    # (channel-slicing for single-class synthetic sweeps); collective
    # classes still use the class map.
    vc_select: str = "class"

    # -- synchronization ---------------------------------------------------
    delta: float = 10.0           # inter-stage barrier cost in SW schedules [cycles]
    barrier_base_sw: float = 40.0  # SW barrier intercept [cycles]
    barrier_slope_sw: float = 3.3  # SW barrier slope [cycles / cluster] (paper Fig 2b)
    barrier_base_hw: float = 30.0  # HW barrier intercept [cycles]
    barrier_slope_hw: float = 1.3  # HW barrier slope [cycles / cluster] (paper Fig 2b)

    # -- cluster compute ---------------------------------------------------
    alpha_c: float = 10.0         # SW-reduction loop setup overhead [cycles]
    beta_c: float = 1.0           # SW/DCA reduction inverse throughput [cycles/beat]
    #    (8 x 64-bit SIMD FPUs = 64 B/cycle = 1 beat/cycle, Section 3.2.1)
    macs_per_cycle: float = 8.0   # 8 FPUs x 1 FMA [MAC / cycle / cluster]
    gemm_utilization: float = 0.981  # Section 4.3.1 (Colagrande et al., 2025)

    # -- schedule policy ---------------------------------------------------
    # Software SUMMA serializes the A-row and B-column collectives on the
    # cluster DMA engine; the HW path streams them from independent memory
    # tiles in parallel.  (Section 4.3.1 discussion; see DESIGN.md.)
    sw_gemm_serializes_ab: bool = True

    # -- fault injection ---------------------------------------------------
    # A repro.core.noc.faults.FaultSet (or None = pristine mesh).  Typed
    # loosely so this module stays import-light; NoCSim validates it
    # against the mesh and resolves detours/re-grafts/flaky penalties at
    # stream construction time, keeping all engines bit-identical on the
    # same faulted run.  Declared last so positional construction of the
    # historical fields is unchanged.
    faults: object | None = None

    def __post_init__(self):
        # An empty FaultSet is the pristine mesh: normalize to None so
        # the zero-fault path is bit-identical (and hash-identical) to
        # the historical parameters by construction.
        if self.faults is not None and getattr(self.faults, "empty", False):
            object.__setattr__(self, "faults", None)
        if self.num_vcs < 1:
            raise ValueError(f"num_vcs must be >= 1, got {self.num_vcs}")
        if self.vc_select not in ("class", "packet"):
            raise ValueError(
                f"vc_select must be 'class' or 'packet', got {self.vc_select!r}"
            )
        if self.vc_map is not None:
            for cls, vc in self.vc_map:
                if cls not in _VC_CLASS_INDEX:
                    raise ValueError(
                        f"unknown traffic class {cls!r}; one of {VC_CLASSES}"
                    )
                if not 0 <= vc < self.num_vcs:
                    raise ValueError(
                        f"vc_map assigns {cls!r} to VC {vc}, outside "
                        f"[0, {self.num_vcs})"
                    )

    def vc_of(self, kind: str, packet_id: int | None = None) -> int:
        """Virtual channel for a stream of traffic class ``kind``.

        ``packet_id`` enables the "packet" selection mode (unicast
        round-robin across VCs); class mode ignores it.
        """
        if kind not in _VC_CLASS_INDEX:
            raise ValueError(f"unknown traffic class {kind!r}; one of {VC_CLASSES}")
        if self.vc_select == "packet" and packet_id is not None:
            return packet_id % self.num_vcs
        if self.vc_map is not None:
            for cls, vc in self.vc_map:
                if cls == kind:
                    return vc
        return min(_VC_CLASS_INDEX[kind], self.num_vcs - 1)

    def alpha(self, hops: float) -> float:
        """Round-trip latency of a DMA transfer spanning ``hops`` hops."""
        return self.alpha0 + 2.0 * self.hop_cycles * hops

    def beats(self, nbytes: int) -> int:
        return max(1, -(-int(nbytes) // self.beat_bytes))

    def barrier_sw(self, clusters: int) -> float:
        return self.barrier_base_sw + self.barrier_slope_sw * clusters

    def barrier_hw(self, clusters: int) -> float:
        return self.barrier_base_hw + self.barrier_slope_hw * clusters


# Calibrated against Section 4.2 claims (see tests/test_noc_claims.py).
PAPER_MICRO = NoCParams()

# Calibrated against Section 4.3 claims: steady-state double-buffered GEMM.
PAPER_GEMM = NoCParams(alpha0=20.0, delta=8.0, alpha_c=10.0)
