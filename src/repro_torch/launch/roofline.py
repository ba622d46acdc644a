"""Roofline terms of a dry-run cell.

The port's copy of ``src/repro/launch/roofline.py``, with two changes:
the hardware is a parameter of :class:`Roofline` (``TPU_V5E``, the
reference's constants, by default; ``H100`` for the port's dry run), and
``extract``, which reads a compiled XLA object, is replaced by
:func:`from_trace`, which takes the counts of the port's trace
(``launch/dryrun.py``).

Three terms per (arch x shape x mesh), in seconds:

  compute    = HLO_FLOPs / (chips * peak_FLOP/s)
  memory     = HLO_bytes / (chips * HBM_bw)
  collective = collective_bytes / (chips * link_bw)

The names keep the reference's ``hlo_`` prefix so that records compare;
in the port they are a trace's counts: FLOPs from
``torch.utils.flop_counter`` (the kernels' ops by their own formulas), and
the bytes each op reads and writes.  ``collective_bytes`` (the HLO text
parser) is kept, so that the copy stays whole.

Hardware constants: TPU v5e, 197 TFLOP/s bf16 per chip, 819 GB/s HBM,
~50 GB/s/link ICI; NVIDIA H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s
HBM, 450 GB/s of NVLink each way (NVIDIA's data sheet, at 700 W).
"""

from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 197e12       # bf16 / chip
HBM_BW = 819e9            # bytes/s / chip
LINK_BW = 50e9            # bytes/s / link (per chip, one link engaged)


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float     # bf16 / chip
    hbm_bw: float         # bytes/s / chip
    link_bw: float        # bytes/s / chip, one direction


TPU_V5E = Hardware("tpu-v5e", PEAK_FLOPS, HBM_BW, LINK_BW)
H100 = Hardware("h100-sxm", 989e12, 3.35e12, 450e9)

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "i8": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "i32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "i1": 1, "i16": 2, "i64": 8,
    "ui8": 1, "ui16": 2, "ui32": 4, "ui64": 8,
}

# HLO form:  %x = bf16[128,4096]{1,0} all-gather(...)
# Async pairs (-start/-done) are emitted for overlapped collectives; count
# only the -start (or the sync form) so each transfer is counted once.
_HLO_COLL = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([\d,]*)\][^=]*?\b"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
# stableHLO form: "stablehlo.all_gather"(%arg) ... -> tensor<128x4096xbf16>
_MLIR_COLL = re.compile(
    r"stablehlo\.(all_gather|all_reduce|reduce_scatter|all_to_all|collective_permute)"
    r".*?->\s*(?:tuple<)?tensor<([^>]+)>", re.DOTALL)


def _bytes_of(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _mlir_tensor_bytes(desc: str) -> int:
    parts = desc.split("x")
    dtype = parts[-1].strip()
    n = 1
    for d in parts[:-1]:
        n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Sum result sizes of collective ops, bucketed by op kind."""
    out: dict[str, int] = {}
    for m in _HLO_COLL.finditer(hlo_text):
        dtype, dims, op, suffix = m.group(1), m.group(2), m.group(3), m.group(4)
        if suffix == "-done":
            continue  # counted at -start
        out[op] = out.get(op, 0) + _bytes_of(dtype, dims)
    if not out:
        for m in _MLIR_COLL.finditer(hlo_text):
            op, desc = m.group(1).replace("_", "-"), m.group(2)
            out[op] = out.get(op, 0) + _mlir_tensor_bytes(desc)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    model_flops: float          # 6 * N(active) * D
    bytes_per_device: float     # inputs and the trace's peak, per member
    hardware: Hardware = TPU_V5E

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hardware.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hardware.hbm_bw)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * self.hardware.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute-term / max-term: 1.0 = perfectly compute-bound."""
        mx = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_compute / mx if mx else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hardware": self.hardware.name,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_estimate(cfg, cell_kind: str, seq_len: int, global_batch: int) -> float:
    """6*N*D for training, 2*N*D for inference (per step)."""
    n = cfg.n_active_params
    if cell_kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * n * tokens
    if cell_kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * n * tokens
    return 2.0 * n * global_batch  # decode: one token per sequence


def from_trace(arch: str, shape: str, mesh_name: str, chips: int, *, flops: float,
               bytes_accessed: float, coll: dict, bytes_per_device: float, cfg,
               cell_kind: str, seq_len: int, global_batch: int,
               hardware: Hardware = H100) -> Roofline:
    """The roofline of a traced step: ``flops``, ``bytes_accessed`` and the
    collective result bytes ``coll`` (by kind) are all members' together,
    as the reference's per-device counts times ``chips``."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(flops), hlo_bytes=float(bytes_accessed),
        coll_bytes=float(sum(coll.values())), coll_breakdown=dict(coll),
        model_flops=model_flops_estimate(cfg, cell_kind, seq_len, global_batch),
        bytes_per_device=float(bytes_per_device), hardware=hardware,
    )
