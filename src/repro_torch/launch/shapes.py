"""The four assigned input-shape cells and their per-arch applicability.

The port's copy of ``src/repro/launch/shapes.py``, verbatim but for its
import.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import ModelConfig

# archs that run the 524k-token decode cell (sub-quadratic decode state):
LONG_OK = {"rwkv6-3b", "recurrentgemma-2b", "gemma3-12b"}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape == "long_500k" and cfg.name not in LONG_OK:
        return False, ("pure full-attention arch: 500k dense-KV decode is "
                       "out of scope (sub-quadratic attention required); "
                       "see DESIGN.md §Arch-applicability")
    return True, ""


def cells(cfg: ModelConfig):
    out = []
    for name in SHAPES:
        ok, why = applicable(cfg, name)
        out.append((name, ok, why))
    return out
