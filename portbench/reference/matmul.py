"""The plain reference of the collective GEMM cells: ``C = A @ B`` in f32,
TF32 off, as one ``torch.matmul``; and the comparison that decides
``correct`` there.  Imports nothing of the program.

``precision="tf32"`` is the control: the same product with TF32 on, the
nearest precision below the f32 that the configuration states.
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``a @ b`` in f32, with TF32 off (``f32``: f32 multiplies and sums) or
    on (``tf32``, the control)."""
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        return a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over max |ref|, in ``ref``'s dtype: NaN or inf in
    ``out`` reads as inf."""
    out = out.to(ref.dtype)
    if out.shape != ref.shape:
        return float("inf")
    if not bool(torch.isfinite(out).all()):
        return float("inf")
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
