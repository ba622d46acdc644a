"""Public entry points for the ported kernels.

Each runs its plain PyTorch version on a CPU tensor and its CUDA kernel on
a CUDA tensor; there is no interpret mode and no fallback.
"""

from __future__ import annotations

from repro_torch.kernels.gemm import gemm  # noqa: F401
from repro_torch.kernels.reduce_nway import reduce_nway  # noqa: F401
