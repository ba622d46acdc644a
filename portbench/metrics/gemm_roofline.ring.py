"""gemm_roofline.ring: the ring-schedule products' least time over their
kernels' device time (``readers.gemm_roofline``)."""

from portbench.readers import gemm_roofline as read  # noqa: F401
