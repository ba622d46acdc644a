"""gemm_roofline.summa: the summa products' least time over their kernels' device
time (``readers.gemm_roofline``)."""

from portbench.readers import gemm_roofline as read  # noqa: F401
