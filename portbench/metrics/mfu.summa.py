"""mfu.summa: the summa calls' FLOPs over the window, of the f32 peak at f32
accuracy (``readers.gemm_mfu``)."""

from portbench.readers import gemm_mfu as read  # noqa: F401
