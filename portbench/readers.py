"""The readings that several per-layer metrics share: each metric's file
(``metrics/<name>.py``) names what it reads, and the collective GEMM cells'
metrics, split by entry point, read alike.  A reading is None where the
run was not traced or the trace holds nothing to read.  Kernels are named
by their base names (``trace.base_name``): the program's own, never
PyTorch's (``at::native::...``)."""

from __future__ import annotations

from portbench import flops

PRODUCTS = ("gemm_kernel",)      # the port's CUDA-core product, csrc/gemm.cu
REDUCTION = ("reduce_kernel",)   # reduce_nway, csrc/reduce_nway.cu


def gemm_mfu(run):
    """The calls' FLOPs (2 m k n a call) over the window, as a share of the
    f32 peak at f32 accuracy (164.9 TFLOP/s: the larger of the CUDA cores'
    67 and 3xTF32's 494.7 / 3)."""
    s = run.shapes
    if run.trace is None or run.window_s <= 0:
        return None
    done = flops.gemm_flops(s["m"], s["k"], s["n"]) * run.units
    return 100.0 * done / run.window_s / flops.PEAK_F32_ACCURATE


def collective_ms(run):
    """Device ms a call in every program operation that is not a product
    (broadcast copies, index_select, where, reduce_nway, copies and sets);
    the benchmark's checksums are not the program's."""
    if run.trace is None or run.units <= 0:
        return None
    total = sum(s for s, _ in run.trace.kernels.values())
    return (total - run.trace.seconds_in(PRODUCTS)) / run.units * 1e3


def gemm_roofline(run):
    """The products' least time (2 m k n FLOPs at 164.9 TFLOP/s, or each
    operand read once and C written once at 3.35 TB/s, whichever is larger)
    over the device time of the product kernels."""
    if run.trace is None:
        return None
    spent = run.trace.seconds_in(PRODUCTS)
    if spent <= 0:
        return None
    s = run.shapes
    least = flops.product_bound_s(flops.gemm_flops(s["m"], s["k"], s["n"]),
                                  flops.gemm_bytes(s["m"], s["k"], s["n"], s["itemsize"]),
                                  s["dtype"])
    return 100.0 * least * run.units / spent


def device_idle(run):
    """1 - the device's busy time (the union of its operations in the
    trace) over the window's wall time."""
    if run.trace is None or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
