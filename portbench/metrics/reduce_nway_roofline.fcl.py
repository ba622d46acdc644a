"""reduce_nway_roofline.fcl: the reduction's byte bound (the members'
partial C read, one C written, at 3.35 TB/s) over the device time of
reduce_nway's kernel (not PyTorch's ``at::native::reduce_kernel``)."""

from portbench import flops
from portbench.readers import REDUCTION


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds_in(REDUCTION)
    if spent <= 0:
        return None
    s = run.shapes
    least = flops.reduce_bytes(s["members"], s["m"] * s["n"], s["itemsize"]) / flops.PEAK_BYTES
    return 100.0 * least * run.units / spent
