"""reduce_nway_ms.train: device ms a step in reduce_nway's kernel (every
psum, psum_scatter and gradient sum of the sharded step); PyTorch's own
reductions (``at::native::reduce_kernel``: the clip norm's sums, the
norms' means, the loss head's max and sum) are not counted."""

from portbench.readers import REDUCTION


def read(run):
    if run.trace is None or run.units <= 0:
        return None
    if not run.trace.launches_of(REDUCTION):
        return None
    return run.trace.seconds_in(REDUCTION) / run.units * 1e3
