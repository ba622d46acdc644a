"""moe_ms.moonlight: device ms a step of the operations launched inside the
program's region ``rt:moe`` and its backward ``rt:moe.backward``
(``models/mlp.py:moe``: routing, dispatch, the expert-parallel
``all_to_all``, the experts, combine and the shared experts, the remat
recompute inside the backward)."""

from portbench.program_spans import region_ms


def read(run):
    return region_ms(run, "moe")
