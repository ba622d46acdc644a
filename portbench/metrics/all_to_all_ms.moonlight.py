"""all_to_all_ms.moonlight: device ms a step of the operations launched
inside ``rt:collective.all_to_all`` (``core/mesh.py:all_to_all``, the
MoE's dispatch and combine exchange, the fabric's many-to-many; on the
stacked mesh one layout copy each).  The forward's and the remat
recompute's calls; the exchange's transpose in the backward is autograd's
own copy, outside the span."""

from portbench.program_spans import _per_unit, device_s


def read(run):
    return _per_unit(run, lambda p: device_s(p, ("collective.all_to_all",)), 1e3)
