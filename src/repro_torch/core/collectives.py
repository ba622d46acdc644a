"""CollectiveConfig: schedule selection for every collective of the port.

Port of ``repro.core.collectives``.  ``schedule='native'`` is the paper's
in-network (HW) path — one ``reduce_nway`` reduction over the mesh axis on
the card.  The software schedules ('chain' / 'pipelined' / 'tree') are the
paper's optimized SW baselines, kept as selectable regressions so the
HW-vs-SW comparison is reproducible.

``choose_schedule`` applies the paper's own analytical model (Eqs 1-6) to
pick the best software schedule for a given transfer size — the
"best software implementation on a case-by-case basis" selection of
Section 4.3 — while 'native' is always preferred when in-network support
is available.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import schedules as sched
from repro_torch.core.noc import model as noc_model
from repro_torch.core.noc.params import NoCParams, PAPER_MICRO


@dataclasses.dataclass(frozen=True)
class CollectiveConfig:
    schedule: str = "native"        # native | chain | pipelined | tree
    chunks: int = 4                 # k, for the pipelined schedule
    hw_collectives: bool = True     # False = force software schedules

    def resolve(self, nbytes: int | None = None, group: int = 8,
                params: NoCParams = PAPER_MICRO) -> str:
        if self.hw_collectives and self.schedule == "native":
            return "native"
        if self.schedule != "native":
            return self.schedule
        return choose_schedule(nbytes or 0, group, params)


def choose_schedule(nbytes: int, group: int, params: NoCParams = PAPER_MICRO) -> str:
    """Pick the best *software* schedule via the paper's models."""
    n = params.beats(max(1, nbytes))
    t_seq = noc_model.multicast_seq(params, n, group)
    t_tree = noc_model.multicast_tree(params, n, group)
    t_chain = noc_model.multicast_naive(params, n, group)
    best = min((t_chain, "chain"), (t_seq, "pipelined"), (t_tree, "tree"))
    return best[1]


# Re-exports: the schedule primitives themselves.
broadcast = sched.broadcast
all_reduce = sched.all_reduce
all_gather = sched.all_gather
reduce_scatter = sched.reduce_scatter
barrier = sched.barrier
SCHEDULES = sched.SCHEDULES
