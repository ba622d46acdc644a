"""Fault injection and degraded-mesh operation.

``model.py``
    :class:`FaultSet` / :class:`FlakyLink` — seedable, hashable,
    serializable fault patterns (dead links, dead routers, flaky links
    with an exact-Fraction duty-cycle/retry cost); sampling, mesh
    connectivity checks, trace/program degradation, and
    :func:`surviving_submesh` (the fabric mirror of
    ``runtime/elastic.py``'s largest-pow2 re-mesh).
``repair.py``
    Odd-even-turn-model detours around dead elements, the escape-VC
    deadlock argument, structural O(nodes) min-VC checks
    (:func:`fast_min_vcs`), and exact per-VC CDG verification of
    repaired route sets (:class:`RepairDeadlockError`).
``regraft.py``
    Multicast fork / reduction join trees rebuilt around faults with the
    ``routing/trees.py`` grafting discipline, preserving the tree
    validity invariants; :class:`RegraftInfo` reports what changed.

Faults are resolved at *stream construction* time (detours, re-grafts,
flaky rate terms) — never in engine hot paths — so all engines honor a
:class:`FaultSet` bit-identically, and ``faults=None`` leaves every
committed fingerprint untouched.
"""

from repro_torch.core.noc.faults.model import (
    FaultDisconnectedError,
    FaultSet,
    FlakyLink,
    degrade_program,
    degrade_trace,
    surviving_submesh,
)
from repro_torch.core.noc.faults.regraft import (
    RegraftInfo,
    check_fork_tree,
    check_join_tree,
    fork_tree_degraded,
    join_tree_degraded,
)
from repro_torch.core.noc.faults.repair import (
    RepairDeadlockError,
    detour_route,
    escape_vc,
    fast_min_vcs,
    healthy_path,
    repair_route,
    turn_superset,
    verify_repair,
    verify_route_deps,
)

__all__ = [
    "FaultDisconnectedError",
    "FaultSet",
    "FlakyLink",
    "RegraftInfo",
    "RepairDeadlockError",
    "check_fork_tree",
    "check_join_tree",
    "degrade_program",
    "degrade_trace",
    "detour_route",
    "escape_vc",
    "fast_min_vcs",
    "fork_tree_degraded",
    "healthy_path",
    "join_tree_degraded",
    "repair_route",
    "surviving_submesh",
    "turn_superset",
    "verify_repair",
    "verify_route_deps",
]
