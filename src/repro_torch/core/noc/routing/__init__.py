"""Router microarchitecture: pluggable routing policies + turn models.

``policies`` — :class:`RoutingPolicy` and the four implementations:
               ``xy`` (dimension-ordered reference), ``yx`` (mirror),
               ``o1turn`` (cycle-balanced XY/YX split, two route
               classes), ``oddeven`` (Chiu's odd-even turn model with a
               deterministic load-spreading selection).  Resolve by name
               with :func:`get_policy`; ``NoCParams.routing`` selects
               the simulator-wide policy.
``turns``    — turn-model deadlock-freedom checks over the exact channel
               dependency graph a policy generates
               (:func:`deadlock_free`, :func:`min_vcs_for_deadlock_freedom`).
``trees``    — policy-generic multicast fork / reduction join tree
               builders (:func:`fork_tree`, :func:`join_tree`),
               bit-identical to the legacy XY builders for the ``xy``
               policy and memoized on (policy, mesh, addresses).

Virtual channels live in ``NoCParams`` (``num_vcs``, ``vc_map``,
``vc_select``) and in the engines' per-(link, VC) arbitration; this
package only decides *where* beats go, never *when*.
"""

from repro_torch.core.noc.routing.policies import (  # noqa: F401
    POLICIES,
    O1TurnPolicy,
    OddEvenPolicy,
    RoutingPolicy,
    XYPolicy,
    YXPolicy,
    get_policy,
)
from repro_torch.core.noc.routing.trees import fork_tree, join_tree  # noqa: F401
from repro_torch.core.noc.routing.turns import (  # noqa: F401
    deadlock_free,
    has_cycle,
    min_vcs_for_deadlock_freedom,
    policy_dependencies,
)
