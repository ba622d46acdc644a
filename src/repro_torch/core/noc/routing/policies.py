"""Routing policies for the 2-D mesh: XY, YX, O1TURN, odd-even.

Every policy computes *minimal* routes (hop count equals the Manhattan
distance, so the DMA round-trip model ``NoCParams.alpha`` is unchanged)
and is fully deterministic given ``(mesh, src, dst, packet_id)`` — the
simulator pre-expands each stream into a beat DAG, so a route must be a
pure function of its inputs, never of live network state.  Adaptivity is
therefore modeled the way trace-driven simulators do it: the odd-even
policy picks, at every hop, among the outputs its turn model admits with
a deterministic load-spreading selection function (remaining-distance
first, parity tie-break), and ``packet_id`` seeds the tie-break so
different packets of the same (src, dst) pair take different admissible
paths.

Deadlock freedom is a property of the *turn set* a policy can generate
(see ``turns.py``): XY, YX and odd-even are deadlock-free on a single
virtual network; O1TURN is deadlock-free only because its XY-routed and
YX-routed packets form two disjoint route classes — each class is
acyclic, and mapping the classes to distinct virtual channels (or, in
this simulator, distinct packets that never hold shared buffers)
restores freedom, which is why :attr:`RoutingPolicy.route_classes` is 2
for it and :meth:`~turns.deadlock_free` validates per class.
"""

from __future__ import annotations

import functools

from repro_torch.core.topology import Coord, Mesh2D, _xy_route_cached


@functools.lru_cache(maxsize=65536)  # same policy as _xy_route_cached
def _yx_route(mesh: Mesh2D, src: Coord, dst: Coord) -> tuple[Coord, ...]:
    """Dimension-ordered route, Y first then X. Includes endpoints."""
    if not (mesh.contains(src) and mesh.contains(dst)):
        raise ValueError(f"route endpoints outside mesh: {src}->{dst}")
    path = [src]
    x, y = src.x, src.y
    step = 1 if dst.y > y else -1
    while y != dst.y:
        y += step
        path.append(Coord(x, y))
    step = 1 if dst.x > x else -1
    while x != dst.x:
        x += step
        path.append(Coord(x, y))
    return tuple(path)


class RoutingPolicy:
    """Deterministic minimal routing on a 2-D mesh.

    ``route``      — the per-packet unicast path (may depend on
                     ``packet_id``: O1TURN alternates XY/YX, odd-even
                     seeds its tie-break with it).
    ``tree_route`` — the packet-independent path used to build multicast
                     fork trees (must be deterministic so the tree is
                     memoizable; see ``trees.py``).
    ``join_route`` — the packet-independent path used to build reduction
                     join trees (for dimension-ordered policies this is
                     the *mirror* order, so the join tree is the
                     reflection of the fork tree, as in the paper).
    ``route_classes`` / ``route_class`` — disjoint deadlock-free route
                     classes; policies whose union of turns is cyclic
                     (O1TURN) are deadlock-free only when each class maps
                     to its own virtual network.
    ``tree_routes_are_xy`` — declared by a policy whose ``tree_route``
                     and ``join_route`` coincide with the XY policy's;
                     the tree builders then dispatch to the legacy
                     (bit-identical, shared-cache) XY construction.  A
                     policy that overrides its tree routes must clear
                     this flag in the same class.
    """

    name: str = "base"
    route_classes: int = 1
    tree_routes_are_xy: bool = False

    def route(self, mesh: Mesh2D, src: Coord, dst: Coord,
              packet_id: int = 0) -> tuple[Coord, ...]:
        raise NotImplementedError

    def route_class(self, packet_id: int) -> int:
        return 0

    def tree_route(self, mesh: Mesh2D, src: Coord, dst: Coord) -> tuple[Coord, ...]:
        return self.route(mesh, src, dst, 0)

    def join_route(self, mesh: Mesh2D, src: Coord, dst: Coord) -> tuple[Coord, ...]:
        return self.tree_route(mesh, src, dst)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<RoutingPolicy {self.name}>"


class XYPolicy(RoutingPolicy):
    """Dimension-ordered X-then-Y — the reference policy.

    ``route`` delegates to the memoized ``Mesh2D.xy_route`` walk, and
    ``join_route`` is the YX mirror, so fork/join trees built through
    this policy are bit-identical to the legacy ``topology`` builders
    (asserted in tests)."""

    name = "xy"
    tree_routes_are_xy = True

    def route(self, mesh, src, dst, packet_id=0):
        return _xy_route_cached(mesh, src, dst)

    def join_route(self, mesh, src, dst):
        return _yx_route(mesh, src, dst)


class YXPolicy(RoutingPolicy):
    """Dimension-ordered Y-then-X (the mirror of XY)."""

    name = "yx"

    def route(self, mesh, src, dst, packet_id=0):
        return _yx_route(mesh, src, dst)

    def join_route(self, mesh, src, dst):
        return _xy_route_cached(mesh, src, dst)


class O1TurnPolicy(RoutingPolicy):
    """O1TURN: a cycle-balanced 50/50 split between XY and YX.

    Even ``packet_id``s route XY, odd ones YX — a deterministic stand-in
    for O1TURN's per-packet random selection that keeps the split exact
    under any packet count.  Worst-case throughput is within a constant
    of optimal on 2-D meshes (Seo et al.); here it roughly doubles the
    saturation load of adversarial patterns (transpose, hotspot) because
    the two halves load row-first and column-first links symmetrically.

    Collective trees are packet-independent, so ``tree_route`` uses the
    XY half and ``join_route`` its YX mirror (identical trees to the XY
    policy — the collective storm fingerprint does not change when only
    unicast routing diversity is requested).
    """

    name = "o1turn"
    route_classes = 2
    tree_routes_are_xy = True  # tree_route/join_route below are the XY pair

    def route(self, mesh, src, dst, packet_id=0):
        if packet_id % 2 == 0:
            return _xy_route_cached(mesh, src, dst)
        return _yx_route(mesh, src, dst)

    def route_class(self, packet_id):
        return packet_id % 2

    def tree_route(self, mesh, src, dst):
        return _xy_route_cached(mesh, src, dst)

    def join_route(self, mesh, src, dst):
        return _yx_route(mesh, src, dst)


# Direction encoding shared with turns.py: (dx, dy) unit steps.
E, W, N, S = (1, 0), (-1, 0), (0, 1), (0, -1)


class OddEvenPolicy(RoutingPolicy):
    """Chiu's odd-even turn model with a deterministic selection function.

    Admissible minimal output directions per hop (Chiu 2000):

    * EN and ES turns are forbidden at nodes in *even* columns,
    * NW and SW turns are forbidden at nodes in *odd* columns,

    which leaves at least one minimal output at every node and makes the
    turn set acyclic (checked by ``turns.deadlock_free``).  Among the
    admissible outputs the selection function prefers the dimension with
    the larger remaining offset (spreading hotspot traffic across a
    staircase of columns instead of the single XY column) and breaks
    ties with the parity of ``x + y + packet_id`` so consecutive packets
    diverge.
    """

    name = "oddeven"

    def route(self, mesh, src, dst, packet_id=0):
        # packet_id only enters the selection through (x+y+packet_id)%2,
        # so routes are memoizable on its parity — same policy as the
        # dimension-ordered caches in the add_unicast hot path.
        return _oddeven_route_cached(mesh, src, dst, packet_id % 2)

    @staticmethod
    def _walk(mesh: Mesh2D, src: Coord, dst: Coord,
              parity: int) -> tuple[Coord, ...]:
        if not (mesh.contains(src) and mesh.contains(dst)):
            raise ValueError(f"route endpoints outside mesh: {src}->{dst}")
        path = [src]
        cur = src
        while cur != dst:
            avail = OddEvenPolicy._admissible(cur, src, dst)
            d = OddEvenPolicy._select(avail, cur, dst, parity)
            cur = Coord(cur.x + d[0], cur.y + d[1])
            path.append(cur)
        return tuple(path)

    @staticmethod
    def _admissible(cur: Coord, src: Coord, dst: Coord) -> list[tuple[int, int]]:
        """Minimal output directions the odd-even turn model admits.

        Chiu's ROUTE function: eastbound packets may only turn off the
        row where the turn (and the later NW/SW re-turn) stays legal;
        westbound packets may only leave the column at even columns.
        """
        ex, ey = dst.x - cur.x, dst.y - cur.y
        avail: list[tuple[int, int]] = []
        vertical = N if ey > 0 else S
        if ex == 0:
            return [vertical] if ey != 0 else []
        if ex > 0:  # eastbound
            if ey == 0:
                return [E]
            # EN/ES turns are illegal at even columns; taking the
            # vertical at the source column is not a turn at all.
            if cur.x % 2 == 1 or cur.x == src.x:
                avail.append(vertical)
            # Continuing east must leave a legal future turn-off: the
            # destination column must allow the NW/SW-free approach
            # (dst in an odd column) unless more eastward slack remains.
            if dst.x % 2 == 1 or ex != 1:
                avail.append(E)
            return avail
        # westbound: NW/SW turns are illegal at odd columns, so the
        # vertical may only be taken at even columns; W is always legal.
        avail.append(W)
        if ey != 0 and cur.x % 2 == 0:
            avail.append(vertical)
        return avail

    @staticmethod
    def _select(avail: list[tuple[int, int]], cur: Coord, dst: Coord,
                packet_id: int) -> tuple[int, int]:
        if len(avail) == 1:
            return avail[0]
        ex, ey = abs(dst.x - cur.x), abs(dst.y - cur.y)
        horiz = [d for d in avail if d[0] != 0]
        vert = [d for d in avail if d[1] != 0]
        if ex > ey and horiz:
            return horiz[0]
        if ey > ex and vert:
            return vert[0]
        if (cur.x + cur.y + packet_id) % 2 and vert:
            return vert[0]
        return horiz[0] if horiz else vert[0]


@functools.lru_cache(maxsize=65536)
def _oddeven_route_cached(
    mesh: Mesh2D, src: Coord, dst: Coord, parity: int
) -> tuple[Coord, ...]:
    return OddEvenPolicy._walk(mesh, src, dst, parity)


POLICIES: dict[str, RoutingPolicy] = {
    p.name: p for p in (XYPolicy(), YXPolicy(), O1TurnPolicy(), OddEvenPolicy())
}


def get_policy(name: str) -> RoutingPolicy:
    """Resolve a policy by name; raises ``ValueError`` with the known set."""
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; one of {sorted(POLICIES)}"
        ) from None
