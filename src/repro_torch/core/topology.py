"""2-D mesh topology, multi-address encoding and XY routing.

Implements the structural substrate of the paper (Sections 2.3, 3.1.2,
3.2.2):

* a regular 2-D mesh of tiles addressed by ``(x, y)`` coordinates,
* the ``(dst, mask)`` multi-address encoding used by the collective-capable
  NoC: masking ``n`` bits of the destination coordinate represents ``2**n``
  destinations,
* the system-address-map constraints for collective-targetable submeshes
  (power-of-two width/height, aligned origin),
* dimension-ordered (XY) routing, including the multicast *fork* sets and
  reduction *join* sets computed by the extended routers.

Everything here is pure Python/NumPy — it backs both the analytical models
(`noc/model.py`) and the flit-level simulator (`noc/netsim.py`), and the
same submesh rules are reused by the JAX collective layer to validate that
collective groups are mask-encodable.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, Sequence


def is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Coord:
    x: int
    y: int

    def __iter__(self):
        yield self.x
        yield self.y


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A ``cols x rows`` 2-D mesh of tiles.

    ``cols`` is the extent along X, ``rows`` along Y. Tiles are identified
    by ``Coord(x, y)`` with ``0 <= x < cols`` and ``0 <= y < rows``.
    """

    cols: int
    rows: int

    def __post_init__(self):
        if self.cols < 1 or self.rows < 1:
            raise ValueError("mesh dimensions must be >= 1")

    @property
    def num_tiles(self) -> int:
        return self.cols * self.rows

    def contains(self, c: Coord) -> bool:
        return 0 <= c.x < self.cols and 0 <= c.y < self.rows

    def coords(self) -> Iterable[Coord]:
        # Y-major ordering, matching the system address map (Section 3.2.2).
        for x in range(self.cols):
            for y in range(self.rows):
                yield Coord(x, y)

    def node_id(self, c: Coord) -> int:
        """Y-major consecutive node id (Section 3.2.2 assumption 3)."""
        return c.x * self.rows + c.y

    def coord_of(self, node_id: int) -> Coord:
        """Inverse of ``node_id``."""
        if not 0 <= node_id < self.num_tiles:
            raise ValueError(f"node id {node_id} outside mesh")
        return Coord(node_id // self.rows, node_id % self.rows)

    def xy_route(self, src: Coord, dst: Coord) -> list[Coord]:
        """Dimension-ordered route: X first, then Y. Includes endpoints.

        Memoized on (mesh, src, dst) — storm construction re-routes the
        same row/column segments for every stream of every phase."""
        return list(_xy_route_cached(self, src, dst))

    def hops(self, src: Coord, dst: Coord) -> int:
        return abs(src.x - dst.x) + abs(src.y - dst.y)


@dataclasses.dataclass(frozen=True)
class MultiAddress:
    """The paper's ``(dst, mask)`` multi-address encoding (Section 2.3).

    A mask bit set to 1 marks the corresponding destination-coordinate bit
    as "don't care"; ``n`` masked bits across the X/Y coordinates encode
    ``2**n`` destinations.
    """

    dst: Coord
    x_mask: int
    y_mask: int

    def destinations(self, mesh: Mesh2D) -> list[Coord]:
        xs = _expand(self.dst.x, self.x_mask, mesh.cols)
        ys = _expand(self.dst.y, self.y_mask, mesh.rows)
        out = [Coord(x, y) for x in xs for y in ys]
        for c in out:
            if not mesh.contains(c):
                raise ValueError(f"multi-address escapes mesh: {c}")
        return out

    @property
    def num_destinations(self) -> int:
        return (1 << bin(self.x_mask).count("1")) * (1 << bin(self.y_mask).count("1"))

    def matches(self, c: Coord) -> bool:
        return ((c.x ^ self.dst.x) & ~self.x_mask) == 0 and (
            (c.y ^ self.dst.y) & ~self.y_mask
        ) == 0


@functools.lru_cache(maxsize=65536)
def _xy_route_cached(mesh: Mesh2D, src: Coord, dst: Coord) -> tuple[Coord, ...]:
    if not (mesh.contains(src) and mesh.contains(dst)):
        raise ValueError(f"route endpoints outside mesh: {src}->{dst}")
    path = [src]
    x, y = src.x, src.y
    step = 1 if dst.x > x else -1
    while x != dst.x:
        x += step
        path.append(Coord(x, y))
    step = 1 if dst.y > y else -1
    while y != dst.y:
        y += step
        path.append(Coord(x, y))
    return tuple(path)


def _expand(base: int, mask: int, limit: int) -> list[int]:
    """All values obtained by toggling the masked bits of ``base``."""
    bits = [i for i in range(max(1, limit).bit_length() + 1) if (mask >> i) & 1]
    vals = []
    for sel in range(1 << len(bits)):
        v = base
        for j, b in enumerate(bits):
            if (sel >> j) & 1:
                v |= 1 << b
            else:
                v &= ~(1 << b)
        vals.append(v)
    return sorted(set(vals))


@dataclasses.dataclass(frozen=True)
class Submesh:
    """A collective-targetable submesh (Section 3.2.2).

    Constraints (validated): ``w`` and ``h`` are powers of two and the
    origin ``(x, y)`` is aligned to integer multiples of ``w`` and ``h``.
    """

    x: int
    y: int
    w: int
    h: int

    def __post_init__(self):
        if not (is_pow2(self.w) and is_pow2(self.h)):
            raise ValueError(f"submesh extents must be powers of two: {self.w}x{self.h}")
        if self.x % self.w != 0 or self.y % self.h != 0:
            raise ValueError(
                f"submesh origin ({self.x},{self.y}) not aligned to {self.w}x{self.h}"
            )

    def coords(self) -> list[Coord]:
        return [
            Coord(self.x + i, self.y + j) for i in range(self.w) for j in range(self.h)
        ]

    def multi_address(self) -> MultiAddress:
        """The (dst, mask) pair covering exactly this submesh."""
        return MultiAddress(
            dst=Coord(self.x, self.y),
            x_mask=self.w - 1,
            y_mask=self.h - 1,
        )

    @property
    def num_tiles(self) -> int:
        return self.w * self.h


def encodable(coords: Sequence[Coord]) -> bool:
    """True iff the destination set is representable by one (dst, mask)."""
    if not coords:
        return False
    xs = sorted({c.x for c in coords})
    ys = sorted({c.y for c in coords})
    if len(coords) != len(set(coords)) or len(xs) * len(ys) != len(set(coords)):
        return False
    for vals in (xs, ys):
        n = len(vals)
        if not is_pow2(n):
            return False
        # vals must be base with a subset of bits toggled -> their pairwise
        # XORs must live inside an n-1 ... check via mask reconstruction:
        mask = 0
        for v in vals:
            mask |= v ^ vals[0]
        if (1 << bin(mask).count("1")) != n:
            return False
        if sorted(_expand(vals[0], mask, max(vals) + 1)) != vals:
            return False
    return True


def multi_address_for(coords: Sequence[Coord]) -> MultiAddress:
    """The unique ``(dst, mask)`` covering exactly ``coords``.

    Raises ``ValueError`` if the set is not mask-encodable (Section 3.2.2);
    use :func:`encodable` to test first.
    """
    if not encodable(coords):
        raise ValueError(f"destination set not (dst, mask)-encodable: {coords}")
    xs = sorted({c.x for c in coords})
    ys = sorted({c.y for c in coords})
    x_mask = 0
    for v in xs:
        x_mask |= v ^ xs[0]
    y_mask = 0
    for v in ys:
        y_mask |= v ^ ys[0]
    return MultiAddress(dst=Coord(xs[0], ys[0]), x_mask=x_mask, y_mask=y_mask)


# ---------------------------------------------------------------------------
# Synthetic-traffic destination maps (classic NoC evaluation patterns).
# Each maps a source coordinate to its deterministic partner; sources whose
# partner is themselves (pattern fixed points) inject no packet.
# ---------------------------------------------------------------------------


def transpose_coord(mesh: Mesh2D, c: Coord) -> Coord:
    """Matrix-transpose pattern: ``(x, y) -> (y, x)``; requires a square mesh."""
    if mesh.cols != mesh.rows:
        raise ValueError(f"transpose needs a square mesh, got {mesh.cols}x{mesh.rows}")
    return Coord(c.y, c.x)


def bit_complement_coord(mesh: Mesh2D, c: Coord) -> Coord:
    """Bit-complement pattern: each coordinate reflected across the mesh."""
    return Coord(mesh.cols - 1 - c.x, mesh.rows - 1 - c.y)


def bit_reversal_coord(mesh: Mesh2D, c: Coord) -> Coord:
    """Bit-reversal pattern on the Y-major node id; needs pow2 tile count."""
    n = mesh.num_tiles
    if not is_pow2(n):
        raise ValueError(f"bit-reversal needs a power-of-two tile count, got {n}")
    bits = n.bit_length() - 1
    nid = mesh.node_id(c)
    rev = 0
    for i in range(bits):
        if (nid >> i) & 1:
            rev |= 1 << (bits - 1 - i)
    return mesh.coord_of(rev)


def neighbor_coord(mesh: Mesh2D, c: Coord) -> Coord:
    """Nearest-neighbour pattern: one hop +X, wrapping at the mesh edge."""
    return Coord((c.x + 1) % mesh.cols, c.y)


def multicast_fork_tree(
    mesh: Mesh2D, src: Coord, maddr: MultiAddress
) -> dict[Coord, set[Coord]]:
    """Per-router fork map for an XY-routed multicast.

    Returns ``{router: {next_hop_or_router_itself_for_local_delivery}}``.
    XY multicast routing: the packet travels along the source row forking a
    copy down/up every destination column (matching the extended
    ``xy_route_fork`` of Section 3.1.2).

    Memoized on ``(mesh, src, maddr)``: collective storms re-issue the
    same row/column multicast per phase, and rebuilding the tree per
    stream dominated storm construction.  The expensive route walk is
    cached; each call returns a fresh shallow copy so caller mutation
    cannot poison the cache.
    """
    cached = _multicast_fork_tree_cached(mesh, src, maddr)
    return {k: set(v) for k, v in cached.items()}


@functools.lru_cache(maxsize=4096)
def _multicast_fork_tree_cached(
    mesh: Mesh2D, src: Coord, maddr: MultiAddress
) -> dict[Coord, set[Coord]]:
    dests = maddr.destinations(mesh)
    fork: dict[Coord, set[Coord]] = {}

    def add(a: Coord, b: Coord):
        fork.setdefault(a, set()).add(b)

    cols = sorted({d.x for d in dests})
    # travel along X at src.y
    for cx in cols:
        path = mesh.xy_route(src, Coord(cx, src.y))
        for a, b in zip(path, path[1:]):
            add(a, b)
        # then along Y within the column
        col_dests = sorted({d.y for d in dests if d.x == cx})
        for dy in col_dests:
            cpath = mesh.xy_route(Coord(cx, src.y), Coord(cx, dy))
            for a, b in zip(cpath, cpath[1:]):
                add(a, b)
            add(Coord(cx, dy), Coord(cx, dy))  # local delivery
    return fork


def reduction_join_tree(
    mesh: Mesh2D, sources: Sequence[Coord], dst: Coord
) -> dict[Coord, set[Coord]]:
    """Per-router join map for a many-to-one reduction, mirrored XY routing.

    Each source routes Y-first then X (the mirror of XY) so the join tree is
    the reflection of the multicast fork tree; returns
    ``{router: set(inputs feeding it)}`` where inputs are neighbouring
    routers or the router itself (local contribution).

    Memoized on ``(mesh, sources, dst)`` (sources order-sensitive, as the
    tree is order-independent anyway).  The expensive route walk is
    cached; each call returns a fresh shallow copy so caller mutation
    cannot poison the cache.
    """
    cached = _reduction_join_tree_cached(mesh, tuple(sources), dst)
    return {k: set(v) for k, v in cached.items()}


@functools.lru_cache(maxsize=4096)
def _reduction_join_tree_cached(
    mesh: Mesh2D, sources: tuple[Coord, ...], dst: Coord
) -> dict[Coord, set[Coord]]:
    join: dict[Coord, set[Coord]] = {}

    def add(a: Coord, b: Coord):
        join.setdefault(a, set()).add(b)

    for s in sources:
        # Y-first to dst.y, then X to dst.x  (mirror of XY)
        path = [s]
        x, y = s.x, s.y
        step = 1 if dst.y > y else -1
        while y != dst.y:
            y += step
            path.append(Coord(x, y))
        step = 1 if dst.x > x else -1
        while x != dst.x:
            x += step
            path.append(Coord(x, y))
        add(path[0], path[0])  # local contribution
        for a, b in zip(path, path[1:]):
            add(b, a)
    return join


def max_join_fanin(join: dict[Coord, set[Coord]]) -> int:
    return max(len(v) for v in join.values()) if join else 0


def geomean(values: Sequence[float]) -> float:
    vals = [v for v in values if v > 0]
    if not vals:
        return 0.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))
