"""Fault models for the 2-D mesh fabric: dead links, dead routers,
transient flaky links.

A :class:`FaultSet` is the frozen, hashable, serializable description of
what is broken on a mesh:

* **dead link** — an undirected mesh link that never carries a beat
  again (both directed channels are down);
* **dead router** — a tile whose router is gone: every incident link is
  dead and the tile can neither source nor sink traffic;
* **flaky link** — a link that is only *up* for a ``duty`` fraction of
  cycles; a beat arriving during downtime retries after
  ``retry_cycles``.  The expected retry cost per beat is folded into the
  link's beat rate as an exact :class:`~fractions.Fraction` (see
  :meth:`FaultSet.flaky_penalty`), with a deterministic per-edge jitter
  drawn from ``(seed, edge)`` via CRC-32 — *not* Python ``hash()``,
  which is salted per process — so faulted runs replay bit-identically
  across engines, processes and machines.

Faults enter the simulator at *stream construction* time, never in the
engine hot paths: routes detour around dead elements
(``faults.repair``), collective trees re-graft (``faults.regraft``),
and flaky penalties become per-edge rate terms.  All engines therefore
honor the same fault set by construction and stay bit-identical to each
other on degraded runs.

The module also carries the fabric-level mirror of
``runtime/elastic.py``: :func:`surviving_submesh` computes the largest
(dst, mask)-encodable submesh that avoids every dead router — the
fabric analogue of ``elastic.largest_pow2_mesh`` over surviving JAX
devices — and :func:`degrade_program` / :func:`degrade_trace` rewrite a
workload for the tiles that survive.
"""

from __future__ import annotations

import dataclasses
import functools
import random
import zlib
from fractions import Fraction
from typing import Iterable, Optional, Sequence

from repro_torch.core.topology import Coord, Mesh2D, Submesh, is_pow2

Link = tuple[Coord, Coord]


class FaultDisconnectedError(RuntimeError):
    """A fault pattern makes a requested endpoint unreachable (or removes
    it outright).  Raised at stream-construction time with the precise
    src/dst and the faulted elements responsible, so a degraded run
    never silently sits in "destination unreachable" limbo until a
    deadlock timeout."""


def _pair(a, b) -> tuple[Coord, Coord]:
    """Canonical undirected link key (sorted endpoint pair)."""
    a, b = Coord(*a), Coord(*b)
    return (a, b) if tuple(a) <= tuple(b) else (b, a)


@dataclasses.dataclass(frozen=True)
class FlakyLink:
    """A transient link: up for a ``duty`` fraction of cycles; a beat
    hitting downtime retries after ``retry_cycles``."""

    a: Coord
    b: Coord
    duty: float = 0.9
    retry_cycles: float = 4.0

    def __post_init__(self):
        a, b = _pair(self.a, self.b)
        object.__setattr__(self, "a", a)
        object.__setattr__(self, "b", b)
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(f"flaky duty must be in (0, 1], got {self.duty}")
        if self.retry_cycles < 0:
            raise ValueError(
                f"flaky retry_cycles must be >= 0, got {self.retry_cycles}")

    def to_dict(self) -> dict:
        return {"a": list(self.a), "b": list(self.b), "duty": self.duty,
                "retry_cycles": self.retry_cycles}

    @staticmethod
    def from_dict(d: dict) -> "FlakyLink":
        return FlakyLink(Coord(*d["a"]), Coord(*d["b"]),
                         duty=float(d.get("duty", 0.9)),
                         retry_cycles=float(d.get("retry_cycles", 4.0)))


@dataclasses.dataclass(frozen=True)
class FaultSet:
    """Seedable, hashable description of the broken fabric elements.

    Frozen and canonically normalized (links stored as sorted undirected
    pairs, all tuples sorted and deduplicated) so equal fault patterns
    compare and hash equal — the property the repair/regraft memo caches
    and the trace/program stamps rely on.
    """

    dead_links: tuple[tuple[Coord, Coord], ...] = ()
    dead_routers: tuple[Coord, ...] = ()
    flaky_links: tuple[FlakyLink, ...] = ()
    seed: int = 0

    def __post_init__(self):
        links = tuple(sorted({_pair(a, b) for a, b in self.dead_links},
                             key=lambda l: (tuple(l[0]), tuple(l[1]))))
        routers = tuple(sorted({Coord(*c) for c in self.dead_routers},
                               key=tuple))
        flaky = tuple(sorted(self.flaky_links,
                             key=lambda f: (tuple(f.a), tuple(f.b))))
        seen = set()
        for f in flaky:
            key = (f.a, f.b)
            if key in seen:
                raise ValueError(f"duplicate flaky link {f.a}->{f.b}")
            seen.add(key)
            if key in links:
                raise ValueError(
                    f"link {f.a}->{f.b} is both dead and flaky")
        object.__setattr__(self, "dead_links", links)
        object.__setattr__(self, "dead_routers", routers)
        object.__setattr__(self, "flaky_links", flaky)

    # -- basic queries -----------------------------------------------------

    @property
    def empty(self) -> bool:
        return not (self.dead_links or self.dead_routers or self.flaky_links)

    def router_is_dead(self, c: Coord) -> bool:
        return Coord(*c) in self.dead_routers

    def link_is_dead(self, a: Coord, b: Coord) -> bool:
        """True for a dead link or a link incident to a dead router."""
        a, b = Coord(*a), Coord(*b)
        return (_pair(a, b) in self.dead_links
                or a in self.dead_routers or b in self.dead_routers)

    def flaky_of(self, a: Coord, b: Coord) -> Optional[FlakyLink]:
        key = _pair(a, b)
        for f in self.flaky_links:
            if (f.a, f.b) == key:
                return f
        return None

    def flaky_penalty(self, a: Coord, b: Coord) -> Fraction:
        """Expected extra cycles per beat on a flaky link, as an exact
        Fraction (0 for healthy links).

        Each send attempt succeeds with probability ``duty``, so a beat
        expects ``(1 - duty) / duty`` retries of ``retry_cycles`` each.
        A deterministic per-edge jitter in ``[0.75, 1.21875]`` — drawn
        by CRC-32 from ``(seed, edge)`` — models where in the duty cycle
        the link happens to sit, without per-beat randomness (the
        engines need a constant per-edge rate to stay bit-identical).
        """
        f = self.flaky_of(a, b)
        if f is None or f.duty >= 1.0 or f.retry_cycles == 0:
            return Fraction(0)
        key = f"{self.seed}:{f.a.x},{f.a.y}:{f.b.x},{f.b.y}".encode()
        jitter = Fraction(24 + (zlib.crc32(key) & 15), 32)
        expected = (Fraction(f.retry_cycles)
                    * (1 - Fraction(f.duty)) / Fraction(f.duty))
        return expected * jitter

    def validate_for(self, mesh: Mesh2D) -> "FaultSet":
        """Check every faulted element exists on ``mesh``."""
        for a, b in self.dead_links:
            if not (mesh.contains(a) and mesh.contains(b)):
                raise ValueError(f"dead link {a}->{b} outside mesh")
            if mesh.hops(a, b) != 1:
                raise ValueError(f"dead link {a}->{b} is not a mesh link")
        for c in self.dead_routers:
            if not mesh.contains(c):
                raise ValueError(f"dead router {c} outside mesh")
        for f in self.flaky_links:
            if not (mesh.contains(f.a) and mesh.contains(f.b)):
                raise ValueError(f"flaky link {f.a}->{f.b} outside mesh")
            if mesh.hops(f.a, f.b) != 1:
                raise ValueError(f"flaky link {f.a}->{f.b} is not a mesh link")
        return self

    # -- mesh-level structure ----------------------------------------------

    def live_tiles(self, mesh: Mesh2D) -> list[Coord]:
        return [c for c in mesh.coords() if c not in self.dead_routers]

    def healthy_neighbors(self, mesh: Mesh2D, c: Coord) -> list[Coord]:
        out = []
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            n = Coord(c.x + dx, c.y + dy)
            if mesh.contains(n) and not self.link_is_dead(c, n):
                out.append(n)
        return out

    def unreachable_tiles(self, mesh: Mesh2D) -> list[Coord]:
        """Live tiles unreachable from the first live tile over healthy
        links (empty = the degraded mesh is connected)."""
        live = self.live_tiles(mesh)
        if not live:
            return []
        seen = {live[0]}
        frontier = [live[0]]
        while frontier:
            c = frontier.pop()
            for n in self.healthy_neighbors(mesh, c):
                if n not in seen:
                    seen.add(n)
                    frontier.append(n)
        return [c for c in live if c not in seen]

    def assert_connected(self, mesh: Mesh2D) -> None:
        cut = self.unreachable_tiles(mesh)
        if cut:
            raise FaultDisconnectedError(
                f"fault pattern disconnects the {mesh.cols}x{mesh.rows} "
                f"mesh: {len(cut)} live tile(s) cut off "
                f"(e.g. {tuple(cut[0])}); faults: {self.describe()}")

    # -- diagnostics -------------------------------------------------------

    def describe(self) -> str:
        return (f"{len(self.dead_links)} dead link(s), "
                f"{len(self.dead_routers)} dead router(s), "
                f"{len(self.flaky_links)} flaky link(s), seed={self.seed}")

    def implicated(self, tiles: Iterable[Coord]) -> list[str]:
        """Human-readable faulted elements adjacent to ``tiles`` — what a
        stall report names when a stuck frontier sits next to a fault."""
        ts = {Coord(*t) for t in tiles}
        out = []
        for c in self.dead_routers:
            if c in ts or any(abs(c.x - t.x) + abs(c.y - t.y) == 1
                              for t in ts):
                out.append(f"dead router ({c.x},{c.y})")
        for a, b in self.dead_links:
            if a in ts or b in ts:
                out.append(f"dead link ({a.x},{a.y})->({b.x},{b.y})")
        for f in self.flaky_links:
            if f.a in ts or f.b in ts:
                out.append(
                    f"flaky link ({f.a.x},{f.a.y})->({f.b.x},{f.b.y}) "
                    f"duty={f.duty:g}")
        return out

    # -- serialization (trace/program stamp) --------------------------------

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "dead_links": [[list(a), list(b)] for a, b in self.dead_links],
            "dead_routers": [list(c) for c in self.dead_routers],
            "flaky_links": [f.to_dict() for f in self.flaky_links],
        }

    @staticmethod
    def from_dict(d: dict) -> "FaultSet":
        return FaultSet(
            dead_links=tuple((Coord(*a), Coord(*b))
                             for a, b in d.get("dead_links", ())),
            dead_routers=tuple(Coord(*c) for c in d.get("dead_routers", ())),
            flaky_links=tuple(FlakyLink.from_dict(f)
                              for f in d.get("flaky_links", ())),
            seed=int(d.get("seed", 0)),
        )

    # -- composition (mid-run fault arrival) --------------------------------

    def union(self, other: "FaultSet") -> "FaultSet":
        """Compose two fault patterns: the union of dead links, dead
        routers and flaky links.  A link dead in either set wins over a
        flaky entry for the same link (dead is strictly worse), and a
        link flaky in both keeps ``self``'s parameters.  ``self.seed`` is
        kept — the composed set stays deterministic for the run that owns
        it.  Used by the fault timeline to fold a mid-run event into the
        faults already active."""
        dead_links = set(self.dead_links) | {
            _pair(a, b) for a, b in other.dead_links
        }
        dead_routers = set(self.dead_routers) | {
            Coord(*c) for c in other.dead_routers
        }
        flaky: dict = {}
        for f in tuple(other.flaky_links) + tuple(self.flaky_links):
            flaky[_pair(f.a, f.b)] = f  # self's entries overwrite other's
        kept = tuple(
            f for key, f in sorted(flaky.items(),
                                   key=lambda kv: (tuple(kv[0][0]),
                                                   tuple(kv[0][1])))
            if key not in dead_links
        )
        return FaultSet(
            dead_links=tuple(dead_links),
            dead_routers=tuple(dead_routers),
            flaky_links=kept,
            seed=self.seed,
        )

    # -- sampling ----------------------------------------------------------

    @staticmethod
    def sample(
        mesh: Mesh2D,
        dead_links: int = 0,
        dead_routers: int = 0,
        flaky_links: int = 0,
        seed: int = 0,
        duty: float = 0.9,
        retry_cycles: float = 4.0,
        keep_connected: bool = True,
    ) -> "FaultSet":
        """A seeded random fault pattern with the requested element counts.

        With ``keep_connected`` (default) a candidate dead element is
        skipped when removing it would cut off a live tile, so benches
        get degraded-but-operable meshes; pass ``False`` to allow
        partitions (the repair layer then raises
        :class:`FaultDisconnectedError` with the cut).
        """
        rng = random.Random(seed)
        links = [(a, Coord(a.x + dx, a.y + dy))
                 for a in mesh.coords()
                 for dx, dy in ((1, 0), (0, 1))
                 if mesh.contains(Coord(a.x + dx, a.y + dy))]
        rng.shuffle(links)
        tiles = list(mesh.coords())
        rng.shuffle(tiles)

        picked_links: list[tuple[Coord, Coord]] = []
        picked_routers: list[Coord] = []

        def ok(cand_links, cand_routers) -> bool:
            if not keep_connected:
                return True
            fs = FaultSet(dead_links=tuple(cand_links),
                          dead_routers=tuple(cand_routers))
            return (len(fs.live_tiles(mesh)) > 0
                    and not fs.unreachable_tiles(mesh))

        for link in links:
            if len(picked_links) >= dead_links:
                break
            if ok(picked_links + [link], picked_routers):
                picked_links.append(link)
        for t in tiles:
            if len(picked_routers) >= dead_routers:
                break
            if ok(picked_links, picked_routers + [t]):
                picked_routers.append(t)

        flaky: list[FlakyLink] = []
        dead = {_pair(a, b) for a, b in picked_links}
        for a, b in links:
            if len(flaky) >= flaky_links:
                break
            if (_pair(a, b) not in dead
                    and a not in picked_routers and b not in picked_routers):
                flaky.append(FlakyLink(a, b, duty=duty,
                                       retry_cycles=retry_cycles))
        return FaultSet(dead_links=tuple(picked_links),
                        dead_routers=tuple(picked_routers),
                        flaky_links=tuple(flaky), seed=seed)


# ---------------------------------------------------------------------------
# Fabric-level re-meshing: the NoC mirror of runtime/elastic.py.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def surviving_submesh(mesh: Mesh2D, faults: FaultSet) -> Submesh:
    """Largest (dst, mask)-encodable submesh avoiding every dead element.

    The fabric analogue of ``runtime.elastic.largest_pow2_mesh``: when a
    router dies, the collective layer re-targets the largest aligned
    power-of-two rectangle of fully healthy tiles (no dead routers
    inside, no dead link between two inside tiles), preserving the
    (dst, mask)-encodability constraint of the multicast/reduction
    address scheme.  Ties break toward the lexicographically smallest
    origin.  Raises :class:`FaultDisconnectedError` when not even a
    single healthy tile remains.
    """

    def clean(x0: int, y0: int, w: int, h: int) -> bool:
        for i in range(w):
            for j in range(h):
                c = Coord(x0 + i, y0 + j)
                if faults.router_is_dead(c):
                    return False
                for dx, dy in ((1, 0), (0, 1)):
                    n = Coord(c.x + dx, c.y + dy)
                    if (x0 <= n.x < x0 + w and y0 <= n.y < y0 + h
                            and faults.link_is_dead(c, n)):
                        return False
        return True

    ws = [w for w in range(1, mesh.cols + 1) if is_pow2(w)]
    hs = [h for h in range(1, mesh.rows + 1) if is_pow2(h)]
    best: Optional[Submesh] = None
    for w in ws:
        for h in hs:
            if best is not None and w * h <= best.num_tiles:
                continue
            for x0 in range(0, mesh.cols - w + 1, w):
                hit = False
                for y0 in range(0, mesh.rows - h + 1, h):
                    if clean(x0, y0, w, h):
                        best = Submesh(x0, y0, w, h)
                        hit = True
                        break
                if hit:
                    break
    if best is None:
        raise FaultDisconnectedError(
            f"no healthy submesh survives on {mesh.cols}x{mesh.rows}: "
            f"{faults.describe()}")
    return best


def degrade_program(prog, faults: FaultSet):
    """Rewrite a program for the surviving tiles: drop ops whose required
    endpoints are dead and re-home barrier participants.

    * unicast — dropped when either endpoint is dead (no destination);
    * multicast — dropped when the source or *every* destination is dead
      (individual dead destinations are handled by tree re-grafting);
    * reduction — dropped when the root or every source is dead;
    * barrier — dead participants removed; a dead counter moves to the
      first live participant;
    * compute — dropped when its tile is dead.

    Dependencies rewire transitively through dropped ops
    (:meth:`Program.filter`).  The result is stamped with ``faults`` so
    execution applies the same fault set it was degraded for.
    """
    from repro_torch.core.noc.program.ops import (
        BarrierOp, ComputeOp, MulticastOp, Program, ReductionOp, UnicastOp,
    )

    mesh = prog.mesh
    dead = set(map(tuple, faults.dead_routers))

    def keep(op) -> bool:
        if isinstance(op, UnicastOp):
            return tuple(op.src) not in dead and tuple(op.dst) not in dead
        if isinstance(op, MulticastOp):
            if tuple(op.src) in dead:
                return False
            return any(tuple(d) not in dead
                       for d in op.maddr.destinations(mesh))
        if isinstance(op, ReductionOp):
            if tuple(op.dst) in dead:
                return False
            return any(tuple(s) not in dead for s in op.sources)
        if isinstance(op, ComputeOp):
            return tuple(op.tile) not in dead
        if isinstance(op, BarrierOp):
            return any(tuple(p) not in dead for p in op.participants)
        return True

    out = prog.filter(keep)
    ops = []
    for op in out.ops:
        if isinstance(op, BarrierOp):
            live = tuple(p for p in op.participants if tuple(p) not in dead)
            counter = op.counter if tuple(op.counter) not in dead else live[0]
            op = dataclasses.replace(op, participants=live, counter=counter)
        ops.append(op)
    return Program(out.cols, out.rows, ops, routing=out.routing,
                   num_vcs=out.num_vcs, vc_select=out.vc_select,
                   vc_map=out.vc_map, faults=faults)


def degrade_trace(trace, faults: FaultSet):
    """Flat-trace variant of :func:`degrade_program` (same drop rules),
    via the lossless program round trip."""
    from repro_torch.core.noc.program.ops import from_trace

    return degrade_program(from_trace(trace), faults).to_trace()


def live_sources(mesh: Mesh2D, faults: Optional[FaultSet],
                 sources: Sequence[Coord]) -> list[Coord]:
    """Sources that survive ``faults`` (all of them when ``faults`` is
    None) — the filter the regraft layer applies to reduction inputs."""
    if faults is None:
        return list(sources)
    return [s for s in sources if not faults.router_is_dead(s)]
