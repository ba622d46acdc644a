"""Aggregate fabric counters: per-(link, VC) busy beats, retries, tiles.

:class:`FabricStats` is the frozen read-out of a
:class:`~repro_torch.core.noc.telemetry.collector.Collector` — plain dicts of
integer counters keyed on ``((Coord, Coord), vc)`` link pairs and
``Coord`` tiles, so two stats objects compare with ``==`` regardless of
how their counts were accumulated (one engine vs another, one run vs a
checkpointed run merged across segments).  Utilization heatmaps,
hot-link tables and the ASCII renderer derive from the counters; nothing
here ever feeds back into simulation.
"""

from __future__ import annotations

import dataclasses


def _link_key(k) -> tuple:
    """Deterministic sort key for a ((Coord, Coord), vc) link id."""
    (a, b), vc = k
    return (a.x, a.y, b.x, b.y, vc)


def link_label(k) -> str:
    (a, b), vc = k
    return f"({a.x},{a.y})->({b.x},{b.y})/vc{vc}"


@dataclasses.dataclass
class FabricStats:
    """Counter read-out of one run (or one merged sequence of segments).

    ``link_busy[((a, b), vc)]`` — beats that crossed physical link
    ``a -> b`` in virtual channel ``vc``; ``link_retries`` is the subset
    of those crossings that paid a flaky-link retry penalty.
    ``tile_inject`` / ``tile_eject`` count source-side beat injections
    and destination-side deliveries per tile (link-free timed streams —
    compute/barrier intervals — are not traffic and count nowhere).
    """

    cols: int
    rows: int
    makespan: int
    link_busy: dict
    link_retries: dict
    tile_inject: dict
    tile_eject: dict

    # -- aggregates --------------------------------------------------------

    def total_busy_beats(self) -> int:
        return sum(self.link_busy.values())

    def total_retries(self) -> int:
        return sum(self.link_retries.values())

    def top_links(self, k: int = 10) -> list:
        """The ``k`` busiest (link, VC) channels as ``(key, beats)``
        pairs, busiest first; ties broken on the deterministic link
        coordinate order so reports are stable across runs."""
        items = sorted(self.link_busy.items(),
                       key=lambda kv: (-kv[1], _link_key(kv[0])))
        return items[:k]

    def link_table(self, k: int = 10) -> list[dict]:
        """JSON-ready hot-link rows (bench output): label, busy beats,
        utilization against the makespan, retries charged."""
        span = max(self.makespan, 1)
        return [
            {
                "link": link_label(key),
                "busy_beats": beats,
                "utilization": round(beats / span, 4),
                "retries": self.link_retries.get(key, 0),
            }
            for key, beats in self.top_links(k)
        ]

    # -- heatmaps ----------------------------------------------------------

    def heatmap(self, what: str = "link") -> list[list[int]]:
        """``rows x cols`` grid of per-tile load: ``what='link'`` sums
        busy beats over each tile's outgoing links (VCs folded);
        ``'inject'`` / ``'eject'`` are the tile endpoint counters."""
        grid = [[0] * self.cols for _ in range(self.rows)]
        if what == "link":
            for ((a, _b), _vc), n in self.link_busy.items():
                grid[a.y][a.x] += n
        elif what == "inject":
            for c, n in self.tile_inject.items():
                grid[c.y][c.x] += n
        elif what == "eject":
            for c, n in self.tile_eject.items():
                grid[c.y][c.x] += n
        else:
            raise ValueError(f"unknown heatmap kind {what!r}")
        return grid


_SHADES = " .:-=+*#%@"


def render_heatmap(stats: FabricStats, what: str = "link",
                   shades: str = _SHADES) -> str:
    """ASCII heatmap of :meth:`FabricStats.heatmap`, one shade character
    per tile scaled to the grid maximum (y grows downward, matching the
    mesh coordinate convention everywhere else)."""
    grid = stats.heatmap(what)
    peak = max((v for row in grid for v in row), default=0)
    lines = [f"{what} load, {stats.cols}x{stats.rows}, peak {peak} beats"]
    for row in grid:
        if peak:
            line = "".join(
                shades[min(len(shades) - 1,
                           (v * (len(shades) - 1) + peak - 1) // peak)]
                for v in row
            )
        else:
            line = shades[0] * stats.cols
        lines.append(line)
    return "\n".join(lines)
