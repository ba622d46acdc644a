"""Mesh helpers of the launch tooling (``src/repro/launch/mesh.py``).

``batch_axes`` and ``axis_sizes`` read either of the port's meshes
(``core.mesh.Mesh`` or ``RankMesh``): its ``axis_names`` and ``shape``.
The production mesh constructor comes with the dry-run tooling
(ROADMAP.md).
"""

from __future__ import annotations


def batch_axes(mesh) -> tuple[str, ...]:
    """All DP axes present on this mesh ('pod' + 'data')."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
