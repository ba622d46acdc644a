"""Mesh helpers of the launch tooling (``src/repro/launch/mesh.py``).

``make_production_mesh`` is a function, not a module-level constant, as in
the reference: it builds a stacked ``core.mesh.Mesh``, which allocates
nothing; the dry run traces over it on meta or fake tensors, so its 256 or
512 members cost no memory.  ``batch_axes`` and ``axis_sizes`` read either
of the port's meshes (``core.mesh.Mesh`` or ``RankMesh``): its
``axis_names`` and ``shape``.
"""

from __future__ import annotations

from repro_torch.core.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 members per pod; multi_pod adds a leading 2-pod axis.
    ``device`` as ``Mesh`` takes it (None means CUDA, and raises without a
    card)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def batch_axes(mesh) -> tuple[str, ...]:
    """All DP axes present on this mesh ('pod' + 'data')."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))
