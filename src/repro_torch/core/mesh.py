"""The stacked mesh: every member of a device mesh as leading tensor dims.

The JAX reference runs its collective bodies per device under
``shard_map`` over named mesh axes; the same bodies run unchanged under
nested ``jax.vmap(..., axis_name=...)`` on one device.  The port takes the
second form on one card: a tensor *on the mesh* has leading dims equal to
``mesh.shape`` (one per axis, in order) followed by the member's local
shape.  A member's dim 0 in a JAX body is dim ``mesh.ndim`` here.

The axis primitives mirror ``jax.lax`` and find the mesh from the
enclosing ``with mesh:`` block:

* ``axis_size``, ``axis_index`` (an integer tensor over the mesh dims;
  :func:`lift` broadcasts such a per-member value against a stacked tensor);
* ``ppermute`` (an ``index_select`` along the axis' dim);
* ``psum`` and ``psum_scatter`` (the ``reduce_nway`` kernel over the axis'
  dim for float32 and bfloat16; other dtypes as ``jax.lax.psum`` sums
  them, see :func:`axis_sum`), ``pmax`` (its ``max``), ``all_gather``;
* ``take`` and ``put``: a per-member index into a local dim, in place of
  ``jnp.take`` / ``dynamic_slice`` / ``dynamic_update_slice`` with a
  traced index.

``shard`` / ``unshard`` lay a global array out in the stacked layout
exactly as ``shard_map`` hands blocks to devices under
``PartitionSpec(*spec)``, and back for ``out_specs``.
"""

from __future__ import annotations

import contextvars

import torch

from repro_torch.kernels.reduce_nway import reduce_nway

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh")


class Mesh:
    """A logical device mesh whose members are stacked on one device.

    ``device=None`` means CUDA and raises when no card is present; the CPU
    is used only when the caller passes ``device="cpu"``.
    """

    def __init__(self, shape, axis_names, device=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Mesh: no CUDA device; pass device='cpu' to run "
                                   "the plain versions on the host")
            device = "cuda"
        self.device = torch.device(device)
        self._tokens = []

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self, name: str) -> int:
        try:
            return self.axis_names.index(name)
        except ValueError:
            raise ValueError(f"unknown axis {name!r}; mesh axes are {self.axis_names}") from None

    def size(self, name: str) -> int:
        return self.shape[self.dim(name)]

    def __enter__(self):
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._tokens.pop())
        return False

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}, device={self.device})"


def current() -> Mesh:
    """The mesh of the enclosing ``with mesh:`` block."""
    mesh = _CURRENT.get(None)
    if mesh is None:
        raise RuntimeError("no mesh in context: call inside `with mesh:`")
    return mesh


# ---------------------------------------------------------------------------
# Axis primitives (jax.lax counterparts)
# ---------------------------------------------------------------------------


def axis_size(name: str) -> int:
    return current().size(name)


def axis_index(name: str) -> torch.Tensor:
    """This member's index along ``name``: int64 of shape (1, .., n, .., 1)."""
    mesh = current()
    d = mesh.dim(name)
    shape = [1] * mesh.ndim
    shape[d] = mesh.shape[d]
    return torch.arange(mesh.shape[d], device=mesh.device).reshape(shape)


def lift(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-member value ``v`` (mesh dims, then maybe more)
    against the stacked tensor ``like`` by appending unit dims."""
    return v.reshape(tuple(v.shape) + (1,) * (like.ndim - v.ndim))


def ppermute(x: torch.Tensor, name: str, perm) -> torch.Tensor:
    """Member ``dst`` receives ``x`` of member ``src`` for each (src, dst)."""
    mesh = current()
    n = mesh.size(name)
    src = [None] * n
    for s, t in perm:
        src[t] = s
    if sorted(s for s in src if s is not None) != list(range(n)):
        raise ValueError(f"ppermute over {name!r} needs a full permutation of {n}, got {perm}")
    index = torch.tensor(src, device=x.device)
    return x.index_select(mesh.dim(name), index)


def axis_sum(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` summed over its dim ``d`` as ``jax.lax.psum`` sums a mesh axis.

    float32 and bfloat16 go through the ``reduce_nway`` kernel (the
    reduction router), which sums in f32.  Integers are summed exactly in
    an int64 accumulator and cast back, which wraps as psum's int32 adds
    do.  float16 and float64 are added member by member in their own type,
    in member order, as the reference's psum adds them.
    """
    if x.dtype in (torch.float32, torch.bfloat16):
        return reduce_nway(x.contiguous(), op="add", dim=d)
    if x.dtype in (torch.float16, torch.float64):
        total = x.select(d, 0)
        for i in range(1, x.shape[d]):
            total = total + x.select(d, i)
        return total
    if x.dtype in (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64):
        return x.sum(d, dtype=torch.int64).to(x.dtype)
    raise TypeError(f"psum: unsupported dtype {x.dtype}")


def psum(x: torch.Tensor, name: str) -> torch.Tensor:
    """Sum over the axis (:func:`axis_sum`), replicated to every member."""
    d = current().dim(name)
    return axis_sum(x, d).unsqueeze(d).expand(x.shape)


def pmax(x: torch.Tensor, name: str) -> torch.Tensor:
    """Maximum over the axis (the ``reduce_nway`` kernel's ``max`` over its
    dim), replicated to every member, as ``jax.lax.pmax``."""
    d = current().dim(name)
    return reduce_nway(x.contiguous(), op="max", dim=d).unsqueeze(d).expand(x.shape)


def psum_scatter(x: torch.Tensor, name: str, tiled: bool = True) -> torch.Tensor:
    """Sum over the axis, scattering the member's dim 0 across it."""
    mesh = current()
    d, k, n = mesh.dim(name), mesh.ndim, mesh.size(name)
    rows = x.shape[k]
    if rows % n:
        raise ValueError(f"psum_scatter: dim of size {rows} not divisible by {n}")
    total = axis_sum(x, d)  # member dim 0 is now k-1
    parts = total.unflatten(k - 1, (n, rows // n)).movedim(k - 1, d)
    if tiled:
        return parts
    if rows != n:
        raise ValueError(f"psum_scatter(tiled=False) needs dim 0 of size {n}, got {rows}")
    return parts.squeeze(k)


def all_gather(x: torch.Tensor, name: str, tiled: bool = True) -> torch.Tensor:
    """Every member receives all members' ``x`` along the axis: stacked on a
    new dim 0, or concatenated on dim 0 when ``tiled``."""
    mesh = current()
    d, k, n = mesh.dim(name), mesh.ndim, mesh.size(name)
    g = x.movedim(d, k - 1)  # the axis' members, just before the member dims
    if tiled:
        g = g.flatten(k - 1, k)
    g = g.unsqueeze(d)
    return g.expand(g.shape[:d] + (n,) + g.shape[d + 1:])


def take(x: torch.Tensor, i: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed at the per-member position ``i`` along ``dim`` (dropped)."""
    shape = list(x.shape)
    shape[dim] = 1
    return x.gather(dim, lift(i, x).expand(shape)).squeeze(dim)


def put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    """A copy of ``x`` with position ``i`` (per member) along ``dim`` set to ``v``."""
    v = v.unsqueeze(dim)
    return x.scatter(dim, lift(i, x).expand(v.shape), v)


# ---------------------------------------------------------------------------
# shard_map layouts
# ---------------------------------------------------------------------------


def _spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def shard(x, mesh: Mesh, spec) -> torch.Tensor:
    """Lay a global array out on the stacked mesh under ``PartitionSpec(*spec)``.

    Dim ``i`` of ``x`` is split over axis ``spec[i]`` (block ``j`` to the
    member at index ``j``), or kept whole for ``None``; members along an
    axis that ``spec`` does not name get copies.
    """
    x = torch.as_tensor(x, device=mesh.device)
    spec = _spec(spec, x.ndim)
    split, at = [], {}
    for g, name in zip(x.shape, spec):
        if name is None:
            split.append(g)
            continue
        n = mesh.size(name)
        if g % n:
            raise ValueError(f"dim of size {g} not divisible by axis {name!r} of size {n}")
        if name in at:
            raise ValueError(f"axis {name!r} used twice in spec {spec}")
        at[name] = len(split)
        split += [n, g // n]
    y = x.reshape(split)
    lead = [at[name] for name in mesh.axis_names if name in at]
    y = y.permute(lead + [p for p in range(y.ndim) if p not in lead])
    for d, name in enumerate(mesh.axis_names):
        if name not in at:
            y = y.unsqueeze(d)
    return y.expand(mesh.shape + tuple(y.shape[mesh.ndim:])).contiguous()


def unshard(y: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """The global array of a stacked tensor laid out under ``spec``.

    Axes that ``spec`` does not name hold copies; member 0's is returned,
    as ``shard_map`` does for an unchecked replicated output.
    """
    local = tuple(y.shape[mesh.ndim:])
    spec = _spec(spec, len(local))
    y = y[tuple(slice(None) if name in spec else 0 for name in mesh.axis_names)]
    named = [name for name in mesh.axis_names if name in spec]
    order, shape = [], []
    for i, name in enumerate(spec):
        if name is None:
            shape.append(local[i])
        else:
            order.append(named.index(name))
            shape.append(mesh.size(name) * local[i])
        order.append(len(named) + i)
    return y.permute(order).reshape(shape)
