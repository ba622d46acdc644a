"""Device meshes of two kinds, under one set of axis functions.

The JAX reference runs its collective bodies per device under
``shard_map`` over named mesh axes; the same bodies run unchanged under
nested ``jax.vmap(..., axis_name=...)`` on one device.  The port has a
mesh for each form:

* :class:`Mesh` stacks every member on one card, the second form: a
  tensor *on the mesh* has leading dims equal to ``mesh.shape`` (one per
  axis, in order) followed by the member's local shape, so a member's dim
  0 in a JAX body is dim ``mesh.stacked`` here;
* :class:`RankMesh` is one process per member (``torch.distributed``:
  NCCL on a card, gloo on the host), the first form: a tensor is the
  member's local tensor and ``mesh.stacked`` is 0.

Code that indexes a member's dims counts from ``mesh.stacked``, and then
runs unchanged on both kinds.  The axis primitives mirror ``jax.lax`` and
find the mesh from the enclosing ``with mesh:`` block:

* ``axis_size``, ``axis_index`` (an integer tensor over the stacked dims,
  0-d on a rank mesh; :func:`lift` broadcasts such a per-member value
  against a tensor);
* ``ppermute`` (an ``index_select`` along the axis' dim; paired
  ``isend`` / ``irecv`` on a rank mesh);
* ``psum`` and ``psum_scatter`` (the ``reduce_nway`` kernel over the axis'
  dim for float32 and bfloat16, which reads an expand or moved mesh dims
  in place and gets a copy of any other layout, ``readable``; other dtypes
  as ``jax.lax.psum`` sums them, see :func:`axis_sum`; a rank mesh keeps
  the same arithmetic: a reduce-scatter by ``all_to_all_single`` and the
  ``reduce_nway`` router, then ``all_gather`` for ``psum``), ``pmax`` (its
  ``max``), ``all_gather``, ``all_to_all`` (``jax.lax.all_to_all``'s tiled
  form: a reshape and ``movedim`` across the axis' dim on the stacked
  mesh, no kernel; ``all_to_all_single`` on a rank mesh);
* ``take`` and ``put``: a per-member index into a local dim, in place of
  ``jnp.take`` / ``dynamic_slice`` / ``dynamic_update_slice`` with a
  traced index; ``block_of`` and ``gather_blocks``: a member's block of a
  dim that it holds whole, and back (ZeRO-1's update, ``optim/adamw.py``).

``shard`` / ``unshard`` lay a global array out exactly as ``shard_map``
hands blocks to devices under ``PartitionSpec(*spec)`` (an entry may be a
tuple of axes, major to minor), and back for ``out_specs``; ``sum_copies``
is the adjoint of ``shard`` (a laid-out gradient's copies summed).

Gradients: every float axis function carries the transpose that
``shard_map`` uses, on both kinds: ``psum`` -> ``psum``, ``all_gather`` ->
``psum_scatter``, ``psum_scatter`` -> ``all_gather``, ``all_to_all`` -> the
mirrored one, ``ppermute`` -> the inverse permutation.  On the stacked mesh
the sums run the ``reduce_nway`` kernel in the backward as in the forward
(``_Broadcast``, and the kernel's own ``ReduceAdd``); on a rank mesh each
collective is an ``autograd.Function`` whose backward is the transposed
collective.  The launches that a backward makes are also counted in
``reduce_nway.backward_launches``.  ``pmax`` and integer sums carry none.

Counting: inside ``with count_collectives() as counts:`` every axis
function adds the bytes of its result, all members' together, to
``counts`` under its HLO name (``psum`` and ``pmax`` as ``all-reduce``,
``psum_scatter`` as ``reduce-scatter``, then ``all-gather``,
``all-to-all``, ``ppermute`` as ``collective-permute``), and so does each
transpose in a backward pass; the dry run (``launch/dryrun.py``) reads
them.  Outside it the cost is one test of a module global per call.
Each collective is also the span ``rt:collective.<name>`` while a profiler
records (``repro_torch.tracing``).
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist

from repro_torch.kernels import reduce_nway as _kernel
from repro_torch.kernels.reduce_nway import readable, reduce_nway
from repro_torch.tracing import spanned

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh")
_INTS = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)
# {HLO name: result bytes} while ``count_collectives`` is on; a module
# global, not a context variable, so that autograd's threads see it too.
_COUNTS = None


@contextlib.contextmanager
def count_collectives():
    """Count the collectives' result bytes by kind into the yielded dict."""
    global _COUNTS
    outer, _COUNTS = _COUNTS, {}
    try:
        yield _COUNTS
    finally:
        _COUNTS = outer


def _count(kind: str, result: torch.Tensor, mesh) -> None:
    """Add ``result``'s bytes, all members' (one member's times the mesh's
    size on a rank mesh), to the counts under ``kind``."""
    if _COUNTS is not None:
        n = result.numel() * result.element_size()
        _COUNTS[kind] = _COUNTS.get(kind, 0) + (n if mesh.stacked else n * math.prod(mesh.shape))


class _Axes:
    """Named axes of a mesh, and entering it as the current mesh."""

    def _set_axes(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in length")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
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


class Mesh(_Axes):
    """A logical device mesh whose members are stacked on one device.

    ``device=None`` means CUDA and raises when no card is present; the CPU
    is used only when the caller passes ``device="cpu"``.
    """

    def __init__(self, shape, axis_names, device=None):
        self._set_axes(shape, axis_names)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("Mesh: no CUDA device; pass device='cpu' to run "
                                   "the plain versions on the host")
            device = "cuda"
        self.device = torch.device(device)

    @property
    def stacked(self) -> int:
        """The number of leading tensor dims that hold the members."""
        return len(self.shape)

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}, device={self.device})"


def current():
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
    """This member's index along ``name``: int64 of shape (1, .., n, .., 1)
    on a stacked mesh, 0-d on a rank mesh."""
    mesh = current()
    if isinstance(mesh, RankMesh):
        return mesh.axis_index(name)
    d = mesh.dim(name)
    shape = [1] * mesh.ndim
    shape[d] = mesh.shape[d]
    return torch.arange(mesh.shape[d], device=mesh.device).reshape(shape)


def lift(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-member value ``v`` (mesh dims, then maybe more)
    against the stacked tensor ``like`` by appending unit dims."""
    return v.reshape(tuple(v.shape) + (1,) * (like.ndim - v.ndim))


def _sources(n: int, name: str, perm) -> list:
    """``src[dst]`` of a full permutation of the ``n`` members of ``name``."""
    src = [None] * n
    for s, t in perm:
        src[t] = s
    if sorted(s for s in src if s is not None) != list(range(n)):
        raise ValueError(f"ppermute over {name!r} needs a full permutation of {n}, got {perm}")
    return src


@spanned("collective.ppermute")
def ppermute(x: torch.Tensor, name: str, perm) -> torch.Tensor:
    """Member ``dst`` receives ``x`` of member ``src`` for each (src, dst).
    Its gradient is the inverse permutation of the cotangents."""
    mesh = current()
    src = _sources(mesh.size(name), name, perm)
    _count("collective-permute", x, mesh)
    if isinstance(mesh, RankMesh):
        return _on_ranks(_RankPpermute, x, mesh, name, tuple(src))
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
        return reduce_nway(readable(x, d), op="add", dim=d)
    if x.dtype in (torch.float16, torch.float64):
        total = x.select(d, 0)
        for i in range(1, x.shape[d]):
            total = total + x.select(d, i)
        return total
    if x.dtype in _INTS:
        return x.sum(d, dtype=torch.int64).to(x.dtype)
    raise TypeError(f"psum: unsupported dtype {x.dtype}")


def _counted(fn, *args):
    """``fn(*args)`` run by a backward pass: its ``reduce_nway`` launches are
    also counted in ``reduce_nway.backward_launches``."""
    counter = _kernel.reduce_nway  # the wrapper's counts, whatever the caller patched in
    before = counter.launches
    out = fn(*args)
    counter.backward_launches += counter.launches - before
    return out


class _Broadcast(torch.autograd.Function):
    """A per-member value copied to the ``n`` members along the axis' dim
    ``d`` (an ``expand``).  Its transpose sums the cotangents over that dim
    with :func:`axis_sum`, so the backward of ``psum`` and ``all_gather``
    on the stacked mesh runs the ``reduce_nway`` kernel as the forward of
    ``psum`` does."""

    @staticmethod
    def forward(ctx, y, d, n, kind):
        ctx.d, ctx.kind, ctx.mesh = d, kind, current()
        y = y.unsqueeze(d)
        return y.expand(y.shape[:d] + (n,) + y.shape[d + 1:])

    @staticmethod
    def backward(ctx, g):
        out = _counted(axis_sum, g, ctx.d)
        _count(ctx.kind, g if ctx.kind == "all-reduce" else out, ctx.mesh)
        return out, None, None, None


def _broadcast(y: torch.Tensor, d: int, n: int, kind: str) -> torch.Tensor:
    """``y`` copied to the ``n`` members along dim ``d``; ``kind`` names
    its transpose for the counts: ``all-reduce`` (the transpose of
    ``psum``) or ``reduce-scatter`` (of ``all_gather``)."""
    if y.is_floating_point():
        return _Broadcast.apply(y, d, n, kind)
    y = y.unsqueeze(d)
    return y.expand(y.shape[:d] + (n,) + y.shape[d + 1:])


@spanned("collective.psum")
def psum(x: torch.Tensor, name: str) -> torch.Tensor:
    """Sum over the axis (:func:`axis_sum`), replicated to every member.
    Its gradient is the ``psum`` of the cotangents (integers carry none)."""
    mesh = current()
    _count("all-reduce", x, mesh)
    if isinstance(mesh, RankMesh):
        return _on_ranks(_RankPsum, x, mesh, name)
    d = mesh.dim(name)
    return _broadcast(axis_sum(x, d), d, x.shape[d], "all-reduce")


@spanned("collective.pmax")
def pmax(x: torch.Tensor, name: str) -> torch.Tensor:
    """Maximum over the axis (the ``reduce_nway`` kernel's ``max`` over its
    dim), replicated to every member, as ``jax.lax.pmax``.  It carries no
    gradient: an input that requires one raises."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("pmax carries no gradient; detach its input")
    mesh = current()
    _count("all-reduce", x, mesh)
    if isinstance(mesh, RankMesh):
        return mesh.pmax(x, name)
    d = mesh.dim(name)
    return reduce_nway(readable(x, d), op="max", dim=d).unsqueeze(d).expand(x.shape)


@spanned("collective.psum_scatter")
def psum_scatter(x: torch.Tensor, name: str, tiled: bool = True) -> torch.Tensor:
    """Sum over the axis, scattering the member's dim 0 across it.  Its
    gradient is the ``all_gather`` of the cotangents."""
    mesh = current()
    k, n = mesh.stacked, mesh.size(name)
    rows = x.shape[k]
    if rows % n:
        raise ValueError(f"psum_scatter: dim of size {rows} not divisible by {n}")
    if not tiled and rows != n:
        raise ValueError(f"psum_scatter(tiled=False) needs dim 0 of size {n}, got {rows}")
    if isinstance(mesh, RankMesh):
        out = _on_ranks(_RankPsumScatter, x, mesh, name)
        _count("reduce-scatter", out, mesh)
        return out if tiled else out.squeeze(0)
    d = mesh.dim(name)
    total = axis_sum(x, d)  # member dim 0 is now k-1
    parts = total.unflatten(k - 1, (n, rows // n)).movedim(k - 1, d)
    _count("reduce-scatter", parts, mesh)
    return parts if tiled else parts.squeeze(k)


@spanned("collective.all_gather")
def all_gather(x: torch.Tensor, name: str, tiled: bool = True) -> torch.Tensor:
    """Every member receives all members' ``x`` along the axis: stacked on a
    new dim 0, or concatenated on dim 0 when ``tiled``.  Its gradient is the
    ``psum_scatter`` of the cotangents."""
    mesh = current()
    if isinstance(mesh, RankMesh):
        g = _on_ranks(_RankAllGather, x, mesh, name)
        _count("all-gather", g, mesh)
        return g.flatten(0, 1) if tiled else g
    d, k, n = mesh.dim(name), mesh.stacked, mesh.size(name)
    g = x.movedim(d, k - 1)  # the axis' members, just before the member dims
    if tiled:
        g = g.flatten(k - 1, k)
    out = _broadcast(g, d, n, "reduce-scatter")
    _count("all-gather", out, mesh)
    return out


@spanned("collective.all_to_all")
def all_to_all(x: torch.Tensor, name: str, split_axis: int, concat_axis: int,
               tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(x, name, split_axis, concat_axis, tiled=True)``.

    The member's dim ``split_axis`` (counted from ``mesh.stacked``) is cut
    into one block per member of the axis; block ``j`` goes to member
    ``j``, which concatenates the blocks it receives along its dim
    ``concat_axis`` in member order.  On the stacked mesh this is pure data
    movement: the axis' dim and the block dim trade places, and one
    ``contiguous`` copy lays the result out.  Its gradient is the mirrored
    ``all_to_all`` (``split_axis`` and ``concat_axis`` swapped).
    """
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form is ported")
    mesh = current()
    k, n = mesh.stacked, mesh.size(name)
    rows = x.shape[k + split_axis]
    if rows % n:
        raise ValueError(f"all_to_all: dim of size {rows} not divisible by {n}")
    _count("all-to-all", x, mesh)
    if isinstance(mesh, RankMesh):
        return _on_ranks(_RankAllToAll, x, mesh, name, split_axis, concat_axis)
    d, s = mesh.dim(name), k + split_axis
    c = k + concat_axis
    c = c if c < s else c + 1  # the concat dim once the block dim is inserted at s
    t = x.unflatten(s, (n, rows // n)).transpose(d, s)  # dim s: the sending member
    if c > s:
        t = t.movedim(s, c - 1).flatten(c - 1, c)
    else:
        t = t.movedim(s, c).flatten(c, c + 1)
    return t.contiguous()


def take(x: torch.Tensor, i: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed at the per-member position ``i`` along ``dim`` (dropped)."""
    shape = list(x.shape)
    shape[dim] = 1
    return x.gather(dim, lift(i, x).expand(shape)).squeeze(dim)


def put(x: torch.Tensor, i: torch.Tensor, v: torch.Tensor, dim: int) -> torch.Tensor:
    """A copy of ``x`` with position ``i`` (per member) along ``dim`` set to ``v``."""
    v = v.unsqueeze(dim)
    return x.scatter(dim, lift(i, x).expand(v.shape), v)


def block_of(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This member's block of its local dim ``dim`` (counted from
    ``mesh.stacked``) of a tensor that every member along ``axes`` holds
    whole: block ``j`` for the member whose indices along ``axes`` (major
    to minor) give ``j``, the layout that :func:`shard` gives a dim split
    over them.  Local: nothing moves between members."""
    mesh = current()
    d = mesh.stacked + dim
    n, index = 1, 0
    for a in axes:
        n, index = n * mesh.size(a), index * mesh.size(a) + axis_index(a)
    return take(x.unflatten(d, (n, -1)), index, d)


def gather_blocks(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The inverse of :func:`block_of`: the members' blocks along ``axes``
    concatenated on local dim ``dim`` (an ``all_gather`` over each axis,
    minor first)."""
    k = current().stacked
    for a in reversed(tuple(axes)):
        x = all_gather(x.movedim(k + dim, k), a, tiled=True).movedim(k, k + dim)
    return x


# ---------------------------------------------------------------------------
# One process per member
# ---------------------------------------------------------------------------


class RankMesh(_Axes):
    """A logical device mesh whose members are processes, one per card.

    Member ``i`` in row-major order over ``shape`` is the process of global
    rank ``ranks[i]`` (``ranks`` defaults to ``range(prod(shape))``; it is
    sorted).  Each axis has one process group per line of members that
    differ only along it; every process of the job builds every group, in
    one order, so every process must construct the mesh, a member or not
    (``member`` says which).  ``device=None`` or ``"cuda"`` means NCCL on
    ``cuda:<rank % card count>`` (None raises without a card);
    ``device="cpu"`` means gloo.  The default process group is the
    caller's: an existing one is used, else ``init_method`` with ``rank``
    starts one of the mesh's size.
    """

    stacked = 0

    def __init__(self, shape, axis_names, device=None, ranks=None, init_method=None,
                 rank=None):
        self._set_axes(shape, axis_names)
        size = math.prod(self.shape)
        ranks = sorted(range(size) if ranks is None else ranks)
        if len(ranks) != size:
            raise ValueError(f"a mesh of shape {self.shape} needs {size} ranks, got {ranks}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("RankMesh: no CUDA device; pass device='cpu' for gloo "
                                   "ranks on the host")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            me = rank if rank is not None else (dist.get_rank() if dist.is_initialized() else 0)
            self.device = torch.device("cuda", me % torch.cuda.device_count())
        self.backend = "gloo" if self.device.type == "cpu" else "nccl"
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if not dist.is_initialized():
            if init_method is None or rank is None:
                raise ValueError("RankMesh: no process group; pass init_method and rank")
            dist.init_process_group(self.backend, init_method=init_method, rank=rank,
                                    world_size=size)
        self.ranks = tuple(ranks)
        self.rank = dist.get_rank()
        self.member = self.rank in self.ranks
        at = self.ranks.index(self.rank) if self.member else 0
        self.coord = tuple(int(c) for c in _unravel(at, self.shape))
        self.group = dist.new_group(list(self.ranks), backend=self.backend)
        self._groups, self._peers = {}, {}
        for d, name in enumerate(self.axis_names):
            others = self.shape[:d] + (1,) + self.shape[d + 1:]
            for line in range(math.prod(others)):
                base = list(_unravel(line, others))
                members = []
                for c in range(self.shape[d]):
                    base[d] = c
                    members.append(self.ranks[_ravel(base, self.shape)])
                group = dist.new_group(members, backend=self.backend)
                if self.rank in members:
                    self._groups[name], self._peers[name] = group, members

    def __repr__(self):
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return f"RankMesh({axes}, rank={self.rank}, {self.backend} on {self.device})"

    def _group(self, name: str):
        self.dim(name)
        if not self.member:
            raise RuntimeError(f"rank {self.rank} is not a member of {self!r}")
        return self._groups[name]

    def axis_index(self, name: str) -> torch.Tensor:
        return torch.tensor(self.coord[self.dim(name)], device=self.device)

    def ppermute(self, x, name, src):
        group, peers = self._group(name), self._peers[name]
        me = self.coord[self.dim(name)]
        dst = src.index(me)
        if src[me] == me:
            return x.clone()
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), peers[dst], group=group),
               dist.P2POp(dist.irecv, out, peers[src[me]], group=group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out

    def all_gather(self, x, name):
        """Every member's ``x`` of the axis, stacked on a new dim 0."""
        out = torch.empty((self.size(name),) + tuple(x.shape), dtype=x.dtype, device=x.device)
        _ALL_GATHER(out.view(-1), x.contiguous().view(-1), group=self._group(name))
        return out

    def _ordered_sum(self, x, name):
        """float16 and float64: added member by member in member order, in
        their own type (``axis_sum``)."""
        g = self.all_gather(x, name)
        total = g[0]
        for i in range(1, g.shape[0]):
            total = total + g[i]
        return total

    def _exchange(self, send, name):
        """Row ``j`` of ``send`` (``(n, ...)``, contiguous) to member ``j``;
        row ``i`` of the result is what member ``i`` sent here.  Moved as
        bytes (``all_to_all_single``), so that any dtype goes."""
        n = self.size(name)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(n, -1).view(torch.uint8),
                               send.view(n, -1).view(torch.uint8), group=self._group(name))
        return recv

    def _scatter_sum(self, x, name):
        """float32 and bfloat16: ``x`` flattened (zero-padded to a multiple
        of n) and cut into n blocks; block ``j`` of every member goes to
        member ``j``, which sums the n blocks it receives with the
        ``reduce_nway`` router in member order, the stacked mesh's
        arithmetic.  Returns this member's summed block; each rank sends
        and receives (n-1)/n of ``x``, as a ring reduce-scatter does."""
        n = self.size(name)
        flat = x.reshape(-1)
        if flat.numel() % n:
            flat = torch.cat([flat, flat.new_zeros(-flat.numel() % n)])
        return reduce_nway(self._exchange(flat.view(n, -1).contiguous(), name), op="add",
                           dim=0)

    def psum(self, x, name):
        """float32 and bfloat16: :meth:`_scatter_sum`, then every member's
        summed block gathered (2(n-1)/n of ``x`` in and out per rank, as a
        ring all-reduce), so the two meshes give equal sums."""
        if x.dtype in (torch.float16, torch.float64):
            return self._ordered_sum(x, name)
        if x.dtype in (torch.float32, torch.bfloat16):
            total = self.all_gather(self._scatter_sum(x, name), name)
            return total.view(-1)[:x.numel()].view(x.shape)
        wide = _sum_type(x.dtype)
        y = x.to(wide, copy=True).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self._group(name))
        return y.to(x.dtype)

    def pmax(self, x, name):
        """The types of the ``reduce_nway`` router's ``max``; bfloat16 goes
        through f32 (exact)."""
        if x.dtype not in (torch.float32, torch.bfloat16, torch.int32):
            raise TypeError(f"pmax: unsupported dtype {x.dtype}")
        y = x.to(torch.float32 if x.dtype == torch.bfloat16 else x.dtype, copy=True).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self._group(name))
        return y.to(x.dtype)

    def psum_scatter(self, x, name):
        """The summed ``x`` (as :meth:`psum`), this member's block of dim 0."""
        n, me = self.size(name), self.coord[self.dim(name)]
        if x.dtype in (torch.float16, torch.float64):
            return self._ordered_sum(x, name).unflatten(0, (n, -1))[me]
        if x.dtype in (torch.float32, torch.bfloat16):  # dim 0 divides: block me is rows me
            return self._scatter_sum(x, name).view((x.shape[0] // n,) + tuple(x.shape[1:]))
        wide = _sum_type(x.dtype)
        y = x.to(wide).contiguous()
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=wide, device=x.device)
        _REDUCE_SCATTER(out, y, dist.ReduceOp.SUM, group=self._group(name))
        return out.to(x.dtype)

    def all_to_all(self, x, name, split_axis, concat_axis):
        """Tiled ``all_to_all`` (:func:`all_to_all`): ``all_to_all_single``
        over the axis' group, moved as bytes so that any dtype goes."""
        send = x.unflatten(split_axis, (self.size(name), -1)).movedim(split_axis, 0)
        recv = self._exchange(send.contiguous(), name)
        return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)

    def broadcast_first(self, x):
        """Member 0's ``x`` on every member of the mesh."""
        y = x.detach().clone().contiguous()
        if self.member:
            dist.broadcast(y, src=self.ranks[0], group=self.group)
        return y

    def barrier(self):
        if self.member:
            dist.barrier(group=self.group)


# The rank mesh's collectives, each with its transpose (the ones ``shard_map``
# uses); ``_on_ranks`` applies one to a float tensor, and calls the method
# for any other.


def _on_ranks(fn, x, mesh, name, *args):
    if x.is_floating_point():
        return fn.apply(x, mesh, name, *args)
    return getattr(mesh, fn.method)(x, name, *args)


class _RankPsum(torch.autograd.Function):
    method = "psum"

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return mesh.psum(x, name)

    @staticmethod
    def backward(ctx, g):
        _count("all-reduce", g, ctx.mesh)
        return _counted(ctx.mesh.psum, g.contiguous(), ctx.name), None, None


class _RankPsumScatter(torch.autograd.Function):
    method = "psum_scatter"

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return mesh.psum_scatter(x, name)

    @staticmethod
    def backward(ctx, g):
        out = ctx.mesh.all_gather(g.contiguous(), ctx.name).flatten(0, 1)
        _count("all-gather", out, ctx.mesh)
        return out, None, None


class _RankAllGather(torch.autograd.Function):
    method = "all_gather"

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return mesh.all_gather(x, name)

    @staticmethod
    def backward(ctx, g):  # (n, *x.shape) -> this member's summed row
        out = _counted(ctx.mesh.psum_scatter, g.contiguous(), ctx.name)[0]
        _count("reduce-scatter", out, ctx.mesh)
        return out, None, None


class _RankAllToAll(torch.autograd.Function):
    method = "all_to_all"

    @staticmethod
    def forward(ctx, x, mesh, name, split_axis, concat_axis):
        ctx.mesh, ctx.name, ctx.axes = mesh, name, (split_axis, concat_axis)
        return mesh.all_to_all(x, name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        _count("all-to-all", g, ctx.mesh)
        return (ctx.mesh.all_to_all(g.contiguous(), ctx.name, concat_axis, split_axis),
                None, None, None, None)


class _RankPpermute(torch.autograd.Function):
    method = "ppermute"

    @staticmethod
    def forward(ctx, x, mesh, name, src):
        ctx.mesh, ctx.name, ctx.src = mesh, name, src
        return mesh.ppermute(x, name, list(src))

    @staticmethod
    def backward(ctx, g):
        inverse = [ctx.src.index(i) for i in range(len(ctx.src))]
        _count("collective-permute", g, ctx.mesh)
        return ctx.mesh.ppermute(g.contiguous(), ctx.name, inverse), None, None, None


def _sum_type(dtype):
    """The type a rank mesh's ``all_reduce`` / ``reduce_scatter`` sum
    integers in: int64, cast back (wrapping as int32 adds)."""
    if dtype in _INTS:
        return torch.int64
    raise TypeError(f"psum: unsupported dtype {dtype}")


# Newer torch renames these two collectives (the old names warn); older
# torch has only the old names.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _unravel(i: int, shape) -> list:
    out = []
    for s in reversed(shape):
        out.append(i % s)
        i //= s
    return out[::-1]


def _ravel(coord, shape) -> int:
    i = 0
    for c, s in zip(coord, shape):
        i = i * s + c
    return i


# ---------------------------------------------------------------------------
# shard_map layouts
# ---------------------------------------------------------------------------


def _spec(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def _axes_of(entry) -> tuple:
    """The mesh axes of one spec entry: none, one name, or a tuple of names
    (major to minor)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _named(spec, mesh) -> set:
    """The axes that ``spec`` names; each at most once, each of ``mesh``."""
    seen = set()
    for entry in spec:
        for name in _axes_of(entry):
            mesh.dim(name)
            if name in seen:
                raise ValueError(f"axis {name!r} used twice in spec {spec}")
            seen.add(name)
    return seen


def shard(x, mesh, spec) -> torch.Tensor:
    """Lay a global array out on the mesh under ``PartitionSpec(*spec)``.

    Dim ``i`` of ``x`` is split over the axes ``spec[i]`` (one name or a
    tuple, major to minor: block ``j`` to the member whose indices along
    them give ``j`` in row-major order), or kept whole for ``None``;
    members along an axis that ``spec`` does not name get copies.  On a
    rank mesh the result is this member's block.
    """
    x = torch.as_tensor(x, device=mesh.device)
    spec = _spec(spec, x.ndim)
    _named(spec, mesh)
    for g, entry in zip(x.shape, spec):
        n = math.prod(mesh.size(name) for name in _axes_of(entry))
        if g % n:
            raise ValueError(f"dim of size {g} not divisible by axes {_axes_of(entry)} of size {n}")
    if isinstance(mesh, RankMesh):
        for i, entry in enumerate(spec):
            names = _axes_of(entry)
            if names:
                sizes = [mesh.size(a) for a in names]
                block = _ravel([mesh.coord[mesh.dim(a)] for a in names], sizes)
                step = x.shape[i] // math.prod(sizes)
                x = x.narrow(i, block * step, step)
        return x.contiguous()
    split, at = [], {}
    for g, entry in zip(x.shape, spec):
        names = _axes_of(entry)
        for name in names:
            at[name] = len(split)
            split.append(mesh.size(name))
        split.append(g // math.prod(mesh.size(name) for name in names))
    y = x.reshape(split)
    lead = [at[name] for name in mesh.axis_names if name in at]
    y = y.permute(lead + [p for p in range(y.ndim) if p not in lead])
    for d, name in enumerate(mesh.axis_names):
        if name not in at:
            y = y.unsqueeze(d)
    return y.expand(mesh.shape + tuple(y.shape[mesh.ndim:])).contiguous()


def unshard(y: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global array of a tensor laid out under ``spec``.

    Axes that ``spec`` does not name hold copies; member 0's is returned,
    as ``shard_map`` does for an unchecked replicated output.  On a rank
    mesh every member takes part and receives the global array.
    """
    local = tuple(y.shape[mesh.stacked:])
    spec = _spec(spec, len(local))
    named = _named(spec, mesh)
    if isinstance(mesh, RankMesh):
        with mesh:
            for name in mesh.axis_names:
                if name not in named:  # member 0's copy along this axis
                    y = y.clone(memory_format=torch.contiguous_format)
                    dist.broadcast(y, src=mesh._peers[name][0], group=mesh._group(name))
            for i, entry in enumerate(spec):
                for name in reversed(_axes_of(entry)):  # minor axis first
                    y = all_gather(y.movedim(i, 0), name, tiled=True).movedim(0, i)
        return y
    y = y[tuple(slice(None) if name in named else 0 for name in mesh.axis_names)]
    lead = [name for name in mesh.axis_names if name in named]
    order, shape = [], []
    for i, entry in enumerate(spec):
        names = _axes_of(entry)
        order += [lead.index(name) for name in names]
        order.append(len(lead) + i)
        shape.append(local[i] * math.prod(mesh.size(name) for name in names))
    return y.permute(order).reshape(shape)


def copies(mesh, spec) -> int:
    """How many members hold each block of a tensor laid out under ``spec``:
    the product of the sizes of the axes that ``spec`` does not name."""
    named = _named(spec, mesh)
    return math.prod(s for a, s in zip(mesh.axis_names, mesh.shape) if a not in named)


@spanned("collective.sum_copies")
def sum_copies(g: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The adjoint of :func:`shard`: a laid-out gradient's copies along the
    axes that ``spec`` does not name summed (a ``psum`` over each), so that
    every copy holds its block of the global gradient.  Over the batch axes
    this is the data-parallel all-reduce."""
    named = _named(spec, mesh)
    with mesh:
        for name, size in zip(mesh.axis_names, mesh.shape):
            if name not in named and size > 1:
                g = psum(g, name)
    return g
