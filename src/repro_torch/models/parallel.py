"""The sharded bodies' view of a mesh: layouts and the collectives between them.

The reference partitions its model functions by the parameter specs under
a ``(data, model)`` mesh (GSPMD, and ``shard_map`` for the expert-parallel
MoE).  The port writes the partitioned bodies out.  A model laid out by
``models.convert.shard_model`` holds each parameter as ``core.mesh.shard``
lays it out under its family's ``param_specs``: the mesh dims leading on
the stacked mesh (``core.mesh.Mesh``), the member's block on a rank mesh
(``RankMesh``).  Activations take the same form: ``(*lead, B, S, d)``,
``lead`` being the mesh dims (none on a rank mesh), each member holding its
block of the batch over ``policy.batch_axes`` and the whole of it over the
model axis (the reference's ``act_bsd``).  With sequence parallelism
(``policy.seq_axis``, which must be the model axis) each member holds its
block of S between the blocks instead.

Between the two, a column-parallel product keeps its columns on the
member; a row-parallel one ends in a ``psum`` over the model axis (the
``reduce_nway`` router); heads that a weight's spec splits mid-head, kv
heads that do not cover the member's query heads, and the vocab-parallel
logits are gathered over the model axis (``all_gather``).  Under sequence
parallelism the pair is the paper's own: S is gathered (a multicast)
before attention's QKV and the MLP's first products, and the row-parallel
``psum`` becomes a ``psum_scatter`` on S (an in-network reduction) that
leaves each member its block of S.  Every body runs under ``with mesh:``
and reads the mesh from there.  All four families have such bodies (the
transformer, the recurrentgemma hybrid, rwkv6 and whisper); they share
the vocab-parallel embedding and head (:func:`vocab_embed`,
:func:`vocab_logits`).

Gradients.  Every axis function of ``core/mesh.py`` carries its transpose,
the one ``shard_map`` uses: ``psum`` -> ``psum`` of the cotangents (the
``reduce_nway`` kernel again), ``all_gather`` -> ``psum_scatter``,
``psum_scatter`` -> ``all_gather``, ``all_to_all`` -> the mirrored
``all_to_all``, ``ppermute`` -> the inverse permutation; ``pmax`` carries
none (the loss detaches its shift).  So autograd gives the true
derivative on both mesh kinds, under one convention:

* the backward loss is the mean over the members of each member's (equal)
  global loss: the mean over the mesh dims on the stacked mesh, a seed of
  1/n on each of the n ranks of a rank mesh (:meth:`Members.backward_loss`),
  so that every rank runs the same program;
* the global gradient of a parameter is the adjoint of ``core.mesh.shard``:
  its copies along the mesh axes that its spec does not name are summed
  (``core.mesh.sum_copies``: a ``psum`` over each such axis; over the
  batch axes this is the data-parallel all-reduce).  Every copy then holds
  its block of the global gradient, and AdamW on the laid-out parameters
  keeps the copies equal.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import mesh as M
from repro_torch.models.common import REPLICATED, ModelConfig, ShardingPolicy, rms_norm


def is_sharded(policy: ShardingPolicy) -> bool:
    """Whether ``policy`` lays anything out over a mesh axis."""
    if not isinstance(policy, ShardingPolicy):  # e.g. max_len passed where policy goes
        raise TypeError(f"a ShardingPolicy is expected, got {policy!r}")
    return policy.model_axis is not None or bool(policy.batch_axes)


def check_layout(model, policy: ShardingPolicy):
    """The mesh that ``model`` was laid out on for ``policy``, or None for an
    unsharded model run with ``REPLICATED``-like policy; anything else raises."""
    mesh = getattr(model, "mesh", None)
    if not is_sharded(policy):
        if mesh is not None:
            raise ValueError(f"the model is laid out on {mesh!r}; pass the policy it was "
                             "laid out for (models.convert.shard_model)")
        return None
    if mesh is None:
        raise ValueError("a sharded policy needs a model laid out on a mesh "
                         "(models.convert.shard_model)")
    if model.policy != policy:
        raise ValueError(f"the model was laid out for {model.policy}, not {policy}")
    if policy.seq_axis is not None and policy.seq_axis != policy.model_axis:
        raise NotImplementedError(
            f"sequence parallelism over {policy.seq_axis!r}, not the model axis "
            f"{policy.model_axis!r}, is not ported (ROADMAP.md)")
    return mesh


def check_policy(mesh, policy: ShardingPolicy):
    """``policy`` must name axes of ``mesh`` at the mesh's sizes."""
    axes = tuple(policy.batch_axes) + ((policy.model_axis,) if policy.model_axis else ())
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"policy axis {a!r} is not an axis of {mesh!r}")
        if policy.mesh_axis_sizes.get(a, 1) != mesh.size(a):
            raise ValueError(f"policy has {a!r} of size {policy.mesh_axis_sizes.get(a, 1)}, "
                             f"the mesh {mesh.size(a)}")


class Members:
    """The current mesh (``with mesh:``) as ``policy`` uses it."""

    def __init__(self, policy: ShardingPolicy = REPLICATED):
        self.mesh = M.current()
        self.policy = policy
        self.k = self.mesh.stacked
        self.axis = policy.model_axis
        self.tp = self.mesh.size(self.axis) if self.axis else 1
        self.batch = tuple(policy.batch_axes)
        self.seq = policy.seq_axis is not None and self.tp > 1

    def split(self, spec) -> bool:
        """Whether a parameter spec cuts a dim over the model axis."""
        return self.axis is not None and self.axis in spec

    # -- local arithmetic --
    def mm(self, x, w):
        """``x @ w`` for each member: x (*lead, ..., n), w (*lead, n, m)."""
        k = self.k
        y = x.reshape(x.shape[:k] + (-1, x.shape[-1])) @ w
        return y.reshape(x.shape[:-1] + (w.shape[-1],))

    def bcast(self, p, like):
        """A per-member parameter (*lead, n) against ``like`` (*lead, ..., n)."""
        k = self.k
        return p.reshape(p.shape[:k] + (1,) * (like.ndim - p.ndim) + p.shape[k:])

    # -- the model axis --
    def psum(self, x):
        return M.psum(x, self.axis) if self.axis else x

    def gather(self, x, dim: int):
        """The members' blocks of local dim ``dim`` (from the end when
        negative), concatenated in member order."""
        dim = dim % x.ndim
        k = self.k
        return M.all_gather(x.movedim(dim, k), self.axis, tiled=True).movedim(k, dim)

    def index(self):
        return M.axis_index(self.axis)

    # -- sequence parallelism (the S dim, local dim -2) --
    def gather_seq(self, x):
        """The whole of S from the members' blocks (before attention and the
        MLP); ``x`` as it is without sequence parallelism."""
        return self.gather(x, -2) if self.seq else x

    def row_out(self, x, split: bool):
        """The end of a product whose rows the spec may split (``split``):
        the members' partial sums summed over the model axis, and under
        sequence parallelism scattered on S (``psum_scatter``), or, for a
        whole product, the member's block of S."""
        if not self.seq:
            return self.psum(x) if split else x
        if not split:
            return self.block(x, -2)
        k = self.k
        return M.psum_scatter(x.movedim(-2, k), self.axis, tiled=True).movedim(k, -2)

    def check_seq(self, S: int):
        """Under sequence parallelism S must split evenly over the model axis."""
        if self.seq and S % self.tp:
            raise ValueError(f"sequence parallelism over {self.tp} members needs S divisible "
                             f"by {self.tp}, got {S}")

    def block(self, x, dim: int):
        """This member's block of local dim ``dim`` of a replicated tensor."""
        dim = dim % x.ndim
        return M.take(x.unflatten(dim, (self.tp, -1)), self.index(), dim)

    # -- the batch axes --
    def _bspec(self, ndim: int) -> tuple:
        return (self.batch or None,) + (None,) * (ndim - 1)

    def shard_batch(self, x):
        """A global (B, ...) tensor split over the batch axes, whole over
        the others."""
        return M.shard(x, self.mesh, self._bspec(x.ndim))

    def unshard_batch(self, y):
        """The global tensor of a batch-split one (member 0 of the others)."""
        return M.unshard(y, self.mesh, self._bspec(y.ndim - self.k))

    def first(self, y):
        """Member 0's value of a per-member one (an unchecked ``P()`` output)."""
        return M.unshard(y, self.mesh, ())

    def backward_loss(self, loss):
        """The members' equal global ``loss`` (one value a member) as the
        scalar to differentiate: its value, with each member's share of the
        backward 1/n of the mesh's n members (the gradient convention above)."""
        if self.k:
            return loss.mean()
        return _Share.apply(loss, math.prod(self.mesh.shape))


class _Share(torch.autograd.Function):
    """The identity, whose backward scales the cotangent by 1/n."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


# ---------------------------------------------------------------------------
# The vocab-parallel embedding and head, which every family shares
# ---------------------------------------------------------------------------


def vocab_embed(table, tokens, cfg: ModelConfig, mb: Members):
    """The member's rows of the global ``tokens`` looked up in ``table``
    (laid out as ``policy.embed``): (*lead, B, S, d) in the compute dtype,
    or the member's block of S under sequence parallelism.  With the vocab
    split over the model axis, each member looks up the tokens of its own
    rows (zero elsewhere) and the members' rows are summed (and scattered
    on S)."""
    mb.check_seq(tokens.shape[-1])
    tok = mb.shard_batch(tokens)
    lead, (V, d) = table.shape[:mb.k], table.shape[mb.k:]
    split = mb.split(mb.policy.embed(cfg.padded_vocab))
    if split:
        tok = tok - M.lift(mb.index(), tok) * V
        inside = (tok >= 0) & (tok < V)
        tok = torch.where(inside, tok, 0)
    L = table[..., 0, 0].numel()
    base = (torch.arange(L, device=tok.device) * V).reshape(lead + (1,) * (tok.ndim - mb.k))
    rows = table.reshape(-1, d)[tok + base]
    if split:
        rows = torch.where(inside[..., None], rows, 0)
    return mb.row_out(rows, split).to(cfg.compute_dtype)


def vocab_logits(x, head, cfg: ModelConfig, mb: Members):
    """The global logits (B, padded vocab) in f32 of the member's normed
    last-token states ``x`` (*lead, B, d) against ``head`` (laid out as
    ``policy.embed``): the member's vocab slice, gathered over the model
    axis where the spec splits it."""
    logits = mb.mm(x.float(), head.float().transpose(-1, -2))
    if mb.split(mb.policy.embed(cfg.padded_vocab)):
        logits = mb.gather(logits, -1)
    return mb.unshard_batch(logits)


def rms_norm_tp(x, scale, cfg: ModelConfig, mb: Members):
    """``rms_norm`` of the member's ``x`` by its copy of ``scale``."""
    return rms_norm(x, mb.bcast(scale, x), cfg.norm_eps)


def last_token(x, mb: Members):
    """The last position's states (*lead, B, d) of (*lead, B, S, d): under
    sequence parallelism the last member's."""
    return mb.gather_seq(x[..., -1:, :])[..., -1, :]
