"""AdamW on a flat dict of parameters (``src/repro/optim/adamw.py``).

The state mirrors the parameters: ``m`` and ``v`` hold one f32 tensor per
parameter whatever the parameter's dtype, and ``step`` is an int32 tensor
on their device.  ``adamw_update`` clips by the global norm of the
gradients, corrects the moments' bias, decays every leaf (decoupled), and
computes the update in f32, cast back to each parameter's dtype; it is
functional, like the reference: it returns new tensors and leaves its
arguments as they are, unless the caller donates its moments
(``donate=True``, as the reference's jitted step donates its optimizer
state): each old moment is then dropped from ``state`` once its new one is
made, so that the update holds one copy of them, not two.
``torch.optim.AdamW`` is not used: it keeps a bf16 parameter's state in
bf16 and has no global clip.  ``opt_state_specs`` gives the state's
layout under ZeRO-1 over the data-parallel axes, as specs for
``core.mesh.shard`` (tuples in place of ``PartitionSpec``).

``adamw_update(..., update_specs=)`` is the reference's ZeRO-1 update on
laid-out leaves: with the state laid out by ``opt_state_specs``, each
member updates its 1/DP block of every f32 intermediate and only the new
parameters, in their own dtype, are gathered over the DP axes; the numbers
are those of the update without ``update_specs``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core import mesh as M


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: dict) -> dict:
    """Zero moments in f32 and step 0, beside ``params`` (name -> tensor)."""
    device = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for k, p in params.items()},
    }


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    """The sum of squares of ``g`` in f32, taken over its elements in
    row-major order whatever its memory layout: a reduction follows the
    memory, so a transposed gradient (a stacked mesh's tied embedding) would
    otherwise sum in another order than the same gradient laid out plainly
    (a rank mesh's), and the clip scale would differ in its last bit."""
    return torch.sum(torch.square(g.float().contiguous()))


def global_norm(tree: dict, layout=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.

    ``layout``, ``(mesh, specs by name)``, says that the leaves are laid
    out on a mesh (``core.mesh.shard``), their copies equal: each global
    element is then counted once, each block's sum divided by its number
    of copies, and on a rank mesh the members' sums added over every axis.
    """
    if layout is None:
        return torch.sqrt(sum(_sum_squares(g) for g in tree.values()))
    mesh, specs = layout
    total = sum(_sum_squares(g) / M.copies(mesh, specs[k]) for k, g in tree.items())
    if not mesh.stacked:
        with mesh:
            for name in mesh.axis_names:
                total = M.psum(total, name)
    return torch.sqrt(total)


def zero_dim(pspec, zspec, ndim: int):
    """(local dim, DP axes) where the state's spec ``zspec`` cuts a dim that
    the parameter's ``pspec`` keeps whole, or None where they agree."""
    pad = (lambda s: tuple(s) + (None,) * (ndim - len(tuple(s))))
    for i, (a, b) in enumerate(zip(pad(pspec), pad(zspec))):
        if a != b:
            return i, M._axes_of(b)
    return None


def adamw_update(params: dict, grads: dict, state: dict, cfg: AdamWConfig, lr_scale=1.0,
                 layout=None, update_specs=None, donate: bool = False):
    """Returns (new params, new state, metrics {"grad_norm", "lr"}).  With
    ``layout`` (:func:`global_norm`) the leaves are laid out on a mesh and
    the clip takes the global gradient's norm.

    ``update_specs`` (the state's specs by name, ``opt_state_specs(...)["m"]``;
    it needs ``layout``): each member updates its block of the leaves that
    the specs cut over the DP axes (``core.mesh.block_of``), and the new
    parameters are gathered (``core.mesh.gather_blocks``).  A gradient may
    come laid out as its parameter, or already as its state (a
    reduce-scatter's result); ``state["step"]`` may be 0-d or one value a
    member.  ``donate``: ``state``'s moments are given up (set to None as
    the new ones are made); the numbers are the same."""
    zero = {}
    if update_specs is not None:
        if layout is None:
            raise ValueError("adamw_update: update_specs needs the layout of the parameters")
        mesh, specs = layout
        k = mesh.stacked
        zero = {n: z for n, p in params.items()
                if (z := zero_dim(specs[n], update_specs[n], p.ndim - k)) is not None}
        cut = {n for n in zero if grads[n].shape != params[n].shape}
        layout = (mesh, {n: update_specs[n] if n in cut else specs[n] for n in params})
    gnorm = global_norm(grads, layout)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    lr = cfg.lr * lr_scale
    new_params, new_m, new_v = {}, {}, {}
    with contextlib.ExitStack() as ctx:
        if zero:
            ctx.enter_context(layout[0])
        for n, p in params.items():
            g, p32 = grads[n], p.detach()
            dim, axes = zero.get(n, (None, ()))
            if n in zero:
                p32 = M.block_of(p32, axes, dim)
                if g.shape == p.shape:
                    g = M.block_of(g, axes, dim)
            g, p32 = g.float() * scale, p32.float()
            m = cfg.b1 * state["m"][n] + (1 - cfg.b1) * g
            v = cfg.b2 * state["v"][n] + (1 - cfg.b2) * torch.square(g)
            if donate:
                state["m"][n] = state["v"][n] = None
            new_p = p32 - lr * (m / M.lift(b1c, m) / (torch.sqrt(v / M.lift(b2c, v)) + cfg.eps)
                                + cfg.weight_decay * p32)
            new_p = new_p.to(p.dtype)
            if n in zero:
                new_p = M.gather_blocks(new_p, axes, dim)
            new_params[n], new_m[n], new_v[n] = new_p, m, v
    return new_params, {"step": step, "m": new_m, "v": new_v}, {"grad_norm": gnorm, "lr": lr}


def opt_state_specs(param_specs, param_shapes, batch_axes=("data",), zero1: bool = True,
                    axis_sizes: dict | None = None):
    """Specs of the optimizer state (ZeRO-1 over the DP axes).

    ``param_specs`` maps names (dicts may nest) to spec tuples;
    ``param_shapes`` matches it with tensors or shapes.  Each moment is
    split over ``batch_axes`` along the largest dim that the spec leaves
    whole and the DP degree divides (by size, not position, so that a cut
    depth sees the layout of the full model), or keeps the parameter's
    spec when no dim does.
    """
    dp = 1
    for a in batch_axes:
        dp *= (axis_sizes or {}).get(a, 1)

    def zspec(spec, shape):
        spec = tuple(spec)
        if not zero1 or dp <= 1:
            return spec
        dims = tuple(shape.shape) if hasattr(shape, "shape") else tuple(shape)
        parts = list(spec) + [None] * (len(dims) - len(spec))
        best, best_size = None, 0
        for i, (p, dim) in enumerate(zip(parts, dims)):
            if p is None and dim % dp == 0 and dim > best_size:
                best, best_size = i, dim
        if best is None:
            return spec
        parts[best] = tuple(batch_axes)
        return tuple(parts)

    def walk(specs, shapes):
        if isinstance(specs, dict):
            return {k: walk(v, shapes[k]) for k, v in specs.items()}
        return zspec(specs, shapes)

    m_specs = walk(param_specs, param_shapes)
    return {"step": (), "m": m_specs, "v": m_specs}
