"""Int8 gradient compression with error feedback (``src/repro/optim/compress.py``).

``compress_int8`` / ``decompress_int8`` quantize one tensor on a grid of
max|g| / 127.  ``compressed_mean`` is the DP mean over a mesh axis
(``core/mesh.py``), on the stacked mesh and on a rank mesh alike: every
member quantizes on one grid, whose scale is the ``pmax`` of the members'
max|g| (on the stacked mesh the ``reduce_nway`` kernel's ``max``), and the
int32 payload is summed exactly (``psum``).  The data-parallel trainer
(``runtime/trainer.py``) calls it once a step.
"""

from __future__ import annotations

import torch

from repro_torch.core import mesh as M


def compress_int8(g, err=None):
    """Returns (q int8, scale, new err).  g: any float tensor."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.float() * scale


def decompress_int8(q, scale):
    return q.float() * scale


def compressed_mean(grads: dict, axis: str, err_tree: dict | None = None):
    """Quantized mean of the members' gradients over the mesh axis ``axis``.

    Each leaf of ``grads`` (name -> tensor whose leading dims are the
    enclosing mesh's stacked dims, none on a rank mesh) is quantized per
    member on the grid of the axis' ``pmax`` of max|g| / 127 (with the
    residual ``err_tree[name]`` added first when given), summed as int32
    over the axis, dequantized and averaged.  Returns (mean grads, new residuals), laid out as ``grads``.
    """
    mesh = M.current()
    n, k = mesh.size(axis), mesh.stacked

    def one(g, err):
        g32 = g.float() + (0.0 if err is None else err)
        amax = g32.abs().flatten(k).amax(-1) if g32.ndim > k else g32.abs()
        scale = torch.clamp(M.lift(M.pmax(amax, axis), g32) / 127.0, min=1e-12)
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        summed = M.psum(q.to(torch.int32), axis)
        mean = summed.float() * scale / n
        return mean.to(g.dtype), g32 - q * scale

    out = {name: one(g, None if err_tree is None else err_tree[name])
           for name, g in grads.items()}
    return {n_: o[0] for n_, o in out.items()}, {n_: o[1] for n_, o in out.items()}
