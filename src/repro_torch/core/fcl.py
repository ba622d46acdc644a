"""FusedConcatLinear GEMM (Section 4.3.2, Fig. 8b).

Port of ``repro.core.fcl``.  Multi-head attention output projection with
one head(-group) per member: fusing the concat + linear layers turns the
projection into a GEMM distributed along K (the concatenated head dim),
leaving one *reduction* of the partial C across members — the paper's
wide in-network reduction use-case.

  y = concat_h(attn_h) @ W_o  ==  sum_h (attn_h @ W_o[h])

The partial products are one batched launch of the ``gemm`` kernel over all
members.  ``schedule`` selects the reduction: 'native' + DCA is the
``reduce_nway`` kernel over the mesh axis (or its scattered form when
``scatter=True``, which keeps the result sharded for a sharded consumer).
"""

from __future__ import annotations

from repro_torch.core import mesh as M
from repro_torch.core import schedules as sched
from repro_torch.kernels.ops import gemm


def fcl(attn_local, wo_local, axis: str, schedule: str = "native",
        scatter: bool = False, chunks: int = 4):
    """Local FCL body; call inside ``with mesh:``.

    attn_local: (..., tokens, hd_local) — each member's head-group activations;
    wo_local:   (..., hd_local, d_out)  — matching rows of W_o.
    Returns (..., tokens, d_out) replicated, or (..., tokens/n, d_out) if scatter.
    """
    partial_c = gemm(attn_local.float().contiguous(), wo_local.float().contiguous())
    partial_c = partial_c.to(attn_local.dtype)
    if scatter:
        return sched.reduce_scatter(partial_c, axis, schedule=schedule)
    return sched.all_reduce(partial_c, axis, schedule=schedule, chunks=chunks)


def fcl_sharded(attn, wo, mesh, axis: str = "model", schedule: str = "native",
                scatter: bool = False):
    """shard_map counterpart.

    attn: (tokens, H*hd) sharded on the head dim; wo: (H*hd, d) row-sharded.
    """
    out_spec = (axis, None) if scatter else (None, None)
    with mesh:
        y = fcl(M.shard(attn, mesh, (None, axis)), M.shard(wo, mesh, (axis, None)),
                axis, schedule=schedule, scatter=scatter)
    return M.unshard(y, mesh, out_spec)
