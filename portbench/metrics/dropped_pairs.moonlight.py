"""dropped_pairs.moonlight: the share, in %, of the (token, choice) pairs
that the MoE's routers chose in the window that capacity dropped: the
program's counters ``moe.dropped_pairs`` over ``moe.routed_pairs``
(``repro_torch/tracing.py``), counted on the card while the profiler
recorded, the remat recompute not counted again; None without them."""


def read(run):
    counts = getattr(run, "counters", None) or {}
    routed = counts.get("moe.routed_pairs", 0)
    if run.trace is None or routed <= 0:
        return None
    return 100.0 * counts.get("moe.dropped_pairs", 0) / routed
