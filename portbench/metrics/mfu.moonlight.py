"""mfu.moonlight: the model FLOPs of a step (``flops_moonlight.train_flops``:
3 x the forward, the routed and shared experts, MLA's projections and its
attention at 2 (192 + 128) per live pair per head, the head; the remat
recompute not counted), times the steps completed, over the window, as a
share of the bf16 peak (989 TFLOP/s)."""

from portbench import flops, flops_moonlight


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    s = run.shapes
    done = flops_moonlight.train_flops(s["config"], s["batch"], s["seq"]) * run.units
    return 100.0 * done / run.window_s / flops.PEAK_BF16
