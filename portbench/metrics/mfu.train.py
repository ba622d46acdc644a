"""mfu.train: the model FLOPs of a step (3 x the forward: 2 per weight per
token, the head included; 4 head_dim per live causal pair per head; the
remat recompute not counted), from the configuration's widths, times the
steps completed, over the window, as a share of the bf16 peak (989
TFLOP/s)."""

from portbench import flops


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    s = run.shapes
    done = flops.train_flops(s["config"], s["batch"], s["seq"]) * run.units
    return 100.0 * done / run.window_s / flops.PEAK_BF16
