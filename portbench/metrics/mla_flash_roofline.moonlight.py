"""mla_flash_roofline.moonlight: MLA attention's forward FLOPs a step
(``flops_moonlight.attention_flops``: 2 (192 + 128) per live causal pair
per head, the unpadded work, over every layer, twice where the
configuration states remat: the forward and its recompute) at 989
TFLOP/s, over the device time of the flash forward kernel
(``flash_wgmma_kernel``, whose (192, 128) instantiation is MLA's; no other
attention runs in the cell)."""

from portbench import flops, flops_moonlight

FLASH = ("flash_wgmma_kernel",)  # the bf16 route, csrc/flash_attention_wgmma.cu


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds_in(FLASH)
    if spent <= 0:
        return None
    s = run.shapes
    passes = 2 if s["config"].get("remat") else 1
    work = passes * flops_moonlight.attention_flops(s["config"], s["batch"], s["seq"]) * run.units
    return 100.0 * work / flops.PEAK_BF16 / spent
