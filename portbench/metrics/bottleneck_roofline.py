"""Fused bottleneck kernel #7 (kernels/bottleneck.py,
`bottleneck_wgmma_kernel`): the least time of ResNet-50's six stride-1
blocks of stages 0 and 1 at the cell's shapes over their device time a
forward in the profiled stretch, in %."""
from portbench import yardstick

NAME, UNIT, KIND, SOURCE = "bottleneck_roofline", "%", "detect", "device_trace"
LAYER, MOVES = "kernels", "detect_img_s"
CALLS = 6


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx["config"]["family"] != "fcos":
        return None
    secs, launches = yardstick.kernel_seconds(trace, "bottleneck_")
    if not launches:
        return None
    bound = yardstick.bottleneck_bound_ms(yardstick.resnet_fused_blocks(
        ctx["batch"], ctx["config"]["input_size"]))
    return 100.0 * bound / (secs * 1e3 * CALLS / launches)
