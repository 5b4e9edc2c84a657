"""GN training kernels #4 and #5 (kernels/gn.py: `gn_fwd_kernel` with
statistics, `gn_bwd_kernel` and its `sum_parts_kernel`): the least time of
a step's 40 forward and 40 backward calls at the cell's shapes over their
device time a step in the profiled stretch, in %."""
from portbench import yardstick

NAME, UNIT, KIND, SOURCE = "gn_train_roofline", "%", "train", "device_trace"
LAYER, MOVES = "kernels", "train_img_s"
CALLS = 40


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx["config"]["family"] != "fcos":
        return None
    fwd, launches = yardstick.kernel_seconds(trace, "gn_fwd_kernel")
    bwd, _ = yardstick.kernel_seconds(trace, "gn_bwd_kernel",
                                      "sum_parts_kernel")
    if not launches:
        return None
    bound = yardstick.gn_bound_ms(yardstick.fcos_gn_shapes(
        ctx["batch"], ctx["config"]["input_size"]), train=True)
    return 100.0 * bound / ((fwd + bwd) * 1e3 * CALLS / launches)
