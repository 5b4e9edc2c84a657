"""GN kernel #3 (kernels/gn.py, `gn_fwd_kernel`): the least time of FCOS's
40 tower bias + GroupNorm + ReLU calls at the cell's shapes over their
device time a forward in the profiled stretch, in %."""
from portbench import yardstick

NAME, UNIT, KIND, SOURCE = "gn_roofline", "%", "detect", "device_trace"
LAYER, MOVES = "kernels", "detect_img_s"
CALLS = 40


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx["config"]["family"] != "fcos":
        return None
    secs, launches = yardstick.kernel_seconds(trace, "gn_fwd_kernel")
    if not launches:
        return None
    bound = yardstick.gn_bound_ms(yardstick.fcos_gn_shapes(
        ctx["batch"], ctx["config"]["input_size"]))
    return 100.0 * bound / (secs * 1e3 * CALLS / launches)
