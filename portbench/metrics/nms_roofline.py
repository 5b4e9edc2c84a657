"""NMS kernel #1 (kernels/nms.py, `nms_keep_kernel`): the least time of a
batch's keep-mask, from the reference's candidates and keep, over the
kernel's mean device time a launch in the profiled stretch, in %."""
import statistics

from portbench import yardstick

NAME, UNIT, KIND, SOURCE = "nms_roofline", "%", "detect", "device_trace"
LAYER, MOVES = "kernels", "detect_img_s"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    secs, launches = yardstick.kernel_seconds(trace, "nms_keep_kernel")
    if not launches:
        return None
    iou = ctx["config"]["nms_iou"]
    bound = statistics.fmean(yardstick.nms_bound_ms(b, v, k, iou)
                             for b, v, k in ctx["nms_inputs"])
    return 100.0 * bound / (secs * 1e3 / launches)
