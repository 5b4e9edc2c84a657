"""Device time of the postprocess (ops/nms.py through `Detector._post`: top-k,
the gather, NMS kernel #1), by CUDA events around the call, mean over the
traced window's batches before its profiled stretch."""
import statistics

NAME, UNIT, KIND, SOURCE = "detect_post_ms", "ms", "detect", "program_span"
LAYER, MOVES = "postprocess (ops/nms.py)", "detect_img_s"


def read(ctx):
    values = ctx.get("post_ms")
    return statistics.fmean(values) if values else None
