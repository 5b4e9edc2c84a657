"""Device time of the dense forward (models/ through `Detector._forward_dense`),
by CUDA events around the call, mean over the traced window's batches before
its profiled stretch."""
import statistics

NAME, UNIT, KIND, SOURCE = "detect_forward_ms", "ms", "detect", "program_span"
LAYER, MOVES = "dense forward (models/)", "detect_img_s"


def read(ctx):
    values = ctx.get("forward_ms")
    return statistics.fmean(values) if values else None
