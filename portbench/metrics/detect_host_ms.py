"""What a batch's wall time holds besides the two device spans: the
Detector's host path (api.py: launch, the copy back, strip_detections),
mean over the traced window's batches before
its profiled stretch."""
import statistics

NAME, UNIT, KIND, SOURCE = "detect_host_ms", "ms", "detect", "program_span"
LAYER, MOVES = "Detector host path (api.py)", "detect_img_s"


def read(ctx):
    if not ctx.get("forward_ms") or not ctx.get("post_ms"):
        return None
    return (statistics.fmean(ctx["batch_ms"]) - statistics.fmean(ctx["forward_ms"])
            - statistics.fmean(ctx["post_ms"]))
