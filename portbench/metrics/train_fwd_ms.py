"""Device time of `TrainStep.forward` (the train-mode model, batch-statistics
BatchNorm, the loss), by CUDA events, mean over the traced window's steps before its
profiled stretch."""
import statistics

NAME, UNIT, KIND, SOURCE = "train_fwd_ms", "ms", "train", "program_span"
LAYER, MOVES = "train step (training.py)", "train_img_s"


def read(ctx):
    values = ctx.get("fwd_ms")
    return statistics.fmean(values) if values else None
