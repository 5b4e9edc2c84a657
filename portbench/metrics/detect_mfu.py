"""The whole detect step's share of the card's bf16 peak: the reference
model's convolution FLOPs an image (FlopCounterMode) times the traced
window's images per second before its profiled stretch over 989.4
TFLOP/s, in %."""
from portbench import yardstick

NAME, UNIT, KIND, SOURCE = "detect_mfu", "%", "detect", "host_clock"
LAYER, MOVES = "whole step", "detect_img_s"


def read(ctx):
    if ctx["device"].type != "cuda":
        return None
    cfg = ctx["config"]
    flops = yardstick.flops_per_image(cfg["family"], cfg["num_classes"],
                                      cfg["input_size"], train=False)
    return 100.0 * flops * ctx["rate"] / yardstick.BF16_FLOPS
