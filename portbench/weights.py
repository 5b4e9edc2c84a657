"""Seeded weights, made by the benchmark and handed to both the program
and the reference.

Every conv weight comes from one draw on the device: He-normal (std
sqrt(2 / fan_in)), except FCOS's tower, box and centerness convs, which
keep their published N(0, 0.01); every conv bias is zero, GroupNorm and
FCOS's level scales one. The class logits' convs are He-normal with no
prior, so that scores spread over (0, 1) as a trained detector's do,
and FCOS's boxes stay near 2·stride a side instead of spanning the
image. A training run starts from the heads' published init
(`head_init`): the class prior too, which keeps the first losses
finite.

The BatchNorm that closes each residual branch (a Darknet block's
second conv, a bottleneck's third) scales by RESIDUAL_GAIN, as trained
residual networks' do and zero-init-residual training starts from: at
full strength the seeded ResNet-50 is chaotic, a rounding grows about
1.15x a block, and bf16 and float32 detect as two different networks
(FCOS's class logits 49% apart by relative L2; 6.7% at 0.2).
BatchNorm's running statistics are then set, layer by layer, to the
statistics of its input on a calibration batch drawn from the seed, as
a trained network's would be: without them the residual sums grow
through Darknet-53 and ResNet-50 and every score saturates at 1, so
that ties, not arithmetic, decide the detections.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench import seeds
from portbench.reference import models
from portbench.reference.darknet import ResBlock
from portbench.reference.layers import BatchNorm
from portbench.reference.resnet import Bottleneck

CALIB_IMAGES = 4
RESIDUAL_GAIN = 0.2


def reference_model(family: str, num_classes: int, seed: int, device,
                    calib_images: torch.Tensor, *,
                    head_init: bool = False) -> nn.Module:
    """The float32 reference on `device` with the seed's weights, BN
    calibrated on `calib_images` (uint8 NHWC), in eval mode. With
    `head_init` the class logits' conv takes its published init too
    (`init_std`, `init_bias`: N(0, 0.01) and the focal prior), as a
    training run starts."""
    with torch.device(device):
        model = models.build(family, num_classes)
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)]
    gen = seeds.torch_gen(seed, "weights", device)
    with torch.no_grad():
        flat = torch.randn(sum(m.weight.numel() for m in convs),
                           generator=gen, device=device)
        offset = 0
        for m in convs:
            n = m.weight.numel()
            std = math.sqrt(2.0 / m.weight[0].numel())
            if head_init or not hasattr(m, "init_bias"):
                std = getattr(m, "init_std", std)
            m.weight.copy_(flat[offset:offset + n].view_as(m.weight) * std)
            offset += n
            if m.bias is not None:
                m.bias.fill_(getattr(m, "init_bias", 0.0) if head_init
                             else 0.0)
        for m in model.modules():
            if isinstance(m, (ResBlock, Bottleneck)):
                closing = m.conv2 if isinstance(m, ResBlock) else m.conv3
                closing.bn.scale.fill_(RESIDUAL_GAIN)
    calibrate_bn(model, calib_images)
    return model.eval().requires_grad_(False)


@torch.no_grad()
def calibrate_bn(model: nn.Module, images_u8: torch.Tensor) -> None:
    """One eval forward in which each BatchNorm first takes its input's
    per-channel mean and biased variance as its running statistics."""
    def take_stats(bn, args):
        x = args[0]
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in model.modules() if isinstance(m, BatchNorm)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model.eval()(images_u8)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        for h in hooks:
            h.remove()
