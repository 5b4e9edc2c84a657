"""ResNet-50/101 backbone, standard path (NCHW).

A port of `mydetection_tpu/models/resnet.py` (`apply` with the plain
stem, no block scan, and `prepare_input`'s non-folded branch): a 7x7
stride-2 conv-BN-ReLU stem and a 3x3 stride-2 max pool, then four
stages of bottleneck blocks (1x1 → 3x3 → 1x1, torchvision's v1.5 with
the stride on the 3x3), block 0 of each stage carrying the projection
shortcut. Returns C3/C4/C5 (512/1024/2048 channels, strides 8/16/32).
The JAX package's stem folds (standardize, space-to-depth) and its
block scan are TPU layout devices with the same math, so they are not
ported. Module names follow the JAX tree (`stem.conv`,
`stage0.block0.down.bn`, ...) so `convert.from_jax_params` maps 1:1.

Six blocks — every block of stage 0 and stage 1's stride-1 blocks, the
shapes of the TPU kernel `benchmarks/resnet_stage_experiments.py::
fused_block` — run as one `kernels.bottleneck.fused_bottleneck` launch
each on the card in eval mode when no gradient is needed, their BN
folded into the weights once per call. Everywhere else (the CPU, train
mode, autograd, stride-2 blocks, stages 2 and 3) a block is the JAX
`_bottleneck(train=False)` arithmetic: conv, BN in the activation
dtype, ReLU; on the card in eval mode each of its `ConvBN`s runs BN,
ReLU and (conv3) the shortcut's add as one `conv_epilogue` launch after
its conv (`models/layers.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from mydetection_tpu_torch.kernels.bottleneck import (
    fold_bottleneck,
    fused_bottleneck,
)
from mydetection_tpu_torch.kernels.route import takes_kernel
from mydetection_tpu_torch.models.layers import (
    ConvBN,
    max_pool,
    normalize_input,
    standardize_imagenet,
)

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_CHANNELS = (256, 512, 1024, 2048)  # bottleneck output channels


def prepare_input(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """uint8 (or float) NCHW batch → ImageNet-standardized compute dtype:
    uint8 is divided by 255 first, a float batch is taken as [0, 1]."""
    if x.dtype == torch.uint8:
        return standardize_imagenet(normalize_input(x, compute_dtype))
    return standardize_imagenet(x.to(compute_dtype))


def fused_route(stage: int, block: int) -> bool:
    """Whether block `block` of stage `stage` is routed to the fused
    kernel: all of stage 0 and stage 1 from block 1 on, the TPU
    kernel's own stages (`resnet_stage_experiments.py`'s stage list)."""
    return stage == 0 or (stage == 1 and block >= 1)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, downsample: bool,
                 fused: bool = False):
        super().__init__()
        if fused and stride != 1:
            raise ValueError("the fused bottleneck kernel runs at stride 1")
        c_mid = c_out // 4
        self.fused = fused
        self.conv1 = ConvBN(c_in, c_mid, 1)
        self.conv2 = ConvBN(c_mid, c_mid, 3, stride)
        self.conv3 = ConvBN(c_mid, c_out, 1)   # ReLU after the shortcut
        self.down = (ConvBN(c_in, c_out, 1, stride, relu=False)
                     if downsample else None)

    def takes_kernel(self, x: torch.Tensor) -> bool:
        """Whether `forward(x)` launches the fused kernel: a routed block
        where `kernels.route.takes_kernel` holds (x on the card, eval
        mode, no gradient needed, the kernels not routed plain)."""
        return self.fused and takes_kernel(self, x)

    def unfused(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX `_bottleneck`: conv → BN → ReLU twice, the shortcut,
        then conv → BN, the residual add and the ReLU (on the card the
        add and the ReLU ride in conv3's epilogue)."""
        y = self.conv2(self.conv1(x))
        sc = x if self.down is None else self.down(x)
        return self.conv3(y, residual=sc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_kernel(x):
            return fused_bottleneck(x, *fold_bottleneck(self, x.dtype))
        return self.unfused(x)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"unsupported ResNet depth {depth}")
        self.stem = ConvBN(3, 64, 7, 2)
        c_in = 64
        for si, nblocks in enumerate(STAGE_BLOCKS[depth]):
            c_out = STAGE_CHANNELS[si]
            stage = nn.Module()
            for bi in range(nblocks):
                stage.add_module(f"block{bi}", Bottleneck(
                    c_in if bi == 0 else c_out, c_out,
                    stride=2 if si > 0 and bi == 0 else 1,
                    downsample=bi == 0, fused=fused_route(si, bi)))
            self.add_module(f"stage{si}", stage)
            c_in = c_out

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x: standardized NCHW float batch → (C3, C4, C5)."""
        y = max_pool(self.stem(x), 3, 2)
        feats = []
        for si in range(len(STAGE_CHANNELS)):
            for block in getattr(self, f"stage{si}").children():
                y = block(y)
            if si >= 1:  # stages 1/2/3 emit C3/C4/C5
                feats.append(y)
        return tuple(feats)
