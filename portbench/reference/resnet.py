"""ResNet-50 (NCHW), torchvision's v1.5 bottleneck (stride on the 3x3):
a 7x7 stride-2 conv-BN-ReLU stem and a 3x3 stride-2 max pool, then four
stages of bottleneck blocks, block 0 of each stage with the projection
shortcut. Returns C3/C4/C5 (512/1024/2048 channels, strides 8/16/32).
Every block is the plain conv → BN → ReLU arithmetic."""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.layers import (
    ConvBN,
    max_pool,
    normalize_input,
    standardize_imagenet,
)

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
STAGE_CHANNELS = (256, 512, 1024, 2048)


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, downsample: bool):
        super().__init__()
        c_mid = c_out // 4
        self.conv1 = ConvBN(c_in, c_mid, 1)
        self.conv2 = ConvBN(c_mid, c_mid, 3, stride)
        self.conv3 = ConvBN(c_mid, c_out, 1, relu=False)
        self.down = (ConvBN(c_in, c_out, 1, stride, relu=False)
                     if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        return torch.relu(y + (x if self.down is None else self.down(x)))


class ResNet(nn.Module):
    def __init__(self, depth: int = 50):
        super().__init__()
        self.stem = ConvBN(3, 64, 7, 2)
        c_in = 64
        for si, nblocks in enumerate(STAGE_BLOCKS[depth]):
            c_out = STAGE_CHANNELS[si]
            stage = nn.Module()
            for bi in range(nblocks):
                stage.add_module(f"block{bi}", Bottleneck(
                    c_in if bi == 0 else c_out, c_out,
                    stride=2 if si > 0 and bi == 0 else 1,
                    downsample=bi == 0))
            self.add_module(f"stage{si}", stage)
            c_in = c_out

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        y = max_pool(self.stem(x), 3, 2)
        feats = []
        for si in range(len(STAGE_CHANNELS)):
            for block in getattr(self, f"stage{si}").children():
                y = block(y)
            if si >= 1:
                feats.append(y)
        return tuple(feats)


def prepare_input(images_nchw_u8: torch.Tensor) -> torch.Tensor:
    return standardize_imagenet(normalize_input(images_nchw_u8))
