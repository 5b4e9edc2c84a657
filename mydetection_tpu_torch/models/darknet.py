"""Darknet-53 backbone, standard path (NCHW).

A port of `mydetection_tpu/models/darknet.py` (`apply` with
`s2d_stem=False, scan_blocks=False`): a stem conv, then five stages of
a stride-2 downsample conv plus N residual blocks (N = 1/2/8/8/4), each
block a 1x1 (c→c/2) and a 3x3 (c/2→c) conv with an additive skip.
Returns C3/C4/C5 at strides 8/16/32. The JAX package's space-to-depth
stem and block scan are TPU layout devices with the same math, so they
are not ported. Module names follow the JAX tree (`stem`,
`stage2.res0.conv1`, ...) so `convert.from_jax_params` maps it 1:1.
"""

from __future__ import annotations

import torch
from torch import nn

from mydetection_tpu_torch.models.layers import ConvBNLeaky

STAGE_BLOCKS = (1, 2, 8, 8, 4)
STAGE_CHANNELS = (64, 128, 256, 512, 1024)


class ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvBNLeaky(c, c // 2, 1)
        self.conv2 = ConvBNLeaky(c // 2, c, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x), residual=x)


class Stage(nn.Module):
    def __init__(self, c_in: int, c_out: int, nblocks: int):
        super().__init__()
        self.down = ConvBNLeaky(c_in, c_out, 3, stride=2)
        self.nblocks = nblocks
        for bi in range(nblocks):
            self.add_module(f"res{bi}", ResBlock(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x)
        for bi in range(self.nblocks):
            x = getattr(self, f"res{bi}")(x)
        return x


class Darknet53(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = ConvBNLeaky(3, 32, 3)
        c_in = 32
        for si, (nblocks, c_out) in enumerate(zip(STAGE_BLOCKS,
                                                  STAGE_CHANNELS)):
            self.add_module(f"stage{si}", Stage(c_in, c_out, nblocks))
            c_in = c_out

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """x: NCHW float batch → (C3, C4, C5)."""
        y = self.stem(x)
        feats = []
        for si in range(len(STAGE_BLOCKS)):
            y = getattr(self, f"stage{si}")(y)
            if si >= 2:  # stages 2/3/4 emit C3/C4/C5 (strides 8/16/32)
                feats.append(y)
        return tuple(feats)
