"""Feature Pyramid Network, P3–P7 (NCHW).

1x1 laterals on C3–C5, a
top-down nearest 2x upsample and add, 3x3 smoothing convs, then P6 as a
3x3 stride-2 conv of the smoothed P5 (torchvision's LastLevelP6P7) and
P7 as a 3x3 stride-2 conv of ReLU(P6). Every conv has a bias, added in
the compute dtype after the conv.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.layers import conv2d, upsample2x

FPN_CHANNELS = 256


def conv_bias(conv: nn.Conv2d, x: torch.Tensor, *, stride: int = 1
              ) -> torch.Tensor:
    """`conv`'s weight applied with symmetric padding, then its bias
    added in the activation dtype."""
    y = conv2d(x, conv.weight, stride=stride)
    return y + conv.bias.to(y.dtype)[:, None, None]


class FPN(nn.Module):
    def __init__(self, c3: int = 512, c4: int = 1024, c5: int = 2048,
                 channels: int = FPN_CHANNELS):
        super().__init__()
        for name, c_in, k in (("lateral3", c3, 1), ("lateral4", c4, 1),
                              ("lateral5", c5, 1), ("smooth3", channels, 3),
                              ("smooth4", channels, 3), ("smooth5", channels, 3),
                              ("p6", channels, 3), ("p7", channels, 3)):
            self.add_module(name, nn.Conv2d(c_in, channels, k, bias=True))

    def forward(self, feats) -> list[torch.Tensor]:
        """(C3, C4, C5) → [P3, P4, P5, P6, P7]."""
        c3, c4, c5 = feats
        l5 = conv_bias(self.lateral5, c5)
        l4 = conv_bias(self.lateral4, c4) + upsample2x(l5)
        l3 = conv_bias(self.lateral3, c3) + upsample2x(l4)
        p5 = conv_bias(self.smooth5, l5)
        p6 = conv_bias(self.p6, p5, stride=2)
        p7 = conv_bias(self.p7, torch.relu(p6), stride=2)
        return [conv_bias(self.smooth3, l3), conv_bias(self.smooth4, l4),
                p5, p6, p7]
