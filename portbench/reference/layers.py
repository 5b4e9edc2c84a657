"""Plain building blocks of the reference models (NCHW, float32).

A frozen copy of the detection port's plain layer arithmetic, kept here
so that the benchmark's yardstick does not move when the program does:

  * convs pad symmetrically by (k-1)//2 at every stride;
  * BatchNorm is `x*scale + shift` with scale = gamma·rsqrt(var+1e-5)
    and shift = beta − mean·scale, from the running statistics in eval
    mode and from the batch's (mean and biased variance) in train mode,
    which also moves the running statistics by momentum 0.9 toward the
    batch mean and the unbiased variance;
  * LeakyReLU(0.1); max pooling pads with -inf;
  * the ResNet input is x/255, then ImageNet's mean and std.

Every conv goes through `conv2d` and every BatchNorm through
`BatchNorm`, where the lower-precision control (`reference.precision`)
rounds what they store.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import precision

LEAKY_SLOPE = 0.1
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    ph, pw = (w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2
    x, w = precision.round_operands(x, w)
    return precision.stored(F.conv2d(x, w, stride=stride, padding=(ph, pw)))


def conv_bias(conv: nn.Conv2d, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    return conv2d(x, conv.weight, stride=stride) + conv.bias[:, None, None]


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def normalize_input(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.float() / 255.0


def standardize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, device=x01.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x01.device)[:, None, None]
    return (x01 - mean) / std


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, padding=(window - 1) // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.mean, self.var
        else:
            n = x.numel() // x.shape[1]
            mean = x.sum(dim=(0, 2, 3)) / n
            var = ((x - mean[:, None, None]) ** 2).sum(dim=(0, 2, 3)) / n
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1 - BN_MOMENTUM) * unbiased)
        s = self.scale * torch.rsqrt(var + BN_EPS)
        return precision.stored(x * s[:, None, None]
                                + (self.bias - mean * s)[:, None, None])


class ConvBN(nn.Module):
    """Conv → BN, then ReLU when `relu`."""

    def __init__(self, c_in: int, c_out: int, ksize: int, stride: int = 1,
                 *, relu: bool = True):
        super().__init__()
        self.stride = stride
        self.relu = relu
        self.conv = nn.Conv2d(c_in, c_out, ksize, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(conv2d(x, self.conv.weight, stride=self.stride))
        return torch.relu(y) if self.relu else y


class ConvBNLeaky(nn.Module):
    """Conv → BN → LeakyReLU(0.1)."""

    def __init__(self, c_in: int, c_out: int, ksize: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(c_in, c_out, ksize, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(self.bn(conv2d(x, self.conv.weight,
                                         stride=self.stride)))
