"""Conv / batch-norm / activation building blocks (NCHW modules).

A port of `mydetection_tpu/models/layers.py` that keeps its arithmetic:

  * convs pad symmetrically by (k-1)//2 at every stride — never
    `padding="same"`, which pads a stride-2 conv on an even input
    asymmetrically and shifts every downsampled map by one pixel;
  * BatchNorm is the fold `scale·rsqrt(var+1e-5)`, `bias-mean·scale`,
    then `x*scale + shift` in the activation dtype: from the running
    statistics in eval mode, from the batch's (float32 mean and biased
    variance, gradients through both) in train mode, which also moves
    the running statistics by momentum 0.9 toward the batch mean and
    the unbiased (n/(n-1)) variance; in a data-parallel step the batch
    is the global one, its sums taken across the replicas;
  * LeakyReLU is `where(x >= 0, x, 0.1x)`;
  * max pooling pads symmetrically with -inf (torch's MaxPool2d);
  * the ResNet input is `x/255`, then `(x - mean) / std` with ImageNet's
    mean and std, both in the compute dtype;
  * params are stored float32 and cast to the compute dtype at the conv.

Activations are NCHW here (the JAX package is NHWC); the model's input
and its raw head outputs keep JAX's NHWC layout (`models/yolov3.py`).

On the card in eval mode with no gradient needed, `ConvBN` and
`ConvBNLeaky` run everything after the conv (BN, the activation and a
residual) as one `kernels.epilogue.conv_epilogue` launch
(`epilogue_kernel`), bit-equal to the eager ops they keep everywhere
else.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mydetection_tpu_torch.parallel.mesh import replica_group

LEAKY_SLOPE = 0.1
# the activations `kernels.epilogue.conv_epilogue` applies after BN
ACT_NONE, ACT_RELU, ACT_LEAKY = 0, 1, 2
BN_EPS = 1e-5
BN_MOMENTUM = 0.9
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """NCHW x OIHW conv with symmetric (k-1)//2 padding per side; the
    weight is cast to the activation dtype."""
    ph, pw = (w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2
    return F.conv2d(x, _as_dtype(w, x.dtype), stride=stride,
                    padding=(ph, pw))


def _as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t.to(dtype)`, leaving out the call where it is a no-op: an
    exported program records every `.to` as a node (and a metadata
    check), a quarter of a float32 detect program's nodes."""
    return t if t.dtype == dtype else t.to(dtype)


def bn_fold(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as one float32 (scale, shift) pair per channel."""
    s = scale * torch.rsqrt(var + BN_EPS)
    return s, bias - mean * s


def batch_norm(x: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor) -> torch.Tensor:
    """x*scale + shift over the channel axis 1, in x's dtype."""
    return (x * _as_dtype(scale, x.dtype).view(-1, 1, 1)
            + _as_dtype(shift, x.dtype).view(-1, 1, 1))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def normalize_input(images_u8: torch.Tensor,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """uint8 → [0, 1] by a division by 255 in the compute dtype."""
    return images_u8.to(compute_dtype) / torch.tensor(
        255.0, dtype=compute_dtype, device=images_u8.device)


def standardize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (NCHW) → ImageNet-standardized, in x01's dtype."""
    kw = dict(dtype=x01.dtype, device=x01.device)
    mean = torch.tensor(IMAGENET_MEAN, **kw)[:, None, None]
    std = torch.tensor(IMAGENET_STD, **kw)[:, None, None]
    return (x01 - mean) / std


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max pool with a symmetric (window-1)//2 pad of -inf per side."""
    return F.max_pool2d(x, window, stride, padding=(window - 1) // 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW map (an exact copy)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class BatchNorm(nn.Module):
    """BatchNorm keyed like the JAX tree: `scale`, `bias` (learnable)
    and the running `mean`, `var` (buffers). Train mode is `layers.py::
    batch_norm(train=True)` written out in tensor ops, not
    `F.batch_norm`, whose arithmetic and dtypes differ."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return batch_norm(x, *bn_fold(self.scale, self.bias, self.mean,
                                          self.var))
        xf = x.float()
        dims = (0, 2, 3)
        n = x.numel() // x.shape[1]
        # jnp.mean and jnp.var: sums divided by n, the variance two-pass;
        # in a data-parallel step both sums and n span every replica
        group = replica_group()
        total = xf.sum(dim=dims)
        if group is not None:
            total, n = group[0].all_sum(group[1], [total, n])
        mean = total / n
        sq = ((xf - mean[:, None, None]) ** 2).sum(dim=dims)
        if group is not None:
            [sq] = group[0].all_sum(group[1], [sq])
        var = sq / n
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * unbiased)
        return batch_norm(x, *bn_fold(self.scale, self.bias, mean, var))


def epilogue_kernel(module: nn.Module, x: torch.Tensor):
    """`kernels.epilogue.conv_epilogue` where `module`'s forward on x
    takes it (`kernels.route.takes_kernel`: x on the card, eval mode, no
    gradient needed, the kernels not routed plain), else None. Imported
    at the call: the kernels import this module for their plain
    versions, so this module does not import them."""
    from mydetection_tpu_torch.kernels import epilogue, route
    return epilogue.conv_epilogue if route.takes_kernel(module, x) else None


class ConvBN(nn.Module):
    """Conv → BN, plus `residual` when one is given, then ReLU when
    `relu` (the ResNet building block; a bottleneck's conv3 takes the
    shortcut as its residual, so the block's ReLU follows the add)."""

    def __init__(self, c_in: int, c_out: int, ksize: int, stride: int = 1,
                 *, relu: bool = True):
        super().__init__()
        self.stride = stride
        self.relu = relu
        self.conv = nn.Conv2d(c_in, c_out, ksize, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        y = conv2d(x, self.conv.weight, stride=self.stride)
        kernel = epilogue_kernel(self, x)
        if kernel is not None:
            bn = self.bn
            return kernel(y, bn.scale, bn.bias, bn.mean, bn.var, residual,
                          ACT_RELU if self.relu else ACT_NONE, False)
        y = self.bn(y)
        if residual is not None:
            y = y + residual
        return torch.relu(y) if self.relu else y


class ConvBNLeaky(nn.Module):
    """Conv → BN → LeakyReLU(0.1), the Darknet building block, plus
    `residual` after the activation when one is given (a Darknet
    residual block's second conv)."""

    def __init__(self, c_in: int, c_out: int, ksize: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(c_in, c_out, ksize, bias=False)
        self.bn = BatchNorm(c_out)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        y = conv2d(x, self.conv.weight, stride=self.stride)
        kernel = epilogue_kernel(self, x)
        if kernel is not None:
            bn = self.bn
            return kernel(y, bn.scale, bn.bias, bn.mean, bn.var, residual,
                          ACT_LEAKY, True)
        y = leaky_relu(self.bn(y))
        return y if residual is None else residual + y


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """The JAX package's init distributions, drawn from a numpy
    RandomState in module order: conv weights He-normal (std
    sqrt(2/fan_in)) unless the conv carries an `init_std` (a fixed
    gaussian std, as detection heads use); conv biases zero unless it
    carries an `init_bias`. BatchNorms, GroupNorms and other parameters
    keep the values their modules were built with. The bits differ from
    the JAX init of the same seed: parity runs load JAX weights."""
    rng = np.random.RandomState(seed)
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            std = getattr(m, "init_std", None)
            if std is None:
                std = np.sqrt(2.0 / m.weight[0].numel())
            w = rng.standard_normal(m.weight.shape).astype(np.float32)
            m.weight.copy_(torch.from_numpy(w * np.float32(std)))
            if m.bias is not None:
                m.bias.fill_(getattr(m, "init_bias", 0.0))
