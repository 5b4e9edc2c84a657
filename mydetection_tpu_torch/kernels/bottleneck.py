"""Stride-1 ResNet bottleneck with eval BN folded into its weights: CUDA
kernel wrapper, plain version and the fold.

`fused_bottleneck` replaces the TPU kernel `benchmarks/
resnet_stage_experiments.py::fused_block` (its body `kernel`), the
ResNet stage-0 blocks and stage 1's stride-1 blocks in eval mode. On a
CUDA tensor it launches `csrc/bottleneck.cu` (the whole block in one
kernel, y1 and y2 kept in shared memory), or raises; only a CPU tensor
takes the plain version, `fused_bottleneck_plain`.

The arithmetic is the TPU kernel's. `fold_bottleneck` folds each
ConvBN in float32 as its `fold` does: s = scale·rsqrt(var + 1e-5),
W' = w·s cast to x's dtype, b' = bias − mean·s kept float32. Then

    y1  = round(relu(x·W1' + b1'))
    y2  = round(relu(conv3x3(y1, W2') + b2'))      y1 zero off the image
    out = round(relu(y2·W3' + b3' + x·Wd' + bd'))  with a projection
    out = round(relu(y2·W3' + b3' + float(x)))     without one

every sum in float32, each result rounded once to x's dtype. The port's
CPU `Bottleneck` keeps the JAX `_bottleneck(train=False)` order (the
conv rounded, then BN in the activation dtype), so in bf16 the two
differ by that rounding; in float32 only by the order of the sums.

Packed weights: w1 (c_in, c_mid), w2 (9·c_mid, c_mid) with row
t·c_mid + c_in of tap t = (dy+1)·3 + (dx+1), w3 (c_mid, c_out), wd
(c_in, c_out), all in x's dtype; biases float32.

The kernel has no backward, and neither has the TPU kernel: on a CUDA
tensor under autograd the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.models.layers import bn_fold

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
C_MIDS = (64, 128)   # the kernel's instantiations: ResNet stages 0 and 1


class Folded(NamedTuple):
    """A bottleneck's folded, packed weights and float32 biases, in
    `fused_bottleneck`'s argument order."""
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    wd: torch.Tensor | None = None
    bd: torch.Tensor | None = None


@torch.no_grad()
def fold_conv_bn(conv_bn, dtype: torch.dtype) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """A `ConvBN`'s eval BN folded in float32: (W' = w·s packed as
    (kh·kw·c_in, c_out) in `dtype`, b' = bias − mean·s float32),
    constants outside autograd (the kernel has no backward)."""
    bn = conv_bn.bn
    s, shift = bn_fold(bn.scale.float(), bn.bias.float(), bn.mean.float(),
                       bn.var.float())
    w = conv_bn.conv.weight.float() * s[:, None, None, None]
    c_out, c_in, kh, kw = w.shape
    packed = w.permute(2, 3, 1, 0).reshape(kh * kw * c_in, c_out)
    return packed.to(dtype).contiguous(), shift.contiguous()


def fold_bottleneck(block, dtype: torch.dtype) -> Folded:
    """A port `Bottleneck`'s ConvBN parameters → `Folded` in `dtype`."""
    parts = [fold_conv_bn(getattr(block, n), dtype)
             for n in ("conv1", "conv2", "conv3")]
    if block.down is not None:
        parts.append(fold_conv_bn(block.down, dtype))
    return Folded(*(t for part in parts for t in part))


def _conv(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor,
          k: int) -> torch.Tensor:
    """float32 conv of x with packed (k·k·c_in, c_out) weights, symmetric
    zero padding, then the float32 bias."""
    c_out = packed.shape[1]
    w = packed.reshape(k, k, -1, c_out).permute(3, 2, 0, 1)
    y = F.conv2d(x.float(), w.float(), padding=(k - 1) // 2)
    return y + bias.float()[:, None, None]


def fused_bottleneck_plain(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                           wd=None, bd=None) -> torch.Tensor:
    """The kernel's function in torch: each conv in float32 on x's values
    and the packed weights' (bf16 products are exact in float32), the
    float32 bias, the ReLU, one rounding to x's dtype per conv. x NCHW of
    any layout."""
    dt = x.dtype
    y = torch.relu(_conv(x, w1, b1, 1)).to(dt)
    y = torch.relu(_conv(y, w2, b2, 3)).to(dt)
    z = _conv(y, w3, b3, 1)
    z = z + (_conv(x, wd, bd, 1) if wd is not None else x.float())
    return torch.relu(z).to(dt)


def check_cuda(x: torch.Tensor, f: Folded, *, layout: bool = True) -> None:
    """What the kernel takes, in checks a fake tensor can answer too: x
    a 4-D float32 or bfloat16 tensor on the card in channels_last
    memory; c_in and c_out multiples of 16, c_mid in C_MIDS, c_in ==
    c_out without a projection; the packed weights contiguous in x's
    dtype and the biases contiguous float32, all on x's device, wd and
    bd both or neither. The launch also wants x 16-byte aligned.
    `layout` False skips x's memory layout: a traced call's fake strides
    may disagree with the ones the card produces (the launch checks the
    real ones)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_bottleneck: x must be a 4-D float32 or "
                         f"bfloat16 tensor, got {tuple(x.shape)} {x.dtype}")
    if layout and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"fused_bottleneck reads channels_last (NHWC) "
                         f"memory; got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    c_in = x.shape[1]
    c_mid = f.w1.shape[-1] if f.w1.dim() == 2 else -1
    c_out = f.w3.shape[-1] if f.w3.dim() == 2 else -1
    if c_in % 16 or c_out % 16 or c_mid not in C_MIDS:
        raise ValueError(f"fused_bottleneck: c_in {c_in} and c_out {c_out} "
                         f"must be multiples of 16 and c_mid {c_mid} one of "
                         f"{C_MIDS} (the kernel is built for ResNet stages "
                         f"0 and 1)")
    if (f.wd is None) != (f.bd is None):
        raise ValueError("fused_bottleneck: pass both wd and bd, or neither")
    if f.wd is None and c_in != c_out:
        raise ValueError(f"fused_bottleneck: without a projection c_in "
                         f"({c_in}) must equal c_out ({c_out})")
    weights = {"w1": (c_in, c_mid), "w2": (9 * c_mid, c_mid),
               "w3": (c_mid, c_out), "wd": (c_in, c_out)}
    biases = {"b1": c_mid, "b2": c_mid, "b3": c_out, "bd": c_out}
    for name, t in f._asdict().items():
        if t is None:
            continue
        shape, dtype = ((weights[name], x.dtype) if name in weights
                        else ((biases[name],), torch.float32))
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_bottleneck: {name} must be a contiguous "
                             f"{shape} {dtype} tensor on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def fused_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3, wd=None,
                     bd=None) -> torch.Tensor:
    """One stride-1 bottleneck on NCHW x (B, c_in, H, W) with folded
    weights (`fold_bottleneck`).

    CPU tensors run `fused_bottleneck_plain`. CUDA tensors call the
    custom op `mydet::fused_bottleneck` (`kernels.ops`), whose CUDA
    implementation `fused_bottleneck_launch` launches the kernel and
    counts the launch: x float32 or bfloat16 in channels_last memory,
    the weights in x's dtype, the biases float32. The output (B, c_out,
    H, W) has x's dtype and layout.
    """
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    f = Folded(w1, b1, w2, b2, w3, b3, wd, bd)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, *f)):
        raise NotImplementedError(
            "fused_bottleneck has no backward (nor has the TPU kernel it "
            "replaces); a block that needs gradients runs unfused")
    return torch.ops.mydet.fused_bottleneck(x, *f)


def _out_like(x: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    b, _, h, w = x.shape
    return torch.empty((b, w3.shape[-1], h, w), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)


def fused_bottleneck_launch(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                            wd=None, bd=None) -> torch.Tensor:
    """The CUDA implementation of `mydet::fused_bottleneck`: one launch
    of csrc/bottleneck.cu, counted on `fused_bottleneck.launches`."""
    check_cuda(x, Folded(w1, b1, w2, b2, w3, b3, wd, bd))
    if x.data_ptr() % 16:
        raise ValueError("fused_bottleneck needs a 16-byte aligned x")
    b, c_in, h, w = x.shape
    c_mid, c_out = w1.shape[1], w3.shape[1]
    out = _out_like(x, w3)
    if out.numel() == 0:
        return out
    lib = _library()
    null = ctypes.c_void_p(None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_bottleneck_launch(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
            wd.data_ptr() if wd is not None else null,
            bd.data_ptr() if bd is not None else null,
            out.data_ptr(), b, h, w, c_in, c_mid, c_out, _DTYPES[x.dtype],
            stream)
    if err:
        raise RuntimeError(f"fused_bottleneck launch failed: "
                           f"{lib.bottleneck_error_string(err).decode()}")
    fused_bottleneck.launches += 1
    return out


def fused_bottleneck_fake(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                          wd=None, bd=None) -> torch.Tensor:
    """`mydet::fused_bottleneck`'s output for a traced call."""
    check_cuda(x, Folded(w1, b1, w2, b2, w3, b3, wd, bd), layout=False)
    return _out_like(x, w3)


def fused_bottleneck_flops(x_shape, w1_shape, w2_shape, w3_shape,
                           wd_shape=None) -> int:
    """The multiply-adds of the convs the block fuses, two FLOPs each:
    2 · B·H·W · (c_in·c_mid + 9·c_mid·c_mid + c_mid·c_out [+ c_in·c_out
    with the projection]), what torch's FLOP counter reads from the
    unfused block's convs (the BN, bias, residual and ReLU are not
    counted beside a conv)."""
    b, _, h, w = x_shape
    macs = sum(rows * cols for rows, cols in (w1_shape, w2_shape, w3_shape))
    if wd_shape is not None:
        macs += wd_shape[0] * wd_shape[1]
    return 2 * b * h * w * macs


fused_bottleneck.launches = 0


def smem_bytes(c_mid: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory a block of the kernel takes (builds the
    library on first use)."""
    return _library().fused_bottleneck_smem_bytes(c_mid, _DTYPES[dtype])


def _library() -> ctypes.CDLL:
    lib = build.load("bottleneck")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck_launch.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.fused_bottleneck_launch.restype = ctypes.c_int
    lib.fused_bottleneck_smem_bytes.argtypes = [i, i]
    lib.fused_bottleneck_smem_bytes.restype = ctypes.c_int
    lib.bottleneck_error_string.argtypes = [ctypes.c_int]
    lib.bottleneck_error_string.restype = ctypes.c_char_p
    return lib
