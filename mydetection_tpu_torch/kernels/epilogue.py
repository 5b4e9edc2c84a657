"""A conv's eval epilogue in one pass: CUDA kernel wrapper and plain
version.

`conv_epilogue` replaces no TPU kernel (the JAX package leaves a conv's
epilogue to XLA, which fuses it into the conv); on the card the eager
epilogue after each cuDNN conv was a dozen launches: the BN fold in
float32, two casts, `x*s`, `+t`, the activation's three ops and the
residual add. On a CUDA tensor it launches `csrc/epilogue.cu` once, or
raises; only a CPU tensor takes the plain version,
`conv_epilogue_plain`, which is that eager arithmetic.

One call takes a conv's output x (B, C, H, W) and, per channel, either
eval BN's float32 (scale, bias, mean, var) or a conv bias alone
(`scale`, `mean`, `var` None), an activation (`ACT_NONE`, `ACT_RELU` or
`ACT_LEAKY`) and an optional residual of x's shape, added after the
activation (Darknet's `x + leaky(bn(conv))`) or before it (the ResNet
bottleneck's `relu(bn(conv) + shortcut)`). The kernel rounds where the
eager ops round, so the two agree bit for bit.

The models (`layers.ConvBN`, `layers.ConvBNLeaky`, `yolov3.Branch`)
call it where `kernels.route.takes_kernel` holds: an eval call on the
card with no gradient needed, outside `plain_versions()`; everywhere
else they keep the eager ops.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.models.layers import (
    ACT_LEAKY,
    ACT_NONE,
    ACT_RELU,
    batch_norm,
    bn_fold,
    leaky_relu,
)

_ACTS = {ACT_NONE: lambda y: y, ACT_RELU: torch.relu, ACT_LEAKY: leaky_relu}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS = 6144   # two float32 values a channel in 48 KB of shared memory


def conv_epilogue_plain(x: torch.Tensor, scale, bias: torch.Tensor, mean,
                        var, residual=None, act: int = ACT_NONE,
                        residual_after: bool = True) -> torch.Tensor:
    """The eager epilogue: `batch_norm` of `bn_fold`'s pair
    (or x plus the bias in x's dtype), the residual added before or after
    the activation."""
    if scale is None:
        y = x + bias.to(x.dtype)[:, None, None]
    else:
        y = batch_norm(x, *bn_fold(scale, bias, mean, var))
    if residual is not None and not residual_after:
        y = y + residual
    y = _ACTS[act](y)
    if residual is not None and residual_after:
        y = residual + y
    return y


def conv_epilogue(x: torch.Tensor, scale, bias: torch.Tensor, mean=None,
                  var=None, residual=None, act: int = ACT_NONE,
                  residual_after: bool = True) -> torch.Tensor:
    """BN (or a bias), the activation and the residual on a conv's output
    x (B, C, H, W); the result has x's shape, dtype and layout.

    CPU tensors run `conv_epilogue_plain`. CUDA tensors call the custom
    op `mydet::conv_epilogue` (`kernels.ops`), whose CUDA implementation
    `conv_epilogue_launch` launches the kernel and counts the launch: x
    float32 or bfloat16 in channels_last memory, the residual likewise,
    the per-channel vectors float32. The kernel has no backward: on a
    CUDA tensor under autograd the wrapper raises.
    """
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, scale, bias, mean, var, residual, act,
                                   residual_after)
    if x.device.type != "cuda":
        raise ValueError(f"conv_epilogue runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, bias, mean, var, residual)):
        raise NotImplementedError(
            "conv_epilogue has no backward; a module that needs gradients "
            "runs the eager epilogue")
    return torch.ops.mydet.conv_epilogue(x, scale, bias, mean, var, residual,
                                         act, residual_after)


def check_cuda(x: torch.Tensor, scale, bias, mean, var, residual, act: int,
               *, layout: bool = True) -> None:
    """What the kernel takes, in checks a fake tensor can answer too: x a
    4-D float32 or bfloat16 tensor in channels_last memory with at most
    MAX_CHANNELS channels; scale, mean and var all given or all None;
    each given vector a contiguous (C,) float32 tensor on x's device; the
    residual like x. `layout` False skips the memory layouts: a traced
    call's fake strides may disagree with the ones the card produces (the
    launch checks the real ones)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"conv_epilogue: x must be a 4-D float32 or "
                         f"bfloat16 tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if c > MAX_CHANNELS:
        raise ValueError(f"conv_epilogue takes at most {MAX_CHANNELS} "
                         f"channels, got {c}")
    if layout and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv_epilogue reads channels_last (NHWC) memory; "
                         f"got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    if act not in _ACTS:
        raise ValueError(f"conv_epilogue: act must be one of {sorted(_ACTS)}, "
                         f"got {act}")
    bn = (scale, mean, var)
    if any(t is None for t in bn) and any(t is not None for t in bn):
        raise ValueError("conv_epilogue: pass scale, mean and var together "
                         "(BN), or none of them (a bias)")
    index = x.get_device()
    for name, t in (("scale", scale), ("bias", bias), ("mean", mean),
                    ("var", var)):
        if t is not None and (t.shape != (c,) or t.dtype != torch.float32
                              or t.get_device() != index
                              or not t.is_contiguous()):
            raise ValueError(f"conv_epilogue: {name} must be a contiguous "
                             f"({c},) float32 tensor on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.get_device() != index
            or (layout and not residual.is_contiguous(
                memory_format=torch.channels_last))):
        raise ValueError(f"conv_epilogue: the residual must be x's shape, "
                         f"dtype and layout, got {tuple(residual.shape)} "
                         f"{residual.dtype} strides {residual.stride()}")


def conv_epilogue_launch(x: torch.Tensor, scale, bias: torch.Tensor, mean,
                         var, residual, act: int,
                         residual_after: bool) -> torch.Tensor:
    """The CUDA implementation of `mydet::conv_epilogue`: one launch of
    csrc/epilogue.cu, counted on `conv_epilogue.launches`."""
    check_cuda(x, scale, bias, mean, var, residual, act)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    res_mode = 0 if residual is None else (2 if residual_after else 1)
    lib = _library()
    # each forward launches this ~75 times from the host: the raw stream
    # handle, and a device switch only where x is not on the current one
    index = x.get_device()
    switch = (torch.cuda.device(index) if index != torch.cuda.current_device()
              else contextlib.nullcontext())
    with switch:
        err = lib.conv_epilogue_launch(
            x.data_ptr(), _ptr(residual), out.data_ptr(), _ptr(scale),
            bias.data_ptr(), _ptr(mean), _ptr(var), x.numel(), x.shape[1],
            act, res_mode, _DTYPES[x.dtype], build.sm_count(x.device),
            torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"conv_epilogue launch failed: "
                           f"{lib.epilogue_error_string(err).decode()}")
    conv_epilogue.launches += 1
    return out


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def conv_epilogue_fake(x: torch.Tensor, scale, bias: torch.Tensor, mean,
                       var, residual, act: int,
                       residual_after: bool) -> torch.Tensor:
    """`mydet::conv_epilogue`'s output for a traced call."""
    check_cuda(x, scale, bias, mean, var, residual, act, layout=False)
    return torch.empty_like(x, memory_format=torch.channels_last)


conv_epilogue.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("epilogue")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_epilogue_launch.argtypes = [p] * 7 + [ctypes.c_int64] + [i] * 5 \
        + [p]
    lib.conv_epilogue_launch.restype = ctypes.c_int
    lib.epilogue_error_string.argtypes = [ctypes.c_int]
    lib.epilogue_error_string.restype = ctypes.c_char_p
    return lib
