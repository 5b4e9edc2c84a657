"""Fused bias + GroupNorm + ReLU: CUDA kernel wrapper and plain version.

`bias_gn_relu` replaces the TPU kernel `mydetection_tpu/ops/pallas/
gn_kernel.py::bias_gn_relu_pallas_impl` (`_gn_kernel`). On a CUDA tensor
it launches `csrc/gn.cu` once, or raises; only a CPU tensor takes the
plain version, `bias_gn_relu_plain`, which repeats the kernel's
arithmetic: a float32 bias add, float32 sums per (image, group), the
variance as E[x²] − E[x]² floored at 0, and the output in x's dtype.
The two differ only in the order of the sums.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mydetection_tpu_torch.kernels import build

GN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bias_gn_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor, *,
                       groups: int = 32) -> torch.Tensor:
    """relu(GN(x + bias)·scale + shift) for NCHW x of any layout, with
    float32 per-channel bias, scale and shift; returns x's dtype."""
    b, c, h, w = x.shape
    xf = x.float() + bias.float()[:, None, None]
    g = xf.reshape(b, groups, c // groups * h * w)
    n = torch.tensor(np.float32(g.shape[-1]), device=x.device)
    mean = g.sum(dim=-1, keepdim=True) / n
    var = torch.clamp((g * g).sum(dim=-1, keepdim=True) / n - mean * mean,
                      min=0.0)
    inv = 1.0 / torch.sqrt(var + np.float32(GN_EPS))
    y = ((g - mean) * inv).reshape(b, c, h, w)
    y = y * scale.float()[:, None, None] + shift.float()[:, None, None]
    return torch.relu(y).to(x.dtype)


def bias_gn_relu(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, *, groups: int = 32) -> torch.Tensor:
    """y = relu(GN(x + bias)·scale + shift), x NCHW (B, C, H, W), eps 1e-5.

    CPU tensors run `bias_gn_relu_plain`. CUDA tensors launch the kernel
    (one block per image and group) and count the launch: x float32 or
    bfloat16 in channels_last memory (NHWC, as the convs emit it on the
    card), bias/scale/shift float32 (C,). The output has x's dtype and
    layout.
    """
    if x.device.type == "cpu":
        return bias_gn_relu_plain(x, bias, scale, shift, groups=groups)
    if x.device.type != "cuda":
        raise ValueError(f"bias_gn_relu runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"x must be a 4-D float32 or bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, c, h, w = x.shape
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"bias_gn_relu reads channels_last (NHWC) memory; "
                         f"got strides {x.stride()} for shape "
                         f"{tuple(x.shape)}")
    for name, v in (("bias", bias), ("scale", scale), ("shift", shift)):
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    vec = 16 // x.element_size()
    vectorized = ((c // groups) % vec == 0 and c % vec == 0
                  and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_gn_relu_launch(
            x.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, h * w, c, groups, GN_EPS,
            _DTYPES[x.dtype], int(vectorized), stream)
    if err:
        raise RuntimeError(f"bias_gn_relu launch failed: "
                           f"{lib.gn_error_string(err).decode()}")
    bias_gn_relu.launches += 1
    return out


bias_gn_relu.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("gn")
    p = ctypes.c_void_p
    lib.bias_gn_relu_launch.argtypes = [
        p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
    lib.bias_gn_relu_launch.restype = ctypes.c_int
    lib.gn_error_string.argtypes = [ctypes.c_int]
    lib.gn_error_string.restype = ctypes.c_char_p
    return lib
