"""Fused bias + GroupNorm + ReLU: CUDA kernel wrappers, plain versions,
and the autograd Function that pairs the forward with its backward.

Three wrappers, each over a kernel of `csrc/gn.cu`, each with its plain
version and its launch count:

* `bias_gn_relu` replaces `mydetection_tpu/ops/pallas/gn_kernel.py::
  bias_gn_relu_pallas_impl` (`_gn_kernel`): the inference forward;
* `bias_gn_relu_fwd_stats` replaces `_fwd_with_stats`
  (`_gn_fwd_stats_kernel`): the same forward, also returning the
  per-(image, group) mean and inverse standard deviation;
* `bias_gn_relu_bwd` replaces `_bwd_fused` (`_gn_bwd_kernel`): the
  fused backward from x, the saved y, dy and the saved statistics.

`BiasGNReLU` pairs the last two as `_make_trainable`'s `custom_vjp`
does. On a CUDA tensor each wrapper launches its kernel or raises; only
a CPU tensor takes the plain version, which repeats the kernel's
arithmetic (float32 bias add and sums, the variance as E[x²] − E[x]²
floored at 0, 1/sqrt); the two differ only in the order of the sums.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mydetection_tpu_torch.kernels import build

GN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_THREADS = 256  # csrc/gn.cu kThreads


def _params_c(v: torch.Tensor) -> torch.Tensor:
    """A (C,) parameter as a float32 (C, 1, 1) for NCHW broadcasting."""
    return v.float()[:, None, None]


def bias_gn_relu_fwd_stats_plain(x: torch.Tensor, bias: torch.Tensor,
                                 scale: torch.Tensor, shift: torch.Tensor, *,
                                 groups: int = 32
                                 ) -> tuple[torch.Tensor, ...]:
    """(relu(GN(x + bias)·scale + shift) in x's dtype, mean (B, G) f32,
    inv (B, G) f32) for NCHW x of any layout, with float32 per-channel
    bias, scale and shift."""
    b, c, h, w = x.shape
    xf = x.float() + _params_c(bias)
    g = xf.reshape(b, groups, c // groups * h * w)
    n = torch.tensor(np.float32(g.shape[-1]), device=x.device)
    mean = g.sum(dim=-1, keepdim=True) / n
    var = torch.clamp((g * g).sum(dim=-1, keepdim=True) / n - mean * mean,
                      min=0.0)
    inv = 1.0 / torch.sqrt(var + np.float32(GN_EPS))
    y = ((g - mean) * inv).reshape(b, c, h, w)
    y = y * _params_c(scale) + _params_c(shift)
    return torch.relu(y).to(x.dtype), mean[..., 0], inv[..., 0]


def bias_gn_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor, *,
                       groups: int = 32) -> torch.Tensor:
    """relu(GN(x + bias)·scale + shift) for NCHW x of any layout, with
    float32 per-channel bias, scale and shift; returns x's dtype."""
    return bias_gn_relu_fwd_stats_plain(x, bias, scale, shift,
                                        groups=groups)[0]


def bias_gn_relu_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                           dy: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, mean: torch.Tensor,
                           inv: torch.Tensor, *, groups: int = 32
                           ) -> tuple[torch.Tensor, ...]:
    """The fused backward of `gn_kernel.py::_gn_bwd_kernel`: (dx in x's
    dtype, dbias, dscale, dshift (C,) float32). The ReLU mask is the
    saved output's `y > 0`; the per-channel sums are taken per image and
    then added over the images in image order."""
    b, c, h, w = x.shape
    cpg = c // groups
    mean_c = mean.repeat_interleave(cpg, dim=1)[:, :, None, None]
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, :, None, None]
    xhat = ((x.float() + _params_c(bias)) - mean_c) * inv_c
    dpre = torch.where(y.float() > 0.0, dy.float(), 0.0)
    dxhat = dpre * _params_c(scale)
    n = torch.tensor(np.float32(cpg * h * w), device=x.device)
    m1 = dxhat.reshape(b, groups, -1).sum(dim=-1) / n
    m2 = (dxhat * xhat).reshape(b, groups, -1).sum(dim=-1) / n
    m1 = m1.repeat_interleave(cpg, dim=1)[:, :, None, None]
    m2 = m2.repeat_interleave(cpg, dim=1)[:, :, None, None]
    dxf = inv_c * ((dxhat - m1) - xhat * m2)
    sums = []
    for t in (dxf, dpre * xhat, dpre):
        per_image = t.sum(dim=(2, 3))
        acc = torch.zeros(c, device=x.device)
        for i in range(b):
            acc = acc + per_image[i]
        sums.append(acc)
    return (dxf.to(x.dtype), *sums)


def _check_cuda(name: str, x: torch.Tensor, groups: int,
                **params: torch.Tensor) -> None:
    """What the kernels take: x a 4-D float32 or bfloat16 tensor on the
    card in channels_last memory, C split into groups of at most
    `_BLOCK_THREADS` vectors, each parameter a contiguous float32 (C,)
    tensor on x's device."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be a 4-D float32 or bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if groups <= 0 or c % groups or c // groups > _BLOCK_THREADS:
        raise ValueError(f"{name}: {c} channels do not split into {groups} "
                         f"groups of at most {_BLOCK_THREADS} channels")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} reads channels_last (NHWC) memory; got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    for pname, v in params.items():
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name}: {pname} must be a contiguous float32 "
                             f"({c},) tensor on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _vectorized(x: torch.Tensor, groups: int, *tensors) -> bool:
    vec = 16 // x.element_size()
    c = x.shape[1]
    return ((c // groups) % vec == 0 and c % vec == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *tensors)))


def _device_of(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    return x.device.type


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gn_error_string(err).decode()}")


def bias_gn_relu(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, *, groups: int = 32) -> torch.Tensor:
    """y = relu(GN(x + bias)·scale + shift), x NCHW (B, C, H, W), eps 1e-5.

    CPU tensors run `bias_gn_relu_plain`. CUDA tensors launch the kernel
    (one block per image and group) and count the launch: x float32 or
    bfloat16 in channels_last memory (NHWC, as the convs emit it on the
    card), bias/scale/shift float32 (C,). The output has x's dtype and
    layout.
    """
    if _device_of("bias_gn_relu", x) == "cpu":
        return bias_gn_relu_plain(x, bias, scale, shift, groups=groups)
    _check_cuda("bias_gn_relu", x, groups, bias=bias, scale=scale,
                shift=shift)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_gn_relu_launch(
            x.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), b, h * w, c, groups, GN_EPS, _DTYPES[x.dtype],
            int(_vectorized(x, groups, out)), stream)
    _raise_on(err, "bias_gn_relu", lib)
    bias_gn_relu.launches += 1
    return out


bias_gn_relu.launches = 0


def bias_gn_relu_fwd_stats(x: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor, *,
                           groups: int = 32) -> tuple[torch.Tensor, ...]:
    """`bias_gn_relu` that also returns the statistics the backward
    needs: (y, mean (B, G) f32, inv (B, G) f32). CPU tensors run
    `bias_gn_relu_fwd_stats_plain`; CUDA tensors launch the forward
    kernel's statistics variant and count the launch."""
    if _device_of("bias_gn_relu_fwd_stats", x) == "cpu":
        return bias_gn_relu_fwd_stats_plain(x, bias, scale, shift,
                                            groups=groups)
    _check_cuda("bias_gn_relu_fwd_stats", x, groups, bias=bias, scale=scale,
                shift=shift)
    b, c, h, w = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(b, groups, device=x.device)
    inv = torch.empty(b, groups, device=x.device)
    if x.numel() == 0:
        return out, mean, inv
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_gn_relu_fwd_stats_launch(
            x.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), mean.data_ptr(), inv.data_ptr(), b, h * w, c,
            groups, GN_EPS, _DTYPES[x.dtype],
            int(_vectorized(x, groups, out)), stream)
    _raise_on(err, "bias_gn_relu_fwd_stats", lib)
    bias_gn_relu_fwd_stats.launches += 1
    return out, mean, inv


bias_gn_relu_fwd_stats.launches = 0


def bias_gn_relu_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                     bias: torch.Tensor, scale: torch.Tensor,
                     mean: torch.Tensor, inv: torch.Tensor, *,
                     groups: int = 32) -> tuple[torch.Tensor, ...]:
    """The fused backward: (dx in x's dtype and layout, dbias, dscale,
    dshift (C,) float32). CPU tensors run `bias_gn_relu_bwd_plain`; CUDA
    tensors launch the backward kernel (one block per image and group,
    then one small kernel that adds the per-image channel sums in image
    order) and count one launch. x, y and dy have one dtype and shape,
    x and y channels_last; mean and inv are (B, G) float32."""
    if _device_of("bias_gn_relu_bwd", x) == "cpu":
        return bias_gn_relu_bwd_plain(x, y, dy, bias, scale, mean, inv,
                                      groups=groups)
    _check_cuda("bias_gn_relu_bwd", x, groups, bias=bias, scale=scale)
    b, c, h, w = x.shape
    for name, t in (("y", y), ("dy", dy)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"bias_gn_relu_bwd: {name} must match x's "
                             f"shape {tuple(x.shape)} and dtype {x.dtype} "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bias_gn_relu_bwd reads channels_last (NHWC) "
                         f"memory; y has strides {y.stride()}")
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (b, groups) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bias_gn_relu_bwd: {name} must be a contiguous "
                             f"float32 ({b}, {groups}) tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    # autograd hands the gradient over in whatever layout the consumer's
    # backward produced; the kernel reads NHWC, so this is a layout
    # change (a copy when needed), not a fallback
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    part = torch.empty(3, b, c, device=x.device)
    sums = torch.empty(3, c, device=x.device)
    if x.numel() == 0:
        return dx, *torch.zeros(3, c, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_gn_relu_bwd_launch(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), mean.data_ptr(), inv.data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), b, h * w, c, groups,
            _DTYPES[x.dtype], int(_vectorized(x, groups, y, dy, dx)), stream)
    _raise_on(err, "bias_gn_relu_bwd", lib)
    bias_gn_relu_bwd.launches += 1
    return dx, sums[0], sums[1], sums[2]


bias_gn_relu_bwd.launches = 0


class BiasGNReLU(torch.autograd.Function):
    """Differentiable relu(GN(x + bias)·scale + shift): the port of
    `gn_kernel.py::_make_trainable`. The forward runs
    `bias_gn_relu_fwd_stats` and saves what the JAX residuals hold (x
    before the bias, y, bias, scale, mean, inv); the backward runs
    `bias_gn_relu_bwd`. Each is the CUDA kernel on the card and the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, x, bias, scale, shift, groups):
        y, mean, inv = bias_gn_relu_fwd_stats(x, bias, scale, shift,
                                              groups=groups)
        ctx.save_for_backward(x, y, bias, scale, mean, inv)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, bias, scale, mean, inv = ctx.saved_tensors
        dx, dbias, dscale, dshift = bias_gn_relu_bwd(
            x, y, dy, bias, scale, mean, inv, groups=ctx.groups)
        return dx, dbias, dscale, dshift, None


def _library() -> ctypes.CDLL:
    lib = build.load("gn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bias_gn_relu_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
    lib.bias_gn_relu_fwd_stats_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, f, i, i, p]
    lib.bias_gn_relu_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    for fn in (lib.bias_gn_relu_launch, lib.bias_gn_relu_fwd_stats_launch,
               lib.bias_gn_relu_bwd_launch):
        fn.restype = ctypes.c_int
    lib.gn_error_string.argtypes = [ctypes.c_int]
    lib.gn_error_string.restype = ctypes.c_char_p
    return lib
