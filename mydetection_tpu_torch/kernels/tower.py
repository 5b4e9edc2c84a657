"""Chain of L × [3x3 same conv + bias + ReLU]: CUDA kernel wrapper and
plain version.

`conv3x3_chain` replaces the TPU kernel `mydetection_tpu/ops/pallas/
tower_kernel.py::conv3x3_chain_pallas_impl` (`_chain_kernel`), the
RetinaNet head towers. On a CUDA tensor it launches `csrc/tower.cu`
(one implicit-GEMM kernel per layer, counted as one launch of the
chain; in bf16 a `wgmma` kernel fed from a ring of shared-memory
stages), or raises; only a CPU tensor takes the plain version,
`conv3x3_chain_plain`, the loop of `mydetection_tpu/models/
retinanet.py::_subnet`: the conv in x's dtype, then the bias cast to
that dtype, then the ReLU. The kernel keeps a float32 accumulator
through the bias and the ReLU and rounds once per layer, as the TPU
kernel does; in float32 the two differ only in the order of the sums,
in bf16 also by that rounding. `conv3x3_chain_reference` follows the
kernel's order of rounding instead: the check that holds the bf16
kernel to its arithmetic, pinned to the Pallas kernel on the CPU.

The weights are packed once per subnet and forward by `pack_weights`:
(L, 9·C, C) in the activation dtype, row (t·C + c_in) of layer l being
tap t = (dy+1)·3 + (dx+1)'s weights from input channel c_in — the TPU
kernel's `(L·9·C, C)` layout, split by layer.

The chain has no backward, and neither has the TPU kernel: on a CUDA
tensor under autograd the wrapper raises. RetinaNet's training step
runs its towers through `conv3x3_chain_plain` (cuDNN) instead, as the
JAX package trains them through `_subnet`'s XLA convs
(`models/retinanet.py::Subnet`).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.models.layers import conv2d

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pack_weights(weights: Sequence[torch.Tensor] | torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """L OIHW (C, C, 3, 3) conv weights → the chain's (L, 9·C, C)
    layout in `dtype`, contiguous."""
    w = torch.stack(list(weights)) if not torch.is_tensor(weights) \
        else weights
    layers, c_out, c_in, kh, kw = w.shape
    if (kh, kw) != (3, 3) or c_in != c_out:
        raise ValueError(f"pack_weights takes L square 3x3 OIHW weights, "
                         f"got {tuple(w.shape)}")
    return (w.to(dtype).permute(0, 3, 4, 2, 1)
            .reshape(layers, 9 * c_in, c_out).contiguous())


def unpack_weights(packed: torch.Tensor) -> torch.Tensor:
    """(L, 9·C, C) → (L, C, C, 3, 3) OIHW, a view."""
    layers, _, c = packed.shape
    return packed.reshape(layers, 3, 3, c, c).permute(0, 4, 3, 1, 2)


def conv3x3_chain_plain(x: torch.Tensor, packed: torch.Tensor,
                        biases: torch.Tensor) -> torch.Tensor:
    """For each layer l: relu(conv3x3(x, W_l) + b_l), the conv
    symmetric-padded and in x's dtype, the bias cast to x's dtype
    before the add (XLA's bf16 conv rounds its output first). x NCHW
    of any layout, `packed` from `pack_weights`, biases (L, C)."""
    for w, b in zip(unpack_weights(packed), biases):
        x = conv2d(x, w)
        x = torch.relu(x + b.to(x.dtype)[:, None, None])
    return x


def conv3x3_chain_reference(x: torch.Tensor, packed: torch.Tensor,
                            biases: torch.Tensor) -> torch.Tensor:
    """The kernel's (and the TPU kernel's) arithmetic in the plain
    version's ops: for each layer a float32 conv of x's values (bf16
    values are exact in float32), the float32 bias added, the ReLU,
    then one rounding to x's dtype. Same arguments as
    `conv3x3_chain_plain`; on the card, run it with TF32 off."""
    dtype = x.dtype
    for w, b in zip(unpack_weights(packed), biases):
        y = conv2d(x.float(), w.float())
        x = torch.relu(y + b.float()[:, None, None]).to(dtype)
    return x


def _check_cuda(x: torch.Tensor, packed: torch.Tensor,
                biases: torch.Tensor) -> None:
    """What the kernel takes: x a 4-D float32 or bfloat16 tensor on the
    card in channels_last memory, 16-byte aligned, C a multiple of 16
    in float32 and of 64 in bfloat16 (the wgmma kernel's K chunk is 64
    channels of one tap); packed a contiguous, 16-byte aligned
    (L, 9·C, C) tensor of x's dtype, L ≥ 1, and biases a contiguous
    float32 (L, C) tensor, both on x's device."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"conv3x3_chain: x must be a 4-D float32 or "
                         f"bfloat16 tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    multiple = 64 if x.dtype == torch.bfloat16 else 16
    if c % multiple:
        raise ValueError(f"conv3x3_chain: {c} channels are not a multiple "
                         f"of {multiple} ({x.dtype})")
    if not x.is_contiguous(memory_format=torch.channels_last) \
            or x.data_ptr() % 16:
        raise ValueError(f"conv3x3_chain reads 16-byte aligned "
                         f"channels_last (NHWC) memory; got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    layers = packed.shape[0] if packed.dim() == 3 else 0
    if layers < 1 or packed.shape != (layers, 9 * c, c) \
            or packed.dtype != x.dtype \
            or packed.device != x.device or not packed.is_contiguous() \
            or packed.data_ptr() % 16:
        raise ValueError(f"conv3x3_chain: packed weights must be a "
                         f"contiguous, 16-byte aligned (L, {9 * c}, {c}) "
                         f"{x.dtype} tensor on {x.device}, got "
                         f"{tuple(packed.shape)} {packed.dtype} on "
                         f"{packed.device}")
    if biases.shape != (layers, c) or biases.dtype != torch.float32 \
            or biases.device != x.device or not biases.is_contiguous():
        raise ValueError(f"conv3x3_chain: biases must be a contiguous "
                         f"float32 ({layers}, {c}) tensor on {x.device}, "
                         f"got {tuple(biases.shape)} {biases.dtype} on "
                         f"{biases.device}")


def conv3x3_chain(x: torch.Tensor, packed: torch.Tensor,
                  biases: torch.Tensor) -> torch.Tensor:
    """L × [3x3 same conv + bias + ReLU] on NCHW x (B, C, H, W).

    CPU tensors run `conv3x3_chain_plain`. CUDA tensors launch the
    kernel (L launches of one implicit-GEMM kernel, counted once) and
    count the launch: x float32 or bfloat16 in channels_last memory,
    `packed` from `pack_weights` in x's dtype, biases float32 (L, C).
    The output has x's dtype and layout.
    """
    if x.device.type == "cpu":
        return conv3x3_chain_plain(x, packed, biases)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_chain runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, packed, biases)):
        raise NotImplementedError(
            "conv3x3_chain has no backward (nor has the TPU kernel it "
            "replaces); under autograd run conv3x3_chain_plain, as the "
            "RetinaNet subnets do when they train")
    _check_cuda(x, packed, biases)
    b, c, h, w = x.shape
    layers = packed.shape[0]
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    scratch = torch.empty_like(out) if layers > 1 else out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_chain_launch(
            x.data_ptr(), packed.data_ptr(), biases.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), layers, b, h, w, c,
            _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"conv3x3_chain launch failed: "
                           f"{lib.tower_error_string(err).decode()}")
    conv3x3_chain.launches += 1
    return out


conv3x3_chain.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("tower")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_chain_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.conv3x3_chain_launch.restype = ctypes.c_int
    lib.tower_error_string.argtypes = [ctypes.c_int]
    lib.tower_error_string.restype = ctypes.c_char_p
    return lib
