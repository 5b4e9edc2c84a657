"""Batched row gather: CUDA kernel wrapper and plain version.

`gather_rows` replaces the TPU kernel `benchmarks/gather_experiments.py
::gather_rows_sorted` (`_kernel`): the multi-label postprocess's gather
of the stage-1-selected boxes' class rows, (B, N, C) by (B, K) →
(B, K, C). On a CUDA tensor it launches `csrc/gather.cu` once, or
raises; only a CPU tensor takes the plain version, `gather_rows_plain`,
a `torch.gather` along the box axis (`ops/nms.py::_rows` on a 3-D
source). Both copy bits, so they agree exactly.

The TPU kernel needs sorted indices; this one takes any order,
duplicates included (the postprocess passes them in top-k order).
"""

from __future__ import annotations

import ctypes

import torch

from mydetection_tpu_torch.kernels import build

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
_INDEX_BYTES = {torch.int64: 8, torch.int32: 4}


def gather_rows_plain(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """src[b, sel[b, k]] for every image b: (B, N, C) by (B, K) →
    (B, K, C)."""
    idx = sel.long()[..., None].expand(-1, -1, src.shape[-1])
    return torch.gather(src, 1, idx)


def gather_rows(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows picked by (B, K) indices → (B, K, C) in src's
    dtype.

    CPU tensors run `gather_rows_plain`. CUDA tensors call the custom op
    `mydet::gather_rows` (`kernels.ops`), whose CUDA implementation
    `gather_rows_launch` launches the kernel (a warp per output row) and
    counts the launch: src contiguous float32, bfloat16 or float16; sel
    int64 or int32 on src's device with unit stride along K. Indices
    must lie in [0, N); the kernel does not check them.
    """
    if src.device.type == "cpu":
        return gather_rows_plain(src, sel)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CPU or CUDA tensors, got "
                         f"{src.device}")
    return torch.ops.mydet.gather_rows(src, sel)


def check_cuda(src: torch.Tensor, sel: torch.Tensor) -> None:
    """What the kernel takes, in checks a fake tensor can answer too."""
    if src.dim() != 3 or src.dtype not in _ELEM_BYTES \
            or not src.is_contiguous():
        raise ValueError(f"gather_rows: src must be a contiguous (B, N, C) "
                         f"float32, bfloat16 or float16 tensor, got "
                         f"{tuple(src.shape)} {src.dtype} strides "
                         f"{src.stride()}")
    b = src.shape[0]
    if sel.dim() != 2 or sel.shape[0] != b or sel.dtype not in _INDEX_BYTES \
            or sel.device != src.device \
            or (sel.shape[1] > 1 and sel.stride(1) != 1):
        raise ValueError(f"gather_rows: sel must be a ({b}, K) int64 or "
                         f"int32 tensor on {src.device} with unit stride "
                         f"along K, got {tuple(sel.shape)} {sel.dtype} on "
                         f"{sel.device} strides {sel.stride()}")


def gather_rows_launch(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """The CUDA implementation of `mydet::gather_rows`: one launch of
    csrc/gather.cu, counted on `gather_rows.launches`."""
    check_cuda(src, sel)
    b, n, c = src.shape
    k = sel.shape[1]
    out = torch.empty((b, k, c), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    elem = _ELEM_BYTES[src.dtype]
    vectorized = ((c * elem) % 16 == 0 and src.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.gather_rows_launch(
            src.data_ptr(), sel.data_ptr(), out.data_ptr(), b, n, k, c,
            sel.stride(0), elem, _INDEX_BYTES[sel.dtype], int(vectorized),
            stream)
    if err:
        raise RuntimeError(f"gather_rows launch failed: "
                           f"{lib.gather_error_string(err).decode()}")
    gather_rows.launches += 1
    return out


def gather_rows_fake(src: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """`mydet::gather_rows`'s output for a traced call."""
    check_cuda(src, sel)
    return src.new_empty((src.shape[0], sel.shape[1], src.shape[2]))


gather_rows.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gather_rows_launch.argtypes = [p, p, p, i, i, i, i, ctypes.c_int64,
                                       i, i, i, p]
    lib.gather_rows_launch.restype = ctypes.c_int
    lib.gather_error_string.argtypes = [ctypes.c_int]
    lib.gather_error_string.restype = ctypes.c_char_p
    return lib
