"""Batched greedy NMS keep-mask: CUDA kernel wrapper and plain version.

`nms_keep` replaces the TPU kernel `mydetection_tpu/ops/pallas/
nms_kernel.py::nms_pallas_impl` (+ `ops/pallas/common.py::
greedy_fixpoint_keep`). On a CUDA tensor it launches `csrc/nms.cu` once
for the whole batch, or raises; only a CPU tensor takes the plain
version, `nms_keep_plain`, a port of the JAX oracle
`mydetection_tpu/ops/nms.py::_blocked_greedy_keep` batched over images.
Greedy keep-sets are unique, so the two agree bit for bit whenever each
IoU rounds alike, which `csrc/nms.cu` guarantees.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.ops.boxes import pairwise_iou

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use


def greedy_keep_from_iou(iou: torch.Tensor, valid: torch.Tensor,
                         iou_thres: float, *, block: int) -> torch.Tensor:
    """Greedy keep-mask (B, K) from a precomputed IoU matrix (B, K, K)
    of score-sorted rows and `valid` (B, K): box j is dropped when a
    kept box i < j has iou[i, j] > iou_thres (read row i, column j: the
    matrix need not be symmetric). Within each block of `block` rows a
    sequential resolve, then the block's kept rows suppress every later
    box in one vectorized pass — the JAX package's blocked oracle,
    batched over images. The one plain definition behind both NMS
    kernels' plain versions."""
    b, k, _ = iou.shape
    block = min(block, k)
    thr = torch.tensor(np.float32(iou_thres), device=iou.device)
    keep = valid.bool().clone()
    idx = torch.arange(k, device=iou.device)
    for start in range(0, k, block):
        stop = min(start + block, k)
        rows = iou[:, start:stop]                             # (B, T, K)
        intra = rows[:, :, start:stop] > thr                  # (B, T, T)
        ar = idx[:stop - start]
        bk = keep[:, start:stop].clone()
        for i in range(stop - start):
            bk &= ~(intra[:, i] & (ar > i) & bk[:, i:i + 1])
        sup_any = ((rows > thr) & bk[:, :, None]).any(dim=1)  # (B, K)
        keep &= ~(sup_any & (idx >= stop))
        keep[:, start:stop] = bk
    return keep & valid.bool()


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_thres: float, *, block: int = 128) -> torch.Tensor:
    """Keep-mask (B, K) for score-sorted xyxy `boxes` (B, K, 4) float32
    and `valid` (B, K): `greedy_keep_from_iou` over their IoU matrix."""
    return greedy_keep_from_iou(pairwise_iou(boxes, boxes), valid, iou_thres,
                                block=block)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor,
             iou_thres: float) -> torch.Tensor:
    """Greedy NMS keep-mask over B images at once.

    boxes (B, K, 4) float32 xyxy, each row sorted by descending score
    and already class-offset; valid (B, K) bool or uint8. Returns bool
    (B, K). CPU tensors run `nms_keep_plain`; CUDA tensors launch the
    kernel (one block per image) and count the launch.
    """
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep runs on CPU or CUDA tensors, got "
                         f"{boxes.device}")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4) float32, got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    b, k, _ = boxes.shape
    if valid.shape != (b, k) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be ({b}, {k}) bool or uint8, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError(f"valid is on {valid.device}, boxes on "
                         f"{boxes.device}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep needs contiguous boxes and valid")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = _library()
    if lib.nms_keep_smem_bytes(k) > _SMEM_LIMIT:
        raise ValueError(f"K={k} boxes do not fit one block's shared memory")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_keep_launch(boxes.data_ptr(), valid.data_ptr(),
                                  keep.data_ptr(), b, k,
                                  float(np.float32(iou_thres)), stream)
    if err:
        raise RuntimeError(f"nms_keep launch failed: "
                           f"{lib.nms_error_string(err).decode()}")
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("nms")
    lib.nms_keep_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.nms_keep_launch.restype = ctypes.c_int
    lib.nms_keep_smem_bytes.argtypes = [ctypes.c_int]
    lib.nms_keep_smem_bytes.restype = ctypes.c_size_t
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib
