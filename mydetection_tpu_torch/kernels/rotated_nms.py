"""Batched greedy keep-mask from a precomputed IoU matrix: CUDA kernel
wrapper and plain version (the rotated-NMS suppress).

`nms_from_iou_keep` replaces the TPU kernel `mydetection_tpu/ops/pallas/
rotated_nms_kernel.py::nms_from_iou_pallas_impl` (+ `ops/pallas/
common.py::greedy_fixpoint_keep`). On a CUDA tensor it launches
`csrc/rotated_nms.cu` once for the whole batch, or raises; only a CPU
tensor takes the plain version, `nms_from_iou_keep_plain`, a port of the
JAX lax-loop oracle `mydetection_tpu/ops/rotated.py::
rotated_nms_padded_impl(use_pallas=False)` batched over images. The
kernel's only arithmetic is the float32 `iou > thr` compare, so the two
agree bit for bit on any matrix.
"""

from __future__ import annotations

import ctypes

import torch

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.kernels.nms import (
    LAUNCH_ARGTYPES,
    greedy_keep_from_iou,
    launch,
    plan_for,
)


def nms_from_iou_keep_plain(iou: torch.Tensor, valid: torch.Tensor,
                            iou_thres: float, *, block: int = 64
                            ) -> torch.Tensor:
    """Keep-mask (B, K) from iou (B, K, K) of score-sorted boxes and
    valid (B, K): the blocked greedy oracle, row i suppressing column
    j > i."""
    return greedy_keep_from_iou(iou, valid, iou_thres, block=block)


def nms_from_iou_keep(iou: torch.Tensor, valid: torch.Tensor,
                      iou_thres: float, *, block: int = 64) -> torch.Tensor:
    """Greedy NMS keep-mask from an IoU matrix, over B images at once.

    iou (B, K, K) float32 contiguous, rows and columns sorted by
    descending score; valid (B, K) bool or uint8. Returns bool (B, K).
    CPU tensors run `nms_from_iou_keep_plain` (in blocks of `block`);
    CUDA tensors call the custom op `mydet::nms_from_iou_keep`
    (`kernels.ops`), whose CUDA implementation `nms_from_iou_keep_launch`
    launches the kernel (`plan_for(valid, box_floats=0)`: a cluster of
    blocks an image; the result does not depend on `block`) and counts
    the launch. Raises ValueError for a K whose ring does not fit a
    block's shared memory (above 27,680).
    """
    if iou.device.type == "cpu":
        return nms_from_iou_keep_plain(iou, valid, iou_thres, block=block)
    if iou.device.type != "cuda":
        raise ValueError(f"nms_from_iou_keep runs on CPU or CUDA tensors, "
                         f"got {iou.device}")
    return torch.ops.mydet.nms_from_iou_keep(iou, valid, float(iou_thres))


def check_cuda(iou: torch.Tensor, valid: torch.Tensor) -> None:
    """What the kernel takes, in checks a fake tensor can answer too."""
    if iou.dtype != torch.float32 or iou.dim() != 3 \
            or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"iou must be (B, K, K) float32, got "
                         f"{tuple(iou.shape)} {iou.dtype}")
    b, k, _ = iou.shape
    if valid.shape != (b, k) or valid.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"valid must be ({b}, {k}) bool or uint8, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != iou.device:
        raise ValueError(f"valid is on {valid.device}, iou on {iou.device}")
    if not (iou.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_from_iou_keep needs contiguous iou and valid")


def nms_from_iou_keep_launch(iou: torch.Tensor, valid: torch.Tensor,
                             iou_thres: float) -> torch.Tensor:
    """The CUDA implementation of `mydet::nms_from_iou_keep`: one launch
    of csrc/rotated_nms.cu for the batch, counted on
    `nms_from_iou_keep.launches`."""
    check_cuda(iou, valid)
    b, k, _ = iou.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=iou.device)
    if b == 0 or k == 0:
        return keep
    plan = plan_for(valid, box_floats=0)
    lib = _library()
    err = launch(lib.nms_from_iou_keep_launch, iou, valid, keep, iou_thres,
                 plan)
    if err:
        raise RuntimeError(f"nms_from_iou_keep launch failed: "
                           f"{lib.rotated_nms_error_string(err).decode()}")
    nms_from_iou_keep.launches += 1
    return keep


def nms_from_iou_keep_fake(iou: torch.Tensor, valid: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """`mydet::nms_from_iou_keep`'s output for a traced call."""
    check_cuda(iou, valid)
    return iou.new_empty(iou.shape[:2], dtype=torch.bool)


nms_from_iou_keep.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("rotated_nms")
    lib.nms_from_iou_keep_launch.argtypes = LAUNCH_ARGTYPES
    lib.nms_from_iou_keep_launch.restype = ctypes.c_int
    lib.rotated_nms_layout_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rotated_nms_layout_bytes.restype = ctypes.c_size_t
    lib.rotated_nms_error_string.argtypes = [ctypes.c_int]
    lib.rotated_nms_error_string.restype = ctypes.c_char_p
    return lib
