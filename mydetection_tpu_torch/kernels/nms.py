"""Batched greedy NMS keep-mask: CUDA kernel wrapper, plain version and
launch plan.

`nms_keep` replaces the TPU kernel `mydetection_tpu/ops/pallas/
nms_kernel.py::nms_pallas_impl` (+ `ops/pallas/common.py::
greedy_fixpoint_keep`). On a CUDA tensor it launches `csrc/nms.cu` once
for the whole batch, or raises; only a CPU tensor takes the plain
version, `nms_keep_plain`, a port of the JAX oracle
`mydetection_tpu/ops/nms.py::_blocked_greedy_keep` batched over images.
Greedy keep-sets are unique, so the two agree bit for bit whenever each
IoU rounds alike, which `csrc/nms.cu` guarantees.

`nms_plan` is the launch plan of both greedy kernels (this one and
`rotated_nms.py`'s), a pure function of the shape: a thread block
cluster of `cluster` blocks an image builds the suppression bitmask,
and one warp resolves it from shared memory, where the packed upper
triangle fits there (`stages` 0), else streamed back from a global
scratch through a ring of `stages` word blocks (`csrc/greedy_nms.cuh`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mydetection_tpu_torch.kernels import build
from mydetection_tpu_torch.ops.boxes import pairwise_iou

SMEM_LIMIT = 232_448   # csrc/greedy_nms.cuh kSmemLimit: 227 KB a block
MAX_CLUSTER = 16       # the largest (non-portable) cluster on Hopper
MAX_STAGES = 16        # csrc/greedy_nms.cuh kMaxStages
BLOCKS_PER_SM = 2      # blocks an SM holds at the paths' K (95 KB each)
MIN_ROWS = 32          # mask rows a block of a cluster builds at least
RING_BYTES = 65_536    # the ring a banded resolve gets at least
BOX_FLOATS = 5         # csrc/nms.cu: x1, y1, x2, y2, area a box


def block_len(q: int, words: int) -> int:
    """Words a row of word block q holds in the packed triangle: W - q,
    made odd (csrc/greedy_nms.cuh::block_len)."""
    return (words - q) | 1


def block_offset(q: int, words: int) -> int:
    """Words of the packed triangle before word block q; q = words gives
    the whole triangle (csrc/greedy_nms.cuh::block_offset)."""
    evens = (q + 1) // 2 if words % 2 == 0 else q // 2
    return 32 * (q * words - q * (q - 1) // 2 + evens)


def smem_bytes(k: int, box_floats: int, stages: int) -> int:
    """A block's dynamic shared memory, region by region as
    csrc/greedy_nms.cuh's `make_layout` lays it out, each rounded up to
    128 bytes: the block's scalars, valid and kept bits, the resolve's
    work area (on chip a word a box, banded a word a 32 boxes), the
    ring's mbarriers, then `box_floats` floats for each of 32 * W boxes
    and either the packed triangle (stages 0) or, over the same bytes as
    the boxes, the ring."""
    def up(n):
        return -(-n // 128) * 128
    words = -(-k // 32)
    work = up(128 * words) if stages == 0 else up(4 * words)
    head = 128 + 2 * up(4 * words) + work + up(8 * stages)
    boxes = up(box_floats * 4 * 32 * words)
    if stages == 0:
        return head + boxes + up(4 * block_offset(words, words))
    return head + max(boxes, stages * 128 * block_len(0, words))


@dataclasses.dataclass(frozen=True)
class NMSPlan:
    """How one greedy-NMS launch cuts its work; csrc/greedy_nms.cuh's
    `plan_ok` checks it against its own layout."""
    cluster: int   # blocks an image, 1 to MAX_CLUSTER
    stages: int    # 0: the mask stays on chip; else ring stages (banded)
    smem: int      # dynamic shared memory bytes a block
    rows: int      # mask rows a block builds, at most
    scratch: int   # words of the global mask an image (banded), else 0

    @property
    def on_chip(self) -> bool:
        return self.stages == 0


@functools.lru_cache(maxsize=256)
def nms_plan(b: int, k: int, sms: int, *,
             box_floats: int = BOX_FLOATS) -> NMSPlan:
    """The launch plan for b images of k boxes on a card of `sms` SMs
    (`box_floats` 5: the boxes kernel, csrc/nms.cu; 0: the IoU-matrix
    kernel, csrc/rotated_nms.cu). The cluster is the largest power of
    two up to MAX_CLUSTER that keeps the grid to BLOCKS_PER_SM blocks an
    SM and every block to MIN_ROWS rows (at least 1); measured on an
    H100 (PERF.md), it beats the others at B = 1 and 32. The mask stays on
    chip where the layout fits SMEM_LIMIT; else it is banded, with as
    many ring stages (up to MAX_STAGES) as fit the larger of the boxes'
    bytes and RING_BYTES. Raises ValueError where even two stages do
    not fit."""
    if b < 1 or k < 1:
        raise ValueError(f"nms_plan: no plan for b={b}, k={k}")
    cluster = 1
    while (cluster * 2 <= MAX_CLUSTER
           and b * cluster * 2 <= BLOCKS_PER_SM * sms
           and -(-k // (cluster * 2)) >= MIN_ROWS):
        cluster *= 2
    stages = 0
    if smem_bytes(k, box_floats, 0) > SMEM_LIMIT:
        words = -(-k // 32)
        stage = 128 * block_len(0, words)
        room = max(-(-box_floats * 4 * 32 * words // 128) * 128,
                   RING_BYTES)
        stages = max(2, min(MAX_STAGES, room // stage))
        while stages > 2 and smem_bytes(k, box_floats, stages) > SMEM_LIMIT:
            stages -= 1
        if smem_bytes(k, box_floats, stages) > SMEM_LIMIT:
            raise ValueError(f"K={k} boxes do not fit one block's shared "
                             f"memory")
    words = -(-k // 32)
    return NMSPlan(cluster=cluster, stages=stages,
                   smem=smem_bytes(k, box_floats, stages),
                   rows=-(-k // cluster),
                   scratch=block_offset(words, words) if stages else 0)


def plan_for(valid: torch.Tensor, *,
             box_floats: int = BOX_FLOATS) -> NMSPlan:
    """`nms_plan` for valid (B, K) on its card."""
    b, k = valid.shape
    return nms_plan(b, k, build.sm_count(valid.device),
                    box_floats=box_floats)


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
        ar = idx[:stop - start]
        # spare[:, i, j]: a kept row i leaves column j of the block
        # (j <= i, or iou[i, j] <= thr)
        spare = ~((rows[:, :, start:stop] > thr)
                  & (ar[None, :] > ar[:, None]))              # (B, T, T)
        bk = keep[:, start:stop]
        for i in range(stop - start):
            bk = torch.where(bk[:, i:i + 1], bk & spare[:, i], bk)
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
    (B, K). CPU tensors run `nms_keep_plain`; CUDA tensors call the
    custom op `mydet::nms_keep` (`kernels.ops`), whose CUDA
    implementation `nms_keep_launch` launches the kernel
    (`plan_for(valid)`: a cluster of blocks an image) and counts the
    launch. Raises ValueError for a K whose boxes do not fit a block's
    shared memory (above 11,360).
    """
    if boxes.device.type == "cpu":
        return nms_keep_plain(boxes, valid, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_keep runs on CPU or CUDA tensors, got "
                         f"{boxes.device}")
    return torch.ops.mydet.nms_keep(boxes, valid, float(iou_thres))


def check_cuda(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    """What the kernel takes, in checks a fake tensor can answer too:
    boxes a contiguous (B, K, 4) float32, valid a contiguous (B, K) bool
    or uint8 on the same device."""
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


def nms_keep_launch(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """The CUDA implementation of `mydet::nms_keep`: one launch of
    csrc/nms.cu for the batch, counted on `nms_keep.launches`."""
    check_cuda(boxes, valid)
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep needs 16-byte aligned boxes")
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    plan = plan_for(valid)
    lib = _library()
    err = launch(lib.nms_keep_launch, boxes, valid, keep, iou_thres, plan)
    if err:
        raise RuntimeError(f"nms_keep launch failed: "
                           f"{lib.nms_error_string(err).decode()}")
    nms_keep.launches += 1
    return keep


def nms_keep_fake(boxes: torch.Tensor, valid: torch.Tensor,
                  iou_thres: float) -> torch.Tensor:
    """`mydet::nms_keep`'s output for a traced call."""
    check_cuda(boxes, valid)
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


nms_keep.launches = 0


def launch(fn, src: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor,
           iou_thres: float, plan: NMSPlan) -> int:
    """Calls a greedy kernel's C entry `fn` (nms_keep_launch or
    nms_from_iou_keep_launch) for `plan` on the current stream, with a
    global scratch for a banded plan; returns its cudaError_t."""
    b, k = keep.shape
    scratch = (torch.empty((b, plan.scratch), dtype=torch.int32,
                           device=src.device) if plan.stages else None)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        return fn(src.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None, b, k,
                  float(np.float32(iou_thres)), plan.cluster, plan.stages,
                  plan.smem, stream)


LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load("nms")
    lib.nms_keep_launch.argtypes = LAUNCH_ARGTYPES
    lib.nms_keep_launch.restype = ctypes.c_int
    lib.nms_keep_layout_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nms_keep_layout_bytes.restype = ctypes.c_size_t
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib
