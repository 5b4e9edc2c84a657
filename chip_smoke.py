"""Smoke run of the PyTorch port (`mydetection_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. device   the card (nvidia-smi name, power limit), torch and CUDA;
  2. build    nvcc for every kernel source, all started at once;
  3. kernel   the CUDA NMS keep-mask bit-equal to its plain version on
              B=32, K=1024 hard cases (duplicates, tied scores, pairs
              within 1 ulp of iou_thres, an all-padding image, mixed
              classes through the float32 class offset), and on such
              cases at K=2048 (B=32) and at OLD_LARGEST_NMS_K (B=6),
              where the bitmask goes through a global scratch;
  4. gn       the CUDA bias+GroupNorm+ReLU against its plain version at
              the five FCOS@608 level shapes at B=32, a ragged 5x7 at
              B=3 and a 19x19 image its cluster does not split evenly
              (GN_EDGE_SHAPES), float32 and bf16, channels_last, inputs
              with a non-zero mean; two runs bit for bit;
  5. gn_train the forward-with-statistics kernel (y, mean, inv) and the
              fused backward kernel (dx, dbias, dscale, dshift) against
              their plain versions at the five FCOS@608 level shapes at
              B=16, the ragged 5x7 at B=3 and GN_EDGE_SHAPES, float32
              and bf16, with a live ReLU mask and once with an NCHW dy;
              each kernel twice, bit for bit;
  6. rotated  the CUDA rotated-NMS suppress kernel bit-equal to its plain
              version on B=32, K=512 IoU matrices (rotated person boxes
              with jittered duplicates, entries at iou_thres and one ulp
              around it, a deliberately asymmetric matrix, an
              all-padding image, fewer valid rows than 64), and on such
              matrices at K=2048 (banded) and OLD_LARGEST_ROTATED_K
              (B=12);
  7. tower    the CUDA conv chain (L = 4 x [3x3 conv + bias + ReLU])
              against its plain version at the five RetinaNet@608 level
              shapes at B=32, C=256, and a ragged 9x13 at B=2, C=64,
              float32 (TF32 off) and bf16, inputs with a non-zero mean
              and 0.1 N(0, 1) weights; two runs bit for bit; in bf16
              also against the kernel-order reference at L = 4 and,
              element by element, at L = 1;
  8. bottleneck the CUDA fused stride-1 bottleneck against its plain
              version at the six routed ResNet@608 block shapes at B=32
              (stage 0: 64->256 with the projection, 256->256; stage 1:
              512->512) and ragged 9x13 maps at B=2 with and without a
              projection, float32 (TF32 off) and bf16, inputs with a
              non-zero mean and BN statistics drawn as the TPU script
              draws them; two runs bit for bit;
  9. gather   the CUDA row gather bit-equal to its plain version on
              (32, 69354, 80) bf16 and f32 sources with K=1024 indices
              sorted with duplicates, in top-k order and all equal, and
              on C=7 rows that break 16-byte alignment;
 10. parity   Detector("yolov3", 416), Detector("fcos", 320),
              Detector("rapid", 320), Detector("retinanet", 320) and
              Detector("retinanet_r101", 320), float32 with TF32 off, on
              the card against the same seeded weights on the CPU, on
              procedural canvases (for the RetinaNets a canvas of
              noise);
 11. parity bf16  fcos, retinanet and retinanet_r101 at 320 in bf16 on
              the card against bf16 on the CPU, on the same canvases,
              matched one to one and tie-aware (`match_bf16`);
 12. train parity  fcos, yolov3, rapid and retinanet at 64², batch 2,
              4 classes (rapid 1, with cxcywhθ GT), float32 with TF32
              off: `make_train_step` on the card against the CPU from
              the same seeded weights and batch (the first step's loss
              terms, gradients, update and BN statistics within the CPU
              tests' gates, the launch counts: fcos's GN kernels 40
              each, no kernel on the others), and the loss falling over
              four steps;
 13. main     each detect main path once — yolov3-416, fcos-608,
              rapid-1024, retinanet-608, retinanet_r101-608 — bf16
              `detect_prepared` on 32 canvases, with every kernel launch
              count reset just before and read just after; then the
              batch's latency, img/s and device time; each kernel
              replayed on the path's own inputs for its row;
 14. train main  fcos-608 at full width and depth, bf16, batch 16,
              `make_train_step` with `burn_in_lr` on a synthetic batch:
              2 warm-up and 5 timed steps, each with its launch counts
              reset before and read after; the step's latency, img/s,
              device time split into host (the batch to the card),
              forward, backward and optimizer, peak memory; then both
              trainable GN kernels replayed on the step's own inputs;
              then the same for yolov3-416, retinanet-608 and
              rapid-1024 at batch 16 (TRAIN_MAINS), whose steps launch
              no kernel.

Then one JSON line with a row per kernel, the card's name and power
limit, and the result line `{"ok": true, "device": {...}}`. Needs no
network and runs in a few minutes, the kernels' build included.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

IOU_THRES = 0.45
BATCH = 32
PRE_NMS = 1024
ROT_PRE_NMS = 512   # rapid's registered pre_nms
# the largest K the one-block-an-image NMS kernels took (21 bytes a box in
# shared memory; a K x ceil(K/32) word mask), which their cluster
# redesign must still take
OLD_LARGEST_NMS_K, OLD_LARGEST_ROTATED_K = 10971, 1348
OPS_PER_IOU = 12    # min/max x4, sub x2, clamp x2, mul, add, sub, div
# one Liang-Barsky rotated IoU, counted from ops/rotated.py: midpoint and
# shifts 8, pair-dependent corners 32, two edge-clip passes of ~430 each
# (per corner: frame 9, slab clips 32, clamps 8, endpoints 8, face test
# 28, back-rotation 16, cross 4), areas, union and divide ~11
OPS_PER_ROTATED_IOU = 915
# bias add, sum, square, sum; subtract mean, x inv, x scale, + shift, max
OPS_PER_GN_ELEMENT = 9
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores, published
SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz SM clock
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
GN_GROUPS = 32
GN_F32_GATE = 1e-5          # max |kernel - plain| in float32
GN_NEAR_ZERO = 1e-5         # bf16: one ulp of the output, plus this
# (B, H, W) beside the FCOS levels: an image its cluster does not split
# evenly (kernels/gn.py::gn_plan)
GN_EDGE_SHAPES = [(1, 19, 19)]
# backward: xhat 3, the mask 1, dxhat 1, the two group sums 3, dx 4, the
# three channel sums 4 (counting each element's work once)
OPS_PER_GN_BWD_ELEMENT = 16
TRAIN_BATCH = 16            # the fcos-608 train main path
# the other train main paths, (name, input size, batch): the JAX
# trainer's default run (train.py: yolov3, batch 16) and retinanet-608
# at the same batch; rapid-1024 at batch 16 when its step fits the card
TRAIN_MAINS = (("yolov3", 416, 16), ("retinanet", 608, 16),
               ("rapid", 1024, 16))
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# the small train step held CUDA against CPU (and, in the CPU tests,
# the port against JAX): fcos at 64², batch 2, 4 classes, float32
PARITY_SIZE, PARITY_BATCH, PARITY_CLASSES, PARITY_LR = 64, 2, 4, 1e-3
# its gates; tests/test_torch_port_train.py's docstring has the
# measurements behind them
TRAIN_LOSS_RTOL = 5e-5      # each loss term, relative
TRAIN_HEAD_OUT_GATE = 3e-4  # max-scaled gradient of the convs next to the loss
TRAIN_COSINE_GATE = 0.995   # every parameter's gradient and update
TRAIN_L2_GATE = 0.1         # relative L2 over all parameters
TRAIN_BN_GATE = 1e-3        # max-scaled BN running statistics
HEAD_OUT = ("head.cls_out", "head.box_out", "head.ctr_out", "head.scales")
# the same small step for yolov3, rapid (1 class, cxcywhθ GT) and
# retinanet, under the same gates: each family's floor lies below them
# (tests/test_torch_port_train_<family>.py's docstrings); the gradients
# held max-scaled are those of each family's output convs
TRAIN_FAMILIES = ("fcos", "yolov3", "rapid", "retinanet")
_DARKNET_OUT = ("head.head5.out", "head.head4.out", "head.head3.out")
TRAIN_HEAD_OUT = {"fcos": HEAD_OUT, "yolov3": _DARKNET_OUT,
                  "rapid": _DARKNET_OUT,
                  "retinanet": ("head.cls.out", "head.box.out")}
TOWER_LAYERS = 4
# the conv chain against its plain version, max-scaled: the gates of
# the Pallas chain against the pure-jax loop (tests/test_retinanet.py).
# float32: the sums reassociate; bf16: the kernel rounds once per layer
# after the bias, the plain version (XLA's order) the conv before it
TOWER_F32_GATE = 2e-5
TOWER_BF16_GATE = 0.05
# the bf16 kernel against conv3x3_chain_reference (its own order of
# rounding; the f32 sums only reorder): at L = 1 every element within
# one bf16 ulp plus TOWER_REF_FLOOR of the max |value|; at L = 4,
# max-scaled, where a flipped rounding in one layer moves the next
# layers (PERF.md §2: the measurement behind the gate)
TOWER_REF_FLOOR = 1e-5
TOWER_REF_L4_GATE = 2e-2
GATHER_N, GATHER_C = 69354, 80  # RetinaNet-608's anchors and classes
# the fused bottleneck against its plain version, max-scaled: float32
# the tower's 2e-5 (the sums reassociate); bf16 0.02: the plain version
# rounds where the kernel rounds (each conv's result once, after its
# float32 bias), so only the order of the float32 sums differs and a
# rounding that flips in y1 or y2 moves the next conv; measured 0.00592
# and 0.00521 (PERF.md §2), the JAX test's 0.05 stays on the CPU
BOTTLENECK_F32_GATE = 2e-5
BOTTLENECK_BF16_GATE = 0.02
# (B, H, W, c_in, c_out): the routed blocks at 608, batch 32 — stage 0's
# block 0 (projection) and blocks 1-2, stage 1's blocks 1-3 — ragged maps
# with and without a projection, and for the persistent bf16 kernel and
# TMA's zero fill: one tile, a 1 x 1 map, fewer tiles than SMs at c_mid
# 128, a width that is not a multiple of the tile
BOTTLENECK_SHAPES = [(BATCH, 152, 152, 64, 256), (BATCH, 152, 152, 256, 256),
                     (BATCH, 76, 76, 512, 512), (2, 9, 13, 64, 256),
                     (2, 9, 13, 256, 256), (2, 9, 13, 512, 512),
                     (1, 8, 16, 256, 256), (1, 1, 1, 512, 512),
                     (1, 9, 13, 512, 512), (3, 17, 5, 256, 256)]
# the CUDA-vs-CPU detect parity gates (the goldens')
PARITY_SCORE_GATE, PARITY_BOX_GATE = 1e-4, 1e-2
# the bf16 card-vs-CPU detect check: a card detection matches a CPU one
# of its class within BF16_SCORE_TOL and BF16_BOX_TOL px (one to one,
# tie-aware); at least BF16_MIN_MATCHED of the larger count must match.
# Measured on an H100 (PERF.md §2): fcos 0.93, retinanet 0.81,
# retinanet_r101 0.99 matched, matched pairs' score deltas at most
# 4.77e-4; each gate is its measurement less a margin of 0.10
BF16_SCORE_TOL, BF16_BOX_TOL = 5e-3, 2.0
BF16_MIN_MATCHED = {"fcos": 0.83, "retinanet": 0.71, "retinanet_r101": 0.89}


# ---------------------------------------------------------------------------
# inputs (numpy; the CPU tests use the same generators)
# ---------------------------------------------------------------------------

def golden_image() -> np.ndarray:
    """Deterministic 300x400 structured RGB image (no RNG, no PIL)."""
    h, w = 300, 400
    y = np.arange(h)[:, None]
    x = np.arange(w)[None, :]
    r = (x * 255 // w).astype(np.uint8)
    g = (y * 255 // h).astype(np.uint8)
    b = ((x + y) % 256).astype(np.uint8)
    img = np.stack([r + 0 * y, 0 * x + g, b], -1).astype(np.uint8)
    img[60:180, 50:150] = (220, 40, 40)     # solid rectangle
    img[100:250, 220:360] = (40, 200, 80)   # second rectangle
    return img


def padded_canvas(img: np.ndarray, size: int, x0: int, y0: int):
    """Place `img` on a gray size² canvas at (x0, y0), ratio 1: a
    letterbox without a resize. Returns (canvas, LetterboxInfo)."""
    from mydetection_tpu_torch.utils.image_ops import PAD_VALUE, LetterboxInfo

    h, w = img.shape[:2]
    canvas = np.full((size, size, 3), PAD_VALUE, np.uint8)
    canvas[y0:y0 + h, x0:x0 + w] = img
    return canvas, LetterboxInfo(ori_w=w, ori_h=h, ratio=1.0,
                                 pad_x=float(x0), pad_y=float(y0),
                                 input_size=size)


def _iou32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Float32 IoU of matched xyxy rows, in the kernel's order."""
    iw = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]),
                    np.float32(0))
    ih = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]),
                    np.float32(0))
    inter = iw * ih
    area_a = (np.maximum(a[:, 2] - a[:, 0], np.float32(0))
              * np.maximum(a[:, 3] - a[:, 1], np.float32(0)))
    area_b = (np.maximum(b[:, 2] - b[:, 0], np.float32(0))
              * np.maximum(b[:, 3] - b[:, 1], np.float32(0)))
    return inter / np.maximum((area_a + area_b) - inter, np.float32(1e-9))


def near_threshold_pairs(rng, n: int, thr: float, cls: np.ndarray
                         ) -> np.ndarray:
    """(n, 2, 4) float32 xyxy box pairs, already shifted by their class
    offset `cls * 8192`, whose float32 IoU is thr or one ulp from it."""
    thr32 = np.float32(thr)
    lo = np.nextafter(thr32, np.float32(-1))
    hi = np.nextafter(thr32, np.float32(2))
    found: list[np.ndarray] = []
    offsets = (cls.astype(np.float32) * np.float32(8192.0))
    while sum(len(f) for f in found) < n:
        m = 200_000
        off = offsets[rng.randint(0, len(offsets), m)][:, None]
        wh = rng.uniform(20, 120, (m, 2))
        xy = rng.uniform(0, 300, (m, 2))
        d = wh[:, 0] * (1 - thr) / (1 + thr) * (1 + rng.uniform(-1e-6, 1e-6, m))
        a = (np.concatenate([xy, xy + wh], 1).astype(np.float32) + off)
        b = a.copy()
        shift = d.astype(np.float32)
        b[:, 0] += shift
        b[:, 2] += shift
        iou = _iou32(a, b)
        hit = (iou >= lo) & (iou <= hi)
        found.append(np.stack([a[hit], b[hit]], 1))
    return np.concatenate(found)[:n]


def nms_cases(rng, b: int, k: int, thr: float = IOU_THRES):
    """Hard keep-mask inputs: boxes (b, k, 4) float32 in score order and
    already class-offset, valid (b, k) bool. Image i is of kind i % 6:
    random boxes with holes in `valid`; exact duplicates; tied-score runs
    (duplicates of one box in a row); pairs within 1 ulp of `thr`; all
    padding; mixed classes through the float32 offset."""
    boxes = np.zeros((b, k, 4), np.float32)
    valid = np.zeros((b, k), bool)

    def rand_boxes(n, spread=416.0):
        c = rng.uniform(0, spread, (n, 2))
        wh = rng.uniform(4, 120, (n, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)

    for i in range(b):
        kind = i % 6
        if kind == 0:
            boxes[i] = rand_boxes(k)
            valid[i] = rng.uniform(size=k) < 0.9
        elif kind == 1:
            base = rand_boxes(k)
            src = rng.randint(0, k, k)
            dup = rng.uniform(size=k) < 0.4
            boxes[i] = np.where(dup[:, None], base[np.minimum(src, np.arange(k))],
                                base)
            valid[i, :rng.randint(k // 2, k + 1)] = True
        elif kind == 2:
            base = rand_boxes(-(-k // 8))
            boxes[i] = np.repeat(base, 8, axis=0)[:k]
            valid[i] = True
        elif kind == 3:
            pairs = near_threshold_pairs(rng, -(-k // 2), thr,
                                         rng.randint(0, 80, 64))
            boxes[i] = pairs.reshape(-1, 4)[:k]
            valid[i] = True
        elif kind == 4:
            boxes[i] = rand_boxes(k)
        else:
            cls = rng.randint(0, 80, k).astype(np.float32)
            boxes[i] = rand_boxes(k) + (cls * np.float32(8192.0))[:, None]
            valid[i, :rng.randint(1, k + 1)] = True
    return boxes, valid


def person_boxes(rng, n: int, canvas: float = 1024.0) -> np.ndarray:
    """(n, 5) float32 rotated person-sized boxes (cx, cy, w, h, θ) in a
    canvas² image, about a third of them jittered duplicates of others."""
    c = rng.uniform(0, canvas, (n, 2))
    wh = np.stack([rng.uniform(20, 80, n), rng.uniform(40, 200, n)], 1)
    th = rng.uniform(-np.pi / 2, np.pi / 2, n)
    boxes = np.concatenate([c, wh, th[:, None]], 1)
    dup = rng.uniform(size=n) < 0.35
    src = rng.randint(0, n, n)
    jitter = rng.normal(0, 1, (n, 5)) * [3, 3, 4, 4, 0.05]
    boxes = np.where(dup[:, None], boxes[np.minimum(src, np.arange(n))] + jitter,
                     boxes)
    return boxes.astype(np.float32)


def rotated_cases(rng, b: int, k: int, thr: float = IOU_THRES,
                  device: str = "cpu"):
    """Hard suppress-kernel inputs: iou (b, k, k) float32 on `device`
    from the port's `pairwise_rotated_iou`, rows in score order, and
    valid (b, k) bool. Image i is of kind i % 6: person boxes with
    jittered duplicates; the same with a padding tail; a fifth of the
    upper-triangle entries set to thr or one ulp from it; a deliberately
    asymmetric matrix (the lower triangle replaced by noise, so a kernel
    that reads iou[later, earlier] disagrees); all padding; fewer valid
    rows than 64."""
    from mydetection_tpu_torch.ops.rotated import pairwise_rotated_iou

    boxes = torch.from_numpy(np.stack([person_boxes(rng, k)
                                       for _ in range(b)])).to(device)
    # an image at a time: the eager IoU holds ~830 bytes a pair at its peak
    iou = torch.cat([pairwise_rotated_iou(x[None], x[None])
                     for x in boxes]).contiguous()
    valid = np.ones((b, k), bool)
    thr32 = np.float32(thr)
    near = np.array([np.nextafter(thr32, np.float32(-1)), thr32,
                     np.nextafter(thr32, np.float32(2))], np.float32)
    upper = np.triu(np.ones((k, k), bool), 1)
    for i in range(b):
        kind = i % 6
        if kind == 1:
            valid[i, rng.randint(k // 4, k):] = False
        elif kind == 2:
            hit = upper & (rng.uniform(size=(k, k)) < 0.2)
            m = iou[i].cpu().numpy()
            m[hit] = near[rng.randint(0, 3, int(hit.sum()))]
            iou[i] = torch.from_numpy(m).to(device)
        elif kind == 3:
            m = iou[i].cpu().numpy()
            noise = rng.uniform(0, 1, (k, k)).astype(np.float32)
            m = np.where(upper, m, noise)
            iou[i] = torch.from_numpy(m).to(device)
        elif kind == 4:
            valid[i] = False
        elif kind == 5:
            valid[i] = False
            valid[i, :rng.randint(1, 64)] = True
    return iou, torch.from_numpy(valid).to(device)


def train_batch(seed: int, b: int, size: int, num_classes: int,
                max_gt: int = 100, max_boxes: int = 20,
                rotated: bool = False):
    """A synthetic training batch: uint8 (b, size, size, 3) noise
    canvases and 1 to max_boxes GT boxes an image, (cx, cy, w, h) in net
    pixels (sides size/32 to size/2, centres anywhere on the canvas),
    with `rotated` a fifth column θ in radians, uniform in (−π/2, π/2);
    classes in [0, num_classes), padded to max_gt with zeros and
    gt_valid False, as the JAX package's TrainLoader pads them."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((b, max_gt, 5 if rotated else 4), np.float32)
    classes = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        k = rng.randint(1, max_boxes + 1)
        c = rng.uniform(0, size, (k, 2))
        wh = rng.uniform(size / 32, size / 2, (k, 2))
        boxes[i, :k, :4] = np.concatenate([c, wh], 1)
        classes[i, :k] = rng.randint(0, num_classes, k)
        valid[i, :k] = True
        if rotated:
            boxes[i, :k, 4] = rng.uniform(-np.pi / 2, np.pi / 2, k)
    return images, boxes, classes, valid


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn()` over `iters` runs, by CUDA events. A
    sleep kernel ahead of the start event keeps the card busy while the
    host enqueues the runs, so short kernels are timed back to back and
    not at the pace of the host's launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def greedy_pairs(iou: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> int:
    """The (kept i, later j) entries greedy must consult on these
    inputs: each valid box against the kept boxes before it, up to its
    first suppressor."""
    k = iou.shape[-1]
    kept = keep.long()
    rank = torch.cumsum(kept, dim=1)                       # kept at <= i
    sup = ((iou > np.float32(IOU_THRES)) & keep[:, :, None]
           & torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1))
    has_sup = sup.any(dim=1)                               # (B, K) over j
    first = sup.to(torch.uint8).argmax(dim=1)              # first suppressor
    tested = torch.where(has_sup, torch.gather(rank, 1, first), rank - kept)
    return int((tested * valid.long()).sum())


def nms_bound_ms(boxes: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> tuple[float, str]:
    """Least time for the keep-mask of these inputs: bytes (boxes and
    valid read once, keep written once) over HBM rate, against the IoUs
    greedy needs here (`greedy_pairs`) over the fp32 rate."""
    from mydetection_tpu_torch.ops.boxes import pairwise_iou

    b, k, _ = boxes.shape
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel()
    pairs = greedy_pairs(pairwise_iou(boxes, boxes), valid, keep)
    ops = pairs * OPS_PER_IOU + 3 * b * k                  # + the areas
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_dense_ms(valid: torch.Tensor) -> float:
    """Every upper-triangle IoU of the valid rows (and their areas) over
    the fp32 rate, in ms: what a kernel that does not skip pairs greedy
    never consults would compute."""
    n = valid.long().sum(dim=1)
    ops = int((n * (n - 1) // 2).sum()) * OPS_PER_IOU + 3 * int(n.sum())
    return ops / FP32_OPS_PER_S * 1e3


def rotated_nms_bound_ms(iou: torch.Tensor, valid: torch.Tensor,
                         keep: torch.Tensor) -> tuple[float, str, float]:
    """Least time for the suppress of these inputs: the IoU entries
    greedy needs here (`greedy_pairs`, 4 bytes and one compare each),
    valid read and keep written once, over HBM rate, against the
    compares over the fp32 rate. Also returns the dense figure, every
    entry of the (B, K, K) matrix read once, in ms."""
    pairs = greedy_pairs(iou, valid, keep)
    nbytes = pairs * 4 + valid.numel() + keep.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs / FP32_OPS_PER_S * 1e3
    dense = (iou.numel() * 4 + valid.numel() + keep.numel()) / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            dense)


def rotated_iou_bound_ms(boxes: torch.Tensor) -> tuple[float, str]:
    """Least time for the (B, K, K) rotated-IoU matrix of boxes (B, K,
    5): the boxes read once and the matrix written once over HBM rate,
    against OPS_PER_ROTATED_IOU float32 operations a pair over the fp32
    rate."""
    b, k, _ = boxes.shape
    t_bytes = (boxes.numel() * 4 + b * k * k * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = b * k * k * OPS_PER_ROTATED_IOU / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gn_bound_ms(calls, *, stats: bool = False,
                backward: bool = False) -> tuple[float, str]:
    """Least time for these GN calls: bytes over HBM rate against
    float32 operations over the fp32 rate. Forward (args x, bias, scale,
    shift): x read once, the output written once, the three (C,)
    parameters read once, with `stats` the (B, G) mean and inv written
    once; OPS_PER_GN_ELEMENT an element. Backward (args x, y, dy, bias,
    scale, mean, inv): x, y, dy read once, dx written once, bias, scale,
    mean, inv read and the three (C,) gradients written once;
    OPS_PER_GN_BWD_ELEMENT an element."""
    nbytes = ops = 0
    for args in calls:
        x, c = args[0], args[0].shape[1]
        group_stats = 2 * x.shape[0] * GN_GROUPS * 4
        if backward:
            nbytes += 4 * x.numel() * x.element_size() + 5 * c * 4 + group_stats
            ops += OPS_PER_GN_BWD_ELEMENT * x.numel()
        else:
            nbytes += (2 * x.numel() * x.element_size() + 3 * c * 4
                       + (group_stats if stats else 0))
            ops += OPS_PER_GN_ELEMENT * x.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def within_bf16_ulp(got: torch.Tensor, ref: torch.Tensor, floor: float
                    ) -> bool:
    """Every |got - ref| within one bf16 ulp of the larger of the two
    values plus `floor`."""
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs())
    ulp = (big.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -7
    return bool(((g - r).abs() <= ulp + floor).all())


def gn_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max |got - ref|, within the gate). float32: GN_F32_GATE — the
    two sum in other orders, so the statistics differ by a few float32
    ulps. bf16: one bf16 ulp of the larger of the two values plus
    GN_NEAR_ZERO, since float32 results a few ulps apart round to
    neighbouring bf16 values, and to 0 and a tiny positive value where
    the ReLU cuts."""
    d = float((got.float() - ref.float()).abs().max())
    if got.dtype == torch.float32:
        return d, d <= GN_F32_GATE
    return d, within_bf16_ulp(got, ref, GN_NEAR_ZERO)


def smi_line(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel(rng) -> None:
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain, plan_for

    for b, k in ((BATCH, PRE_NMS), (BATCH, 2048), (6, OLD_LARGEST_NMS_K)):
        boxes_np, valid_np = nms_cases(rng, b, k)
        boxes = torch.from_numpy(boxes_np).cuda()
        valid = torch.from_numpy(valid_np).cuda()
        keep = nms_keep(boxes, valid, IOU_THRES)
        plain = nms_keep_plain(boxes, valid, IOU_THRES)
        torch.cuda.synchronize()
        diff = int((keep != plain).sum())
        if diff:
            bad = sorted({int(i) for i in (keep != plain).nonzero()[:, 0]})
            raise AssertionError(f"kernel keep-mask differs from the plain "
                                 f"version in {diff} entries at B={b} K={k} "
                                 f"(images {bad})")
        if keep[4].any() or not keep.any():
            raise AssertionError("all-padding image kept a box, or none kept")
        print(f"kernel: nms_keep bit-equal to plain on B={b} K={k} hard "
              f"cases ({int(keep.sum())} kept of {int(valid.sum())} valid; "
              f"{plan_text(plan_for(valid))}); kernel "
              f"{cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)):.4f} ms, "
              f"plain {cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 1):.3f} ms",
              flush=True)


def plan_text(plan) -> str:
    """A greedy-NMS launch plan (`kernels.nms.NMSPlan`) in words."""
    where = ("on chip" if plan.on_chip
             else f"banded, {plan.stages} ring stages")
    return f"cluster {plan.cluster}, {plan.rows} rows a block, {where}"


def plan_dict(plan) -> dict:
    return {"cluster": plan.cluster, "rows_a_block": plan.rows,
            "on_chip": plan.on_chip, "stages": plan.stages}


def gn_case(gen, b: int, h: int, w: int, dtype, c: int = 256):
    """A bias_gn_relu call's inputs on the card: x (b, c, h, w) in
    channels_last with mean 2 and unit spread, bias N(0, 0.5), scale
    1 + N(0, 0.2), shift N(0, 0.5)."""
    kw = dict(device="cuda", generator=gen)
    x = (torch.randn(b, c, h, w, **kw) + 2.0).to(dtype).contiguous(
        memory_format=torch.channels_last)
    return (x, torch.randn(c, **kw) * 0.5, 1.0 + torch.randn(c, **kw) * 0.2,
            torch.randn(c, **kw) * 0.5)


def phase_gn() -> None:
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain
    from mydetection_tpu_torch.models.fcos import level_shapes

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = ([(BATCH, h, w) for h, w in level_shapes(608)] + [(3, 5, 7)]
              + GN_EDGE_SHAPES)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w in shapes:
            args = gn_case(gen, b, h, w, dtype)
            got = bias_gn_relu(*args, groups=GN_GROUPS)
            again = bias_gn_relu(*args, groups=GN_GROUPS)
            ref = bias_gn_relu_plain(*args, groups=GN_GROUPS)
            torch.cuda.synchronize()
            err, ok = gn_error(got, ref)
            if not ok or not got.is_contiguous(
                    memory_format=torch.channels_last) \
                    or not torch.equal(got, again):
                raise AssertionError(f"bias_gn_relu {dtype} at {(b, h, w)}: "
                                     f"max |d| {err:.3g} outside its gate, "
                                     f"the output left channels_last, or two "
                                     f"runs differ")
            worst = max(worst, err)
        report.append(f"{str(dtype)[6:]} max |d| {worst:.3g}")
    print(f"gn: bias_gn_relu within its gates of plain and bit-reproducible "
          f"at {[s for s in shapes]} x 256 ch, {GN_GROUPS} groups "
          f"(f32 gate {GN_F32_GATE}, bf16 gate 1 ulp + {GN_NEAR_ZERO}): "
          f"{', '.join(report)}", flush=True)


def max_scaled(got, ref) -> float:
    """max |got - ref| over max |ref|, for tensors or numpy arrays."""
    g, r = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return float((g - r).abs().max() / (r.abs().max() + 1e-30))


def gn_train_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within the gate) for the trainable GN's
    outputs. float32: GN_F32_GATE of the reference's max |value| — the
    kernel and the plain version sum in other orders. bf16 (dx): one
    bf16 ulp of the larger value plus GN_F32_GATE of the max |value|,
    where float32 results a few ulps apart round to neighbouring bf16
    values."""
    err = max_scaled(got, ref)
    if got.dtype == torch.float32:
        return err, err <= GN_F32_GATE
    return err, within_bf16_ulp(got, ref,
                                GN_F32_GATE * float(ref.float().abs().max()))


def gn_train_case(gen, b: int, h: int, w: int, dtype, channels_last_dy=True):
    """A backward call's inputs on the card: gn_case's x, bias, scale and
    shift, the forward-with-statistics kernel's y, mean and inv (a live
    ReLU mask), and dy N(0, 1) in channels_last, or contiguous NCHW."""
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu_fwd_stats

    x, bias, scale, shift = gn_case(gen, b, h, w, dtype)
    y, mean, inv = bias_gn_relu_fwd_stats(x, bias, scale, shift,
                                          groups=GN_GROUPS)
    dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
    if channels_last_dy:
        dy = dy.contiguous(memory_format=torch.channels_last)
    return (x, bias, scale, shift), (x, y, dy, bias, scale, mean, inv)


def check_gn_train_case(fwd_args, bwd_args) -> tuple[float, float]:
    """#4 and #5 against their plain versions on one case, and each
    twice bit for bit; returns the worst (forward, backward) error."""
    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_bwd,
        bias_gn_relu_bwd_plain,
        bias_gn_relu_fwd_stats,
        bias_gn_relu_fwd_stats_plain,
    )

    shape = tuple(fwd_args[0].shape)
    got = bias_gn_relu_fwd_stats(*fwd_args, groups=GN_GROUPS)
    again = bias_gn_relu_fwd_stats(*fwd_args, groups=GN_GROUPS)
    ref = bias_gn_relu_fwd_stats_plain(*fwd_args, groups=GN_GROUPS)
    torch.cuda.synchronize()
    y_err, y_ok = gn_error(got[0], ref[0])
    errs = [max_scaled(a, b) for a, b in zip(got[1:], ref[1:])]
    if not y_ok or max(errs) > GN_F32_GATE or not got[0].is_contiguous(
            memory_format=torch.channels_last) \
            or not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bias_gn_relu_fwd_stats {got[0].dtype} at "
                             f"{shape}: y max |d| {y_err:.3g}, mean/inv "
                             f"max-scaled {errs} outside their gates, y "
                             f"left channels_last, or two runs differ")
    fwd = max([y_err] + errs)
    got = bias_gn_relu_bwd(*bwd_args, groups=GN_GROUPS)
    again = bias_gn_relu_bwd(*bwd_args, groups=GN_GROUPS)
    ref = bias_gn_relu_bwd_plain(*bwd_args, groups=GN_GROUPS)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"bias_gn_relu_bwd at {shape} is not "
                             f"bit-reproducible across two runs")
    bwd = 0.0
    for name, a, b in zip(("dx", "dbias", "dscale", "dshift"), got, ref):
        err, ok = gn_train_error(a, b)
        if not ok or a.dtype != b.dtype:
            raise AssertionError(f"bias_gn_relu_bwd {a.dtype} at {shape}: "
                                 f"{name} max-scaled |d| {err:.3g} outside "
                                 f"its gate")
        bwd = max(bwd, err)
    if not got[0].is_contiguous(memory_format=torch.channels_last):
        raise AssertionError("bias_gn_relu_bwd's dx left channels_last")
    return fwd, bwd


def phase_gn_train() -> None:
    from mydetection_tpu_torch.models.fcos import level_shapes

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = ([(TRAIN_BATCH, h, w) for h, w in level_shapes(608)]
              + [(3, 5, 7)] + GN_EDGE_SHAPES)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = [0.0, 0.0]
        for b, h, w in shapes:
            errs = check_gn_train_case(*gn_train_case(gen, b, h, w, dtype))
            worst = [max(a, e) for a, e in zip(worst, errs)]
        errs = check_gn_train_case(*gn_train_case(gen, *shapes[1], dtype,
                                                  channels_last_dy=False))
        worst = [max(a, e) for a, e in zip(worst, errs)]
        report.append(f"{str(dtype)[6:]} fwd {worst[0]:.3g}, bwd {worst[1]:.3g}")
    print(f"gn_train: bias_gn_relu_fwd_stats (y, mean, inv) and "
          f"bias_gn_relu_bwd (dx, dbias, dscale, dshift) within their gates "
          f"of plain at {shapes} x 256 ch, {GN_GROUPS} groups, live ReLU "
          f"masks, one NCHW dy per dtype; both bit-reproducible over two "
          f"runs: {', '.join(report)}", flush=True)


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


def rel_l2(got: dict, ref: dict) -> float:
    """Relative L2 distance over every entry of two name → array dicts."""
    num = sum(float(((np.asarray(got[k], np.float64) - ref[k]) ** 2).sum())
              for k in ref)
    den = sum(float((np.asarray(ref[k], np.float64) ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def compare_train_step(got: dict, ref: dict, family: str) -> str:
    """One train step against a reference run from the same weights and
    batch, each a dict of "terms" (floats), "grads", "delta" (the
    parameters' update) and "bufs" (BN running statistics), name → numpy.
    The gates are the TRAIN_* constants, the max-scaled one on the
    family's output convs (TRAIN_HEAD_OUT). Returns the report, raises
    outside a gate."""
    bad = []
    terms = {k: abs(got["terms"][k] - v) / abs(v) for k, v in ref["terms"].items()}
    if max(terms.values()) > TRAIN_LOSS_RTOL:
        bad.append(f"loss terms relative {terms}")
    near = max(max_scaled(got["grads"][k], v) for k, v in ref["grads"].items()
               if k.startswith(TRAIN_HEAD_OUT[family]))
    if near > TRAIN_HEAD_OUT_GATE:
        bad.append(f"head output gradients max-scaled {near:.3g}")
    cos = min((cosine(got[w][k], ref[w][k]), f"{w} {k}")
              for w in ("grads", "delta") for k in ref[w])
    if cos[0] < TRAIN_COSINE_GATE:
        bad.append(f"cosine {cos}")
    l2 = max(rel_l2(got[w], ref[w]) for w in ("grads", "delta"))
    if l2 > TRAIN_L2_GATE:
        bad.append(f"relative L2 {l2:.3g}")
    bn = max(max_scaled(got["bufs"][k], v) for k, v in ref["bufs"].items())
    if bn > TRAIN_BN_GATE:
        bad.append(f"BN running statistics max-scaled {bn:.3g}")
    if bad:
        raise AssertionError("train step outside its gates: " + "; ".join(bad))
    return (f"loss terms within {max(terms.values()):.3g} relative, head "
            f"output gradients {near:.3g} max-scaled, every gradient and "
            f"update cosine >= {cos[0]:.6f}, relative L2 {l2:.3g}, BN "
            f"statistics {bn:.3g}")


def parity_train_run(family: str, device: str, steps: int = 4) -> dict:
    """The small train step of `family` on `device` from `init_weights(seed
    0)` and `train_batch(0, ...)` (rapid: one class, cxcywhθ GT): the
    first step phase by phase (terms, gradients, update, BN statistics,
    the kernels' launches), then `steps - 1` more on the same batch;
    "totals" has every step's loss."""
    from mydetection_tpu_torch import kernels
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import make_train_step

    classes = 1 if family == "rapid" else PARITY_CLASSES
    model = get_model(family, num_classes=classes,
                      compute_dtype=torch.float32, input_size=PARITY_SIZE)
    init_weights(model, 0)
    step = make_train_step(model, input_size=PARITY_SIZE, device=device)
    data = train_batch(0, PARITY_BATCH, PARITY_SIZE, classes,
                       rotated=family == "rapid")
    kernels.reset_launches()
    terms = step.forward(*step.batch(*data))
    grads = step.backward(terms)
    p0 = {k: p.detach().clone() for k, p in step.params.items()}
    step.update(grads, PARITY_LR)
    host = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    out = {"terms": {k: float(v.detach()) for k, v in terms.items()},
           "grads": {k: host(g) for k, g in grads.items()},
           "delta": {k: host(p - p0[k]) for k, p in step.params.items()},
           "bufs": {k: host(b) for k, b in model.named_buffers()},
           "launches": {fn.__name__: fn.launches for fn in kernels.KERNELS}}
    out["totals"] = [out["terms"]["total"]] + [
        float(step(*data, PARITY_LR)["total"]) for _ in range(steps - 1)]
    return out


def phase_train_parity() -> None:
    """Each family's small f32 train step on the card against the CPU,
    under the TRAIN_* gates. fcos's step launches the two trainable GN
    kernels 40 times each; the others launch no kernel (the RetinaNet
    towers take `conv3x3_chain_plain` under autograd, the fused
    bottleneck stays out of train mode, Darknet has no kernel)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for family in TRAIN_FAMILIES:
        cpu = parity_train_run(family, "cpu")
        gpu = parity_train_run(family, "cuda")
        want = ({"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40}
                if family == "fcos" else {})
        want = {k: want.get(k, 0) for k in gpu["launches"]}
        if gpu["launches"] != want:
            raise AssertionError(f"the CUDA {family} train step launched "
                                 f"{gpu['launches']}, expected {want}")
        report = compare_train_step(gpu, cpu, family)
        for name, run in (("cuda", gpu), ("cpu", cpu)):
            t = run["totals"]
            if not (np.isfinite(t).all() and t[-1] < t[0]):
                raise AssertionError(f"{name} {family} train loss did not "
                                     f"fall: {t}")
        print(f"train parity: {family}-{PARITY_SIZE} batch {PARITY_BATCH}, "
              f"f32 (TF32 off), make_train_step cuda against cpu from the "
              f"same seeded weights and batch, first step: {report}; "
              f"launches {gpu['launches']}; total loss over "
              f"{len(gpu['totals'])} steps at lr {PARITY_LR}: cuda "
              f"{[round(v, 4) for v in gpu['totals']]}, cpu "
              f"{[round(v, 4) for v in cpu['totals']]}", flush=True)


def phase_rotated(rng) -> None:
    from mydetection_tpu_torch.kernels.nms import plan_for
    from mydetection_tpu_torch.kernels.rotated_nms import (
        nms_from_iou_keep,
        nms_from_iou_keep_plain,
    )

    for b, k in ((BATCH, ROT_PRE_NMS), (12, 2048), (12, OLD_LARGEST_ROTATED_K)):
        iou, valid = rotated_cases(rng, b, k, device="cuda")
        keep = nms_from_iou_keep(iou, valid, IOU_THRES)
        plain = nms_from_iou_keep_plain(iou, valid, IOU_THRES)
        torch.cuda.synchronize()
        diff = int((keep != plain).sum())
        if diff:
            bad = sorted({int(i) for i in (keep != plain).nonzero()[:, 0]})
            raise AssertionError(f"suppress kernel keep-mask differs from the "
                                 f"plain version in {diff} entries at B={b} "
                                 f"K={k} (images {bad})")
        if keep[4].any() or (keep & ~valid).any() or not keep.any():
            raise AssertionError("a padding row was kept, or none kept")
        print(f"rotated: nms_from_iou_keep bit-equal to plain on B={b} "
              f"K={k} hard cases ({int(keep.sum())} kept of "
              f"{int(valid.sum())} valid; "
              f"{plan_text(plan_for(valid, box_floats=0))}); kernel "
              f"{cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES)):.4f} ms, "
              f"plain {cuda_ms(lambda: nms_from_iou_keep_plain(iou, valid, IOU_THRES), 1):.3f} ms",
              flush=True)
        del iou


def tower_case(gen, b: int, h: int, w: int, dtype, c: int = 256,
               layers: int = TOWER_LAYERS, device: str = "cuda"):
    """A conv3x3_chain call's inputs: x (b, c, h, w) in channels_last
    with mean 0.5 and unit spread, the L layers' weights 0.1 N(0, 1)
    packed in `dtype`, biases N(0, 1) (L, c) float32."""
    from mydetection_tpu_torch.kernels.tower import pack_weights

    kw = dict(device=device, generator=gen)
    x = (torch.randn(b, c, h, w, **kw) + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    weights = 0.1 * torch.randn(layers, c, c, 3, 3, **kw)
    return x, pack_weights(weights, dtype), torch.randn(layers, c, **kw)


def tower_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within TOWER_F32_GATE or
    TOWER_BF16_GATE by got's dtype)."""
    err = max_scaled(got, ref)
    gate = TOWER_F32_GATE if got.dtype == torch.float32 else TOWER_BF16_GATE
    return err, err <= gate


def tower_ref_error(got: torch.Tensor, ref: torch.Tensor, layers: int
                    ) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within the gate) for the bf16 kernel
    against conv3x3_chain_reference: at one layer every element within
    one bf16 ulp of the larger value plus TOWER_REF_FLOOR of the max
    |value|, at more TOWER_REF_L4_GATE max-scaled."""
    err = max_scaled(got, ref)
    if layers > 1:
        return err, err <= TOWER_REF_L4_GATE
    return err, within_bf16_ulp(got, ref,
                                TOWER_REF_FLOOR * float(ref.float().abs().max()))


def phase_tower() -> None:
    from mydetection_tpu_torch.kernels.tower import (
        conv3x3_chain,
        conv3x3_chain_plain,
        conv3x3_chain_reference,
    )
    from mydetection_tpu_torch.models.retinanet import level_shapes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(BATCH, h, w, 256) for h, w in level_shapes(608)] + [(2, 9, 13, 64)]
    report = []
    ref_worst = {1: 0.0, TOWER_LAYERS: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w, c in shapes:
            args = tower_case(gen, b, h, w, dtype, c)
            got = conv3x3_chain(*args)
            again = conv3x3_chain(*args)
            ref = conv3x3_chain_plain(*args)
            torch.cuda.synchronize()
            err, ok = tower_error(got, ref)
            if not ok or not torch.equal(got, again) or not got.is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(f"conv3x3_chain {dtype} at {(b, c, h, w)}: "
                                     f"max-scaled |d| {err:.3g} outside its "
                                     f"gate, two runs differ, or the output "
                                     f"left channels_last")
            worst = max(worst, err)
            if dtype == torch.float32:
                continue
            one = tower_case(gen, b, h, w, dtype, c, layers=1)
            for layers, case, out in ((TOWER_LAYERS, args, got),
                                      (1, one, conv3x3_chain(*one))):
                err, ok = tower_ref_error(out, conv3x3_chain_reference(*case),
                                          layers)
                if not ok:
                    raise AssertionError(
                        f"conv3x3_chain bf16 at {(b, c, h, w)}, L = {layers}: "
                        f"outside its gate of the kernel-order reference "
                        f"(max-scaled |d| {err:.3g})")
                ref_worst[layers] = max(ref_worst[layers], err)
        report.append(f"{str(dtype)[6:]} max-scaled |d| {worst:.3g}")
    print(f"tower: conv3x3_chain ({TOWER_LAYERS} layers) within its gates of "
          f"plain at (B, H, W, C) {shapes} (f32 gate {TOWER_F32_GATE}, TF32 "
          f"off; bf16 gate {TOWER_BF16_GATE}), bit-equal over two runs: "
          f"{', '.join(report)}; bf16 against the kernel-order reference: "
          f"L = 1 within one ulp + {TOWER_REF_FLOOR:g} of max everywhere "
          f"(max-scaled |d| {ref_worst[1]:.3g}), L = {TOWER_LAYERS} "
          f"max-scaled |d| {ref_worst[TOWER_LAYERS]:.3g} (gate "
          f"{TOWER_REF_L4_GATE:g})", flush=True)


def bottleneck_case(gen, b: int, h: int, w: int, c_in: int, c_out: int,
                    dtype, device: str = "cuda", bn_bias: float = 0.0,
                    with_block: bool = False):
    """A fused_bottleneck call's inputs: x (b, c_in, h, w) in
    channels_last with mean 0.5 and unit spread, and a port `Bottleneck`
    (a projection when c_in != c_out) with He-normal conv weights, BN
    statistics drawn as the TPU script draws them (mean 0.1 N(0, 1), var
    U(0.5, 2)) and BN biases `bn_bias`, folded in `dtype`. Returns
    (x, Folded), and the block in eval mode and `dtype` as a third item
    with `with_block`."""
    from mydetection_tpu_torch.kernels.bottleneck import fold_bottleneck
    from mydetection_tpu_torch.models.layers import BatchNorm
    from mydetection_tpu_torch.models.resnet import Bottleneck

    kw = dict(device=device, generator=gen)
    block = Bottleneck(c_in, c_out, 1, downsample=c_in != c_out).to(device)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
                m.weight.copy_(std * torch.randn(m.weight.shape, **kw))
            elif isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, **kw))
                m.var.copy_(0.5 + 1.5 * torch.rand(m.var.shape, **kw))
                m.bias.fill_(bn_bias)
    x = (torch.randn(b, c_in, h, w, **kw) + 0.5).to(dtype).contiguous(
        memory_format=torch.channels_last)
    folded = fold_bottleneck(block.eval(), dtype)
    if with_block:
        return x, folded, block.to(dtype)
    return x, folded


def bottleneck_error(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, bool]:
    """(max-scaled |got - ref|, within BOTTLENECK_F32_GATE or
    BOTTLENECK_BF16_GATE by got's dtype)."""
    err = max_scaled(got, ref)
    gate = (BOTTLENECK_F32_GATE if got.dtype == torch.float32
            else BOTTLENECK_BF16_GATE)
    return err, err <= gate


def phase_bottleneck() -> None:
    from mydetection_tpu_torch.kernels import bottleneck as bk

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    report = []
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, h, w, c_in, c_out in BOTTLENECK_SHAPES:
            x, f = bottleneck_case(gen, b, h, w, c_in, c_out, dtype)
            got = bk.fused_bottleneck(x, *f)
            again = bk.fused_bottleneck(x, *f)
            ref = bk.fused_bottleneck_plain(x, *f)
            torch.cuda.synchronize()
            err, ok = bottleneck_error(got, ref)
            if not ok or not torch.equal(got, again) or got.shape != ref.shape \
                    or not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"fused_bottleneck {dtype} at {(b, h, w, c_in, c_out)}: "
                                     f"max-scaled |d| {err:.3g} outside its "
                                     f"gate, two runs differ, or the output "
                                     f"has the wrong shape or layout")
            worst = max(worst, err)
            del x, f, got, again, ref
        report.append(f"{str(dtype)[6:]} max-scaled |d| {worst:.3g}")
    smem = {f"{str(dt)[6:]} c_mid {cm}": bk.smem_bytes(cm, dt)
            for dt in (torch.float32, torch.bfloat16) for cm in bk.C_MIDS}
    print(f"bottleneck: fused_bottleneck within its gates of plain at (B, H, "
          f"W, c_in, c_out) {BOTTLENECK_SHAPES} (f32 gate "
          f"{BOTTLENECK_F32_GATE}, TF32 off; bf16 gate "
          f"{BOTTLENECK_BF16_GATE}), bit-equal over two runs: "
          f"{', '.join(report)}; dynamic shared memory a block {smem} bytes",
          flush=True)


def gather_cases(rng, b: int, n: int, k: int) -> dict:
    """(b, k) int64 index sets over n rows: sorted with duplicates (the
    TPU kernel's contract, first and last rows included), a random
    top-k order, and all equal."""
    srt = np.sort(rng.randint(0, n, (b, k)), axis=1)
    srt[:, :2] = 0
    srt[:, -2:] = n - 1
    topk = np.stack([rng.permutation(n)[:k] for _ in range(b)])
    return {"sorted": srt, "top-k order": topk,
            "all equal": np.full((b, k), rng.randint(0, n))}


def phase_gather(rng) -> None:
    from mydetection_tpu_torch.kernels.gather import gather_rows, gather_rows_plain

    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        src = torch.randn(BATCH, GATHER_N, GATHER_C, device="cuda").to(dtype)
        small = torch.randn(BATCH, 1000, 7, device="cuda").to(dtype)
        for s, k in ((src, PRE_NMS), (small, 300)):
            for kind, sel in gather_cases(rng, BATCH, s.shape[1], k).items():
                for idx in (torch.from_numpy(sel).cuda(),
                            torch.from_numpy(sel).cuda().int()):
                    got = gather_rows(s, idx)
                    if not torch.equal(got, gather_rows_plain(s, idx)):
                        raise AssertionError(f"gather_rows differs from plain "
                                             f"on {tuple(s.shape)} {dtype}, "
                                             f"{kind} {idx.dtype} indices")
            checked.append(f"{tuple(s.shape)} {str(dtype)[6:]}")
        del src, small
    torch.cuda.synchronize()
    print(f"gather: gather_rows bit-equal to plain on {checked}, K = "
          f"{PRE_NMS} (300 on the C=7 rows), indices sorted with duplicates, "
          f"in top-k order and all equal, int64 and int32", flush=True)


def compare_rotated(gpu, cpu) -> str:
    """boxes_rot gates of the rapid parity: cx, cy within 1e-2 px; w, h
    within 1e-2 px + 1e-5 relative (seeded widths reach 1e6 px); θ
    within 1e-5 rad. Returns the report, raises outside a gate."""
    g, c = gpu.boxes_rot, cpu.boxes_rot
    d = np.abs(g - c)
    dxy = float(d[:, :2].max())
    dwh = float((d[:, 2:4] / (1e-2 + 1e-5 * np.abs(c[:, 2:4]))).max())
    dth = float(d[:, 4].max())
    if dxy > 1e-2 or dwh > 1 or dth > 1e-5:
        raise AssertionError(f"rapid cuda/cpu boxes_rot: max |d cxcy| {dxy:.3g}"
                             f" px (gate 1e-2), w/h at {dwh:.3g} of their "
                             f"gate, max |d theta| {dth:.3g} (gate 1e-5)")
    return (f"max |d cxcy| {dxy:.3g} px, w/h at {dwh:.3g} of the gate, "
            f"max |d theta| {dth:.3g}")


def match_detections(gpu, cpu, box_gate) -> bool:
    """One-to-one greedy matching of the CUDA detections to the CPU ones
    under the parity gates: class equal, score within
    PARITY_SCORE_GATE, each box coordinate within `box_gate` px (a
    number, or one per CPU coordinate). Neighbours whose scores are
    closer than the two devices' score error may come out swapped; a
    wrong box, score, class or count cannot match."""
    used = np.zeros(len(cpu), bool)
    for box, score, cls in zip(gpu.boxes_xyxy, gpu.scores, gpu.classes):
        db = np.abs(cpu.boxes_xyxy - box[None])
        cand = (~used & (cpu.classes == cls) & (db <= box_gate).all(axis=1)
                & (np.abs(cpu.scores - score) <= PARITY_SCORE_GATE))
        if not cand.any():
            return False
        used[int(np.argmin(np.where(cand, db.max(axis=1), np.inf)))] = True
    return True


def float64_boxes(name: str, canvas, info, conf: float, cpu) -> np.ndarray:
    """The boxes of a float64 CPU run of the same seeded model on the
    same canvas (the postprocess in float32, as in every run), which
    must keep the float32 CPU run's detections in its order."""
    from mydetection_tpu_torch import Detector

    det = Detector(name, device="cpu", input_size=canvas.shape[0],
                   compute_dtype=torch.float64, rng_seed=0)
    ref = det.detect_prepared(canvas[None], [info], conf_thres=conf,
                              nms_iou=IOU_THRES)[0]
    if len(ref) != len(cpu) or not np.array_equal(ref.classes, cpu.classes):
        raise AssertionError(f"{name} float64 and float32 CPU runs keep "
                             f"different detections; no float32 floor")
    return ref.boxes_xyxy.astype(np.float64)


def check_parity(name: str, canvas, info, conf: float, expect: dict,
                 box_floor: bool = False) -> None:
    """The CUDA Detector against the CPU one on the same seeded weights,
    float32, TF32 off: counts and classes equal, scores within
    PARITY_SCORE_GATE, boxes within PARITY_BOX_GATE px (rotated:
    `compare_rotated`), row by row or, where tied neighbours swap, by
    `match_detections`; the CUDA run launches each kernel in `expect`
    that many times. With `box_floor`, the box gate is PARITY_BOX_GATE
    plus twice the CPU's own float32 error F, the largest distance of
    its box coordinates from a float64 run's (`float64_boxes`): two
    float32 runs may each be F from the float64 one."""
    from mydetection_tpu_torch import Detector

    size = canvas.shape[0]
    kw = dict(input_size=size, compute_dtype=torch.float32, rng_seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        det = Detector(name, device=device, **kw)
        before = {fn: fn.launches for fn in expect}
        runs[device] = det.detect_prepared(canvas[None], [info],
                                           conf_thres=conf,
                                           nms_iou=IOU_THRES)[0]
        launched = {fn.__name__: fn.launches - before[fn] for fn in expect}
    cpu, gpu = runs["cpu"], runs["cuda"]
    box_gate, floor_note = PARITY_BOX_GATE, ""
    if box_floor:
        ref = float64_boxes(name, canvas, info, conf, cpu)
        floor = float(np.abs(cpu.boxes_xyxy - ref).max())
        box_gate = PARITY_BOX_GATE + 2.0 * floor
        own = (f"{float(np.abs(gpu.boxes_xyxy - ref).max()):.3g} px"
               if np.array_equal(gpu.classes, cpu.classes) else "not aligned")
        floor_note = (f" (gate {PARITY_BOX_GATE} px + 2 x {floor:.3g} px, the "
                      f"largest distance of the cpu's float32 boxes from a "
                      f"float64 run's; the card's from it: {own})")
    want = {fn.__name__: n for fn, n in expect.items()}
    if launched != want:
        raise AssertionError(f"CUDA {name} detect launched {launched}, "
                             f"expected {want}")
    if len(gpu) != len(cpu):
        raise AssertionError(f"{name} cuda/cpu detections differ: {len(gpu)} "
                             f"vs {len(cpu)} boxes")
    if len(cpu) == 0:
        raise AssertionError(f"{name} parity canvas produced no detections")
    gaps = np.diff(np.sort(cpu.scores))
    gap = (f"{float(gaps[gaps > 0].min()):.3g}" if (gaps > 0).any()
           else "none: every score is equal")
    if cpu.boxes_rot is not None:
        if not np.array_equal(gpu.classes, cpu.classes):
            raise AssertionError(f"{name} cuda/cpu classes differ")
        ds = float(np.abs(gpu.scores - cpu.scores).max())
        if ds > PARITY_SCORE_GATE:
            raise AssertionError(f"{name} cuda/cpu max |d score| {ds:.3g} "
                                 f"(gate {PARITY_SCORE_GATE})")
        branch, boxes = "row by row", compare_rotated(gpu, cpu)
    else:
        ds = float(np.abs(gpu.scores - cpu.scores).max())
        dbox = np.abs(gpu.boxes_xyxy - cpu.boxes_xyxy)
        db = float(dbox.max())
        if (np.array_equal(gpu.classes, cpu.classes)
                and ds <= PARITY_SCORE_GATE and (dbox <= box_gate).all()):
            branch = "row by row"
        elif match_detections(gpu, cpu, box_gate):
            branch = "one-to-one match (tied neighbours swapped)"
        else:
            raise AssertionError(f"{name} cuda/cpu detections differ: classes "
                                 f"{gpu.classes[:10]} vs {cpu.classes[:10]}, "
                                 f"max |d score| {ds:.3g} (gate "
                                 f"{PARITY_SCORE_GATE}), max |d box| {db:.3g} "
                                 f"px{floor_note or f' (gate {box_gate})'}, "
                                 f"and no one-to-one match")
        boxes = f"max |d box| {db:.3g} px{floor_note}"
    print(f"parity: {name}-{size} f32 (TF32 off) cuda == cpu on {len(cpu)} "
          f"detections at conf {conf}, {branch}, row-wise max |d score| "
          f"{ds:.3g}, {boxes}; smallest gap between distinct cpu scores "
          f"{gap}; launches {launched}", flush=True)


def noise_canvas(size: int, seed: int = 5):
    """A size² canvas of uniform uint8 noise that fills it (no letterbox
    border, so no region of identical pixels), with its LetterboxInfo."""
    from mydetection_tpu_torch.utils.image_ops import LetterboxInfo

    canvas = np.random.RandomState(seed).randint(0, 256, (size, size, 3))
    return canvas.astype(np.uint8), LetterboxInfo(
        ori_w=size, ori_h=size, ratio=1.0, pad_x=0.0, pad_y=0.0,
        input_size=size)


def parity_cases() -> dict:
    """name → (canvas, info, conf) of the detect parity runs: yolov3 on
    the letterboxed golden image at 416, fcos and rapid on its middle at
    320, the RetinaNets on a 320² noise canvas (a uniform letterbox
    border would give exactly tied candidates). At init FCOS scores sit
    near 0.01 x 0.5: conf 0.005 keeps fcos from being vacuous."""
    middle = padded_canvas(golden_image()[:, 50:350], 320, 10, 10)
    return {"yolov3": (*padded_canvas(golden_image(), 416, 8, 58), 0.25),
            "fcos": (*middle, 0.005), "rapid": (*middle, 0.3),
            "retinanet": (*noise_canvas(320), 0.005),
            "retinanet_r101": (*noise_canvas(320), 0.005)}


def phase_parity() -> None:
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck
    from mydetection_tpu_torch.kernels.gather import gather_rows
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu
    from mydetection_tpu_torch.kernels.nms import nms_keep
    from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = parity_cases()
    check_parity("yolov3", *cases["yolov3"], {nms_keep: 1, fused_bottleneck: 0})
    check_parity("fcos", *cases["fcos"], {nms_keep: 1, bias_gn_relu: 40,
                                          gather_rows: 1, fused_bottleneck: 6})
    check_parity("rapid", *cases["rapid"], {nms_from_iou_keep: 1,
                                            fused_bottleneck: 0})
    # the seeded deltas reach |d| ~ 50, so a corner is the difference of
    # two coordinates near 1e4 px and float32 alone moves it by ~1e-2 px
    # (the CPU's float32 boxes are 0.0139 px from its float64 ones here)
    for name in ("retinanet", "retinanet_r101"):
        check_parity(name, *cases[name],
                     {nms_keep: 1, conv3x3_chain: 10, gather_rows: 1,
                      fused_bottleneck: 6}, box_floor=True)


def match_bf16(gpu, cpu) -> dict:
    """Tie-aware one-to-one matching of bf16 card detections to bf16 CPU
    ones: each card detection, in score order, takes the unused CPU
    detection of its class within BF16_SCORE_TOL and BF16_BOX_TOL px
    (largest coordinate difference) that lies nearest, so neighbours
    tied in score may pair in any order. Returns the matched count, the
    unmatched counts of both sides and the largest score and box deltas
    of the matched pairs."""
    used = np.zeros(len(cpu), bool)
    ds = db = 0.0
    for box, score, cls in zip(gpu.boxes_xyxy, gpu.scores, gpu.classes):
        dist = np.abs(cpu.boxes_xyxy - box[None]).max(axis=1) \
            if len(cpu) else np.zeros(0)
        dscore = np.abs(cpu.scores - score)
        cand = (~used & (cpu.classes == cls) & (dist <= BF16_BOX_TOL)
                & (dscore <= BF16_SCORE_TOL))
        if cand.any():
            j = int(np.argmin(np.where(cand, dist, np.inf)))
            used[j] = True
            ds, db = max(ds, float(dscore[j])), max(db, float(dist[j]))
    matched = int(used.sum())
    return {"matched": matched, "unmatched_card": len(gpu) - matched,
            "unmatched_cpu": len(cpu) - matched, "max_d_score": ds,
            "max_d_box_px": db}


def phase_parity_bf16() -> None:
    """fcos, retinanet and retinanet_r101 at 320 in bf16 on the card
    against the same seeded weights in bf16 on the CPU, on the parity
    canvases. The card runs the kernels' numerics (float32 through each
    bias, one rounding per conv), the CPU the JAX bf16 graph's (the conv
    rounded first), so detections near a cut (the confidence gate, the
    top-k, NMS) may differ: `match_bf16` pairs them, and at least
    BF16_MIN_MATCHED of the larger count must pair."""
    from mydetection_tpu_torch import Detector

    cases = parity_cases()
    for name in ("fcos", "retinanet", "retinanet_r101"):
        canvas, info, conf = cases[name]
        runs = [Detector(name, device=device, input_size=canvas.shape[0],
                         compute_dtype=torch.bfloat16, rng_seed=0)
                .detect_prepared(canvas[None], [info], conf_thres=conf,
                                 nms_iou=IOU_THRES)[0]
                for device in ("cuda", "cpu")]
        m = match_bf16(*runs)
        frac = m["matched"] / max(len(runs[0]), len(runs[1]), 1)
        print(f"parity bf16: {name}-{canvas.shape[0]} cuda vs cpu, "
              f"{len(runs[0])} and {len(runs[1])} detections at conf {conf}: "
              f"{m['matched']} matched ({frac:.3f} of the larger count; gate "
              f">= {BF16_MIN_MATCHED[name]}) within {BF16_SCORE_TOL} score and "
              f"{BF16_BOX_TOL} px, {m['unmatched_card']} card and "
              f"{m['unmatched_cpu']} cpu unmatched; matched pairs max "
              f"|d score| {m['max_d_score']:.3g}, max |d box| "
              f"{m['max_d_box_px']:.3g} px", flush=True)
        if frac < BF16_MIN_MATCHED[name]:
            raise AssertionError(f"{name} bf16 cuda/cpu: {frac:.3f} of the "
                                 f"detections matched, gate "
                                 f"{BF16_MIN_MATCHED[name]}")


def main_canvases(size: int):
    """BATCH procedural canvases: the golden image with noise, padded
    at random offsets."""
    rng = np.random.RandomState(1)
    img = golden_image()
    canvases, infos = [], []
    for _ in range(BATCH):
        noisy = np.clip(img.astype(np.int16) + rng.randint(-20, 21, img.shape),
                        0, 255).astype(np.uint8)
        c, i = padded_canvas(noisy, size, rng.randint(0, size - 399),
                             rng.randint(0, size - 299))
        canvases.append(c)
        infos.append(i)
    return np.stack(canvases), infos


def check_detections(dets, infos, name: str, rotated: bool) -> None:
    """Per image: finite, descending scores; fcos and rapid at least one
    detection; axis-aligned boxes inside their image; rotated boxes with
    w, h > 0 and θ in [-π/2, π/2] (their envelope is not clipped, as in
    the JAX package)."""
    for d, info in zip(dets, infos):
        s = d.scores
        if len(s) == 0 and name != "yolov3":
            raise AssertionError(f"a {name} image yielded no detection")
        if not (np.isfinite(s).all() and np.isfinite(d.boxes_xyxy).all()):
            raise AssertionError("non-finite detections")
        if len(s) > 1 and (np.diff(s) > 0).any():
            raise AssertionError("scores are not descending")
        if rotated:
            r = d.boxes_rot
            if not (np.isfinite(r).all() and (r[:, 2:4] > 0).all()
                    and (np.abs(r[:, 4]) <= np.float32(np.pi / 2)).all()):
                raise AssertionError("a rotated box is non-finite, has no "
                                     "area, or its angle leaves [-pi/2, pi/2]")
            continue
        bx = d.boxes_xyxy
        if len(bx) and ((bx < 0).any() or (bx[:, 0::2] > info.ori_w).any()
                        or (bx[:, 1::2] > info.ori_h).any()):
            raise AssertionError("a box lies outside its image")


def drive_main(name: str, size: int, conf: float, smi: str, expect: dict,
               capture_gn: bool = False) -> dict:
    """One main path: bf16 `detect_prepared` on BATCH canvases with every
    launch count reset just before and read just after (each kernel in
    `expect` must show exactly that count, every other kernel none),
    the detections checked, then the batch's timing. Returns the NMS
    inputs (rotated: the suppress kernel's, and the boxes behind its IoU
    matrix; with capture_gn, every bias_gn_relu call's inputs too), the
    gather's (src, sel), every conv3x3_chain call's (x, packed,
    biases) and every fused_bottleneck call's (x, folded) of the counted
    run, and the routed blocks in call order."""
    from mydetection_tpu_torch import Detector, kernels
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck
    from mydetection_tpu_torch.kernels.gather import gather_rows
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu
    from mydetection_tpu_torch.kernels.nms import nms_keep
    from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain
    from mydetection_tpu_torch.models import fcos as fcos_mod
    from mydetection_tpu_torch.models import resnet as resnet_mod
    from mydetection_tpu_torch.models import retinanet as retina_mod
    from mydetection_tpu_torch.ops import nms as ops_nms
    from mydetection_tpu_torch.ops import rotated as ops_rot
    from mydetection_tpu_torch.registry import forward_dense

    det = Detector(name, input_size=size, rng_seed=0)  # cuda, bf16
    rotated = det.cfg.rotated
    canvases, infos = main_canvases(size)
    det.warmup(batch_size=BATCH)
    captured = {"gn": [], "chain": [], "bottleneck": [],
                "blocks": [m for m in det.model.modules()
                           if isinstance(m, resnet_mod.Bottleneck) and m.fused]}
    pairwise = ops_rot.pairwise_rotated_iou

    def capture_nms(boxes, valid, thr):
        captured.update(boxes=boxes, valid=valid)
        return nms_keep(boxes, valid, thr)

    def capture_suppress(iou, valid, thr, **kw):
        captured.update(iou=iou, valid=valid)
        return nms_from_iou_keep(iou, valid, thr, **kw)

    def capture_pairwise(a, b):
        captured.update(rot_boxes=a)
        return pairwise(a, b)

    def capture_gn_call(x, bias, scale, shift, **kw):
        captured["gn"].append((x, bias, scale, shift))
        return bias_gn_relu(x, bias, scale, shift, **kw)

    def capture_chain(x, packed, biases):
        captured["chain"].append((x, packed, biases))
        return conv3x3_chain(x, packed, biases)

    def capture_gather(src, sel):
        captured["gather"] = (src, sel)
        return gather_rows(src, sel)

    def capture_bottleneck(x, *folded):
        captured["bottleneck"].append((x, folded))
        return fused_bottleneck(x, *folded)

    ops_nms.nms_keep = capture_nms
    ops_nms.gather_rows = capture_gather
    ops_rot.nms_from_iou_keep = capture_suppress
    ops_rot.pairwise_rotated_iou = capture_pairwise
    retina_mod.conv3x3_chain = capture_chain
    resnet_mod.fused_bottleneck = capture_bottleneck
    if capture_gn:
        fcos_mod.bias_gn_relu = capture_gn_call
    try:
        kernels.reset_launches()
        dets = det.detect_prepared(canvases, infos, conf_thres=conf,
                                   nms_iou=IOU_THRES)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    finally:
        ops_nms.nms_keep = nms_keep
        ops_nms.gather_rows = gather_rows
        ops_rot.nms_from_iou_keep = nms_from_iou_keep
        ops_rot.pairwise_rotated_iou = pairwise
        retina_mod.conv3x3_chain = conv3x3_chain
        resnet_mod.fused_bottleneck = fused_bottleneck
        fcos_mod.bias_gn_relu = bias_gn_relu
    want = {fn.__name__: expect.get(fn.__name__, 0) for fn in kernels.KERNELS}
    if launches != want:
        raise AssertionError(f"{name} main path launches {launches}, "
                             f"expected {want}")
    check_detections(dets, infos, name, rotated)

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        det.detect_prepared(canvases, infos, conf_thres=conf,
                            nms_iou=IOU_THRES)
        times.append(time.perf_counter() - t0)
    clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
    lat = float(np.median(times))
    # device time of the two halves of the batch, by CUDA events
    images = torch.from_numpy(canvases).cuda()
    conf_t = torch.full((BATCH,), conf, device="cuda")
    with torch.inference_mode():
        dense = forward_dense(det.model, images)
        fwd_ms = cuda_ms(lambda: forward_dense(det.model, images), 5)
        post_ms = cuda_ms(lambda: det._post(dense, conf_t, IOU_THRES), 5)
    split = ""
    if rotated:
        rb, iou, valid = captured["rot_boxes"], captured["iou"], captured["valid"]
        with torch.inference_mode():
            iou_ms = cuda_ms(lambda: pairwise(rb, rb), 5)
        kernel_ms = cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES))
        iou_bound, iou_by = rotated_iou_bound_ms(rb)
        split = (f" (IoU matrix {iou_ms:.3f} ms, bound {iou_bound:.4f} ms by "
                 f"{iou_by}; suppress kernel {kernel_ms:.4f} ms); detections "
                 f"per image {[len(d) for d in dets]}")
    print(f"main: {name}-{size} bf16 detect_prepared batch {BATCH} at conf "
          f"{conf}: {len(dets)} images, {sum(len(d) for d in dets)} "
          f"detections, launches {launches}; median batch latency "
          f"{lat * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {BATCH / lat:.1f} img/s; device: "
          f"forward_dense {fwd_ms:.2f} ms, postprocess {post_ms:.2f} ms"
          f"{split}; on {smi} (sm clock, power, temp after: {clocks})",
          flush=True)
    captured["launches"] = launches
    return captured


def nms_row(captured: dict, path: str) -> dict:
    """The NMS kernel at the main path's own inputs: batch 32, and the
    first image alone (B = 1, as `detect_one` sends)."""
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain, plan_for

    boxes, valid = captured["boxes"], captured["valid"]
    keep = nms_keep(boxes, valid, IOU_THRES)
    plain = nms_keep_plain(boxes, valid, IOU_THRES)
    err = float((keep.float() - plain.float()).abs().max())
    if err:
        raise AssertionError("kernel and plain keep-masks differ on the "
                             "main path's NMS inputs")
    b1, v1 = boxes[:1].contiguous(), valid[:1].contiguous()
    if not torch.equal(nms_keep(b1, v1, IOU_THRES), plain[:1]):
        raise AssertionError("kernel keep-mask at B=1 differs from plain")
    bound, bound_by = nms_bound_ms(boxes, valid, keep)
    row = {
        "name": "nms_keep", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/nms.cu",
        "replaces": "mydetection_tpu/ops/pallas/nms_kernel.py:38",
        "launches": captured["launches"]["nms_keep"], "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)),
        "plain_ms": cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "ms_b1": cuda_ms(lambda: nms_keep(b1, v1, IOU_THRES)),
        "bound_ms_b1": nms_bound_ms(b1, v1, keep[:1])[0],
        "dense_ms": nms_dense_ms(valid),
        "valid": int(valid.sum()), "kept": int(keep.sum()),
        "plan": plan_dict(plan_for(valid)), "plan_b1": plan_dict(plan_for(v1)),
        "note": "no single PyTorch call computes greedy NMS; bound_ms "
                "counts the IoUs greedy consults on these inputs, "
                "dense_ms every upper-triangle IoU of the valid rows; "
                "ms_b1 is the first image alone",
    }
    print(f"nms on the {path} main path: {row['kept']} kept of "
          f"{row['valid']} valid, bit-equal; kernel {row['ms']:.4f} ms "
          f"(bound {bound:.6f} ms by {bound_by}, every valid pair "
          f"{row['dense_ms']:.6f} ms; {plan_text(plan_for(valid))}), B=1 "
          f"{row['ms_b1']:.4f} ms ({plan_text(plan_for(v1))}), plain "
          f"{row['plain_ms']:.3f} ms", flush=True)
    return row


def gn_levels(calls, kind: str, run, bound, library) -> list[dict]:
    """For each distinct input shape of `calls`, in order (an FCOS
    level): how many calls, one call's kernel ms (`run(args)`), bound ms
    (`bound(args)`) and library ms (`library(i)` for the shape's first
    call i), and the plan's cluster, whether the range stays on chip,
    and how many clusters the card holds at once."""
    from mydetection_tpu_torch.kernels.gn import max_active_clusters, plan_for

    first = {}
    for i, args in enumerate(calls):
        first.setdefault(tuple(args[0].shape), []).append(i)
    levels = []
    for shape, idx in first.items():
        args = calls[idx[0]]
        plan = plan_for(kind, args[0], GN_GROUPS)
        levels.append({
            "shape": list(shape), "calls": len(idx),
            "ms": cuda_ms(lambda: run(args), 20), "bound_ms": bound(args),
            "library_ms": cuda_ms(lambda: library(idx[0]), 20),
            "cluster": plan.cluster, "resident": plan.resident,
            "clusters_resident": max_active_clusters(kind, args[0],
                                                     GN_GROUPS)})
    return levels


def level_text(levels: list[dict]) -> str:
    return ", ".join(f"{lv['shape'][2]}x{lv['shape'][3]} x{lv['calls']}: "
                     f"{lv['ms']:.4f} / {lv['bound_ms']:.4f} / "
                     f"{lv['library_ms']:.4f} (cluster {lv['cluster']}, "
                     f"{lv['clusters_resident']} at once"
                     f"{'' if lv['resident'] else ', streaming'})"
                     for lv in levels)


def gn_row(captured: dict) -> dict:
    """The GN kernel at the main path's own inputs: the 40 calls of one
    FCOS forward, summed, the first P3 call alone, and one call a level
    (`levels`)."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.gn import bias_gn_relu, bias_gn_relu_plain

    calls = captured["gn"]
    err = 0.0
    for args in calls:
        e, ok = gn_error(bias_gn_relu(*args, groups=GN_GROUPS),
                         bias_gn_relu_plain(*args, groups=GN_GROUPS))
        if not ok:
            raise AssertionError(f"bias_gn_relu outside its gate of plain on "
                                 f"the main path's {tuple(args[0].shape)} "
                                 f"input: max |d| {e:.3g}")
        err = max(err, e)
    lib_in = [(x + b.to(x.dtype)[:, None, None], s.to(x.dtype), t.to(x.dtype))
              for x, b, s, t in calls]
    ms = cuda_ms(lambda: [bias_gn_relu(*a, groups=GN_GROUPS) for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [F.group_norm(x, GN_GROUPS, s, t, 1e-5)
                              for x, s, t in lib_in], 5)
    p3 = calls[0]
    p3_ms = cuda_ms(lambda: bias_gn_relu(*p3, groups=GN_GROUPS))
    p3_bound, _ = gn_bound_ms([p3])
    bound, bound_by = gn_bound_ms(calls)
    levels = gn_levels(
        calls, "fwd", lambda a: bias_gn_relu(*a, groups=GN_GROUPS),
        lambda a: gn_bound_ms([a])[0],
        lambda i: F.group_norm(lib_in[i][0], GN_GROUPS, *lib_in[i][1:], 1e-5))
    print(f"gn on the fcos main path: {len(calls)} calls, kernel {ms:.4f} ms "
          f"summed (bound {bound:.4f} ms by {bound_by}), plain {plain_ms:.3f} "
          f"ms, F.group_norm {lib_ms:.4f} ms; the P3 call "
          f"{tuple(p3[0].shape)} alone {p3_ms:.4f} ms (bound "
          f"{p3_bound:.4f} ms); one call a level (kernel / bound / "
          f"F.group_norm ms): {level_text(levels)}", flush=True)
    return {
        "name": "bias_gn_relu", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:59",
        "launches": captured["launches"]["bias_gn_relu"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms,
        "p3_ms": p3_ms, "p3_bound_ms": p3_bound, "levels": levels,
        "note": "times sum the 40 calls of one forward; levels time one "
                "call of each level; library_ms is F.group_norm on "
                "x + bias, which leaves out the bias add and the ReLU",
    }


def rotated_row(captured: dict) -> dict:
    """The suppress kernel at the rapid main path's own inputs: batch 32,
    and the first image alone (B = 1)."""
    from mydetection_tpu_torch.kernels.nms import plan_for
    from mydetection_tpu_torch.kernels.rotated_nms import (
        nms_from_iou_keep,
        nms_from_iou_keep_plain,
    )

    iou, valid = captured["iou"], captured["valid"]
    keep = nms_from_iou_keep(iou, valid, IOU_THRES)
    plain = nms_from_iou_keep_plain(iou, valid, IOU_THRES)
    err = float((keep.float() - plain.float()).abs().max())
    if err:
        raise AssertionError("suppress kernel and plain keep-masks differ on "
                             "the rapid main path's inputs")
    i1, v1 = iou[:1].contiguous(), valid[:1].contiguous()
    if not torch.equal(nms_from_iou_keep(i1, v1, IOU_THRES), plain[:1]):
        raise AssertionError("suppress kernel at B=1 differs from plain")
    bound, bound_by, dense = rotated_nms_bound_ms(iou, valid, keep)
    row = {
        "name": "nms_from_iou_keep", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/rotated_nms.cu",
        "replaces": "mydetection_tpu/ops/pallas/rotated_nms_kernel.py:36",
        "launches": captured["launches"]["nms_from_iou_keep"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_from_iou_keep(iou, valid, IOU_THRES)),
        "plain_ms": cuda_ms(lambda: nms_from_iou_keep_plain(iou, valid,
                                                            IOU_THRES), 3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "dense_read_ms": dense,
        "ms_b1": cuda_ms(lambda: nms_from_iou_keep(i1, v1, IOU_THRES)),
        "bound_ms_b1": rotated_nms_bound_ms(i1, v1, keep[:1])[0],
        "valid": int(valid.sum()), "kept": int(keep.sum()),
        "plan": plan_dict(plan_for(valid, box_floats=0)),
        "plan_b1": plan_dict(plan_for(v1, box_floats=0)),
        "note": "no single PyTorch call computes greedy NMS from an IoU "
                "matrix; bound_ms counts the entries greedy consults on "
                "these inputs, dense_read_ms every entry of the matrix; "
                "ms_b1 is the first image alone",
    }
    print(f"rotated on the rapid main path: {row['kept']} kept of "
          f"{row['valid']} valid (per image {keep.sum(1).tolist()}), "
          f"bit-equal; kernel {row['ms']:.4f} ms "
          f"(bound {bound:.6f} ms by {bound_by}, the whole matrix read once "
          f"{dense:.4f} ms; {plan_text(plan_for(valid, box_floats=0))}), B=1 "
          f"{row['ms_b1']:.4f} ms "
          f"({plan_text(plan_for(v1, box_floats=0))}), plain "
          f"{row['plain_ms']:.3f} ms", flush=True)
    return row


def tower_bound_ms(calls) -> tuple[float, str]:
    """Least time for these conv3x3_chain calls (args x, packed,
    biases): 2·B·H·W·9·C·C multiply-adds a layer over the bf16 tensor
    rate, against x read, the output written, the packed weights and
    the biases read once over HBM rate."""
    ops = nbytes = 0
    for x, packed, biases in calls:
        b, c, h, w = x.shape
        ops += 2 * b * h * w * packed.shape[1] * c * packed.shape[0]
        nbytes += (2 * x.numel() * x.element_size()
                   + packed.numel() * packed.element_size() + biases.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def tower_row(captured: dict) -> dict:
    """The conv chain at the retinanet main path's own inputs: the 10
    calls of one forward (2 subnets x 5 levels), summed, the first P3
    call alone, and one subnet's five levels (P3 to P7) each against
    its bound and cuDNN."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.tower import (
        conv3x3_chain,
        conv3x3_chain_plain,
        unpack_weights,
    )

    calls = captured["chain"]
    err = 0.0
    for args in calls:
        got, again = conv3x3_chain(*args), conv3x3_chain(*args)
        e, ok = tower_error(got, conv3x3_chain_plain(*args))
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"conv3x3_chain outside its gate of plain, or "
                                 f"not bit-reproducible, on the main path's "
                                 f"{tuple(args[0].shape)} input: {e:.3g}")
        err = max(err, e)
    # the library yardstick: per layer one cuDNN conv with its bias, then
    # an in-place ReLU, bf16 channels_last
    lib_in = [(x, [(wt.contiguous(), b.to(x.dtype))
                   for wt, b in zip(unpack_weights(p), bs)])
              for x, p, bs in calls]

    def library(inputs):
        for x, layers in inputs:
            for wt, b in layers:
                x = F.conv2d(x, wt, b, padding=1).relu_()

    ms = cuda_ms(lambda: [conv3x3_chain(*a) for a in calls], 5)
    plain_ms = cuda_ms(lambda: [conv3x3_chain_plain(*a) for a in calls], 5)
    lib_ms = cuda_ms(lambda: library(lib_in), 5)
    p3 = calls[0]
    p3_ms = cuda_ms(lambda: conv3x3_chain(*p3), 10)
    p3_bound, _ = tower_bound_ms([p3])
    bound, bound_by = tower_bound_ms(calls)
    # the head runs cls then box at each level: calls[0::2] is one subnet
    levels = [{"shape": list(a[0].shape),
               "ms": cuda_ms(lambda: conv3x3_chain(*a), 10),
               "bound_ms": tower_bound_ms([a])[0],
               "library_ms": cuda_ms(lambda: library([li]), 10)}
              for a, li in zip(calls[0::2], lib_in[0::2])]
    print(f"tower on the retinanet main path: {len(calls)} calls, kernel "
          f"{ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.4f} ms, cuDNN conv+bias+relu_ {lib_ms:.4f} ms; the P3 "
          f"call {tuple(p3[0].shape)} alone {p3_ms:.4f} ms (bound "
          f"{p3_bound:.4f} ms); max-scaled |d| {err:.3g}, bit-reproducible; "
          f"one subnet by level (kernel / bound / cuDNN ms): "
          + ", ".join(f"{lv['shape'][2]}x{lv['shape'][3]} {lv['ms']:.4f} / "
                      f"{lv['bound_ms']:.4f} / {lv['library_ms']:.4f}"
                      for lv in levels), flush=True)
    return {
        "name": "conv3x3_chain", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/tower.cu",
        "replaces": "mydetection_tpu/ops/pallas/tower_kernel.py:46",
        "launches": captured["launches"]["conv3x3_chain"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib_ms,
        "p3_ms": p3_ms, "p3_bound_ms": p3_bound, "levels": levels,
        "note": "times sum the 10 calls of one retinanet-608 batch-32 bf16 "
                "forward (4 layers each); levels are one subnet's five "
                "calls, P3 to P7; max_abs_err is max-scaled against the "
                "plain version; library_ms is per layer F.conv2d with its "
                "bias on cuDNN then relu_",
    }


def gather_bound_ms(src: torch.Tensor, sel: torch.Tensor) -> tuple[float, str]:
    """Least time for the gather: each selected row read once and written
    once, the indices read once, over HBM rate (no arithmetic)."""
    b, k = sel.shape
    nbytes = 2 * b * k * src.shape[-1] * src.element_size() \
        + sel.numel() * sel.element_size()
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def gather_row(captured: dict) -> dict:
    """The row gather at the retinanet main path's own inputs."""
    from mydetection_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
    from mydetection_tpu_torch.ops.nms import _rows

    src, sel = captured["gather"]
    got = gather_rows(src, sel)
    if not torch.equal(got, gather_rows_plain(src, sel)):
        raise AssertionError("gather_rows differs from plain on the main "
                             "path's inputs")
    bound, bound_by = gather_bound_ms(src, sel)
    row = {
        "name": "gather_rows", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gather.cu",
        "replaces": "benchmarks/gather_experiments.py:69",
        "launches": captured["launches"]["gather_rows"], "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: gather_rows(src, sel), 50),
        "plain_ms": cuda_ms(lambda: gather_rows_plain(src, sel), 50),
        "bound_ms": bound, "bound_by": bound_by,
        "library_ms": cuda_ms(lambda: _rows(src, sel), 50),
        "note": "the class-logit rows of the stage-1 boxes of one "
                "retinanet-608 batch-32 bf16 postprocess; library_ms is "
                "torch.gather through ops/nms.py::_rows",
    }
    print(f"gather on the retinanet main path: {tuple(src.shape)} "
          f"{src.dtype} by {tuple(sel.shape)} {sel.dtype}, bit-equal; kernel "
          f"{row['ms']:.4f} ms (bound {bound:.5f} ms by {bound_by}), plain "
          f"{row['plain_ms']:.4f} ms, torch.gather {row['library_ms']:.4f} ms",
          flush=True)
    return row


def bottleneck_bound_ms(calls) -> tuple[float, str]:
    """Least time for these fused_bottleneck calls (args x, folded):
    2·B·H·W·(c_in·c_mid + 9·c_mid² + c_mid·c_out [+ c_in·c_out]) a block
    over the tensor rate of x's dtype (bf16, else fp32), against x read
    and the output written once, the folded weights and biases read
    once, over HBM rate."""
    ops = nbytes = 0
    for x, f in calls:
        b, c_in, h, w = x.shape
        c_mid, c_out = f[0].shape[1], f[4].shape[1]
        k = c_in * c_mid + 9 * c_mid * c_mid + c_mid * c_out
        if f[6] is not None:
            k += c_in * c_out
        ops += 2 * b * h * w * k
        nbytes += (x.numel() + b * h * w * c_out) * x.element_size() + sum(
            t.numel() * t.element_size() for t in f if t is not None)
    rate = BF16_OPS_PER_S if calls[0][0].dtype == torch.bfloat16 \
        else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def bottleneck_row(captured: dict) -> dict:
    """The fused bottleneck at a main path's own inputs: the 6 calls of
    one forward, summed, and the largest call alone; the library
    yardstick is the same blocks unfused on cuDNN (conv, BN, ReLU, the
    shortcut, the add, in bf16)."""
    from mydetection_tpu_torch.kernels.bottleneck import (
        fused_bottleneck,
        fused_bottleneck_plain,
    )

    calls, blocks = captured["bottleneck"], captured["blocks"]
    err = 0.0
    for x, f in calls:
        got, again = fused_bottleneck(x, *f), fused_bottleneck(x, *f)
        e, ok = bottleneck_error(got, fused_bottleneck_plain(x, *f))
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"fused_bottleneck outside its gate of "
                                 f"plain, or not bit-reproducible, on the "
                                 f"main path's {tuple(x.shape)} input: "
                                 f"{e:.3g}")
        err = max(err, e)
    ms = cuda_ms(lambda: [fused_bottleneck(x, *f) for x, f in calls], 5)
    each = [cuda_ms(lambda: fused_bottleneck(x, *f), 10) for x, f in calls]
    plain_ms = cuda_ms(lambda: [fused_bottleneck_plain(x, *f)
                                for x, f in calls], 3)
    lib_ms = cuda_ms(lambda: [blk.unfused(x) for blk, (x, _)
                              in zip(blocks, calls)], 5)
    big = int(np.argmax(each))
    big_bound, _ = bottleneck_bound_ms([calls[big]])
    bound, bound_by = bottleneck_bound_ms(calls)
    per_call = [{"shape": list(x.shape) + [f[4].shape[1], f[0].shape[1]],
                 "ms": t, "bound_ms": bottleneck_bound_ms([(x, f)])[0],
                 "library_ms": cuda_ms(lambda: blk.unfused(x), 10)}
                for (x, f), t, blk in zip(calls, each, blocks)]
    print(f"bottleneck on the retinanet main path: {len(calls)} calls, "
          f"kernel {ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), "
          f"the largest {each[big]:.4f} ms (bound {big_bound:.4f}), plain "
          f"{plain_ms:.4f} ms, cuDNN unfused blocks {lib_ms:.4f} ms; "
          f"max-scaled |d| {err:.3g}, bit-reproducible; by call ((B, c_in, "
          f"H, W) -> c_out, c_mid: kernel / bound / cuDNN ms): "
          + ", ".join(f"{tuple(c['shape'][:4])} -> {c['shape'][4]}, "
                      f"{c['shape'][5]}: {c['ms']:.4f} / {c['bound_ms']:.4f} "
                      f"/ {c['library_ms']:.4f}" for c in per_call),
          flush=True)
    return {
        "name": "fused_bottleneck", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/bottleneck.cu",
        "replaces": "benchmarks/resnet_stage_experiments.py:76",
        "launches": captured["launches"]["fused_bottleneck"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "largest_ms": each[big], "largest_bound_ms": big_bound,
        "calls": per_call,
        "note": "times sum the 6 calls of one retinanet-608 batch-32 bf16 "
                "forward (stage 0 and stage 1's blocks 1-3); calls are the "
                "six alone, shape (B, c_in, H, W, c_out, c_mid); "
                "max_abs_err is max-scaled against the plain version; "
                "library_ms is the same blocks unfused on cuDNN (conv, BN, "
                "ReLU, shortcut, add)",
    }


def train_step_gn_inputs(step, data, lr: float) -> dict:
    """Run one train step with the FCOS towers' `BiasGNReLU` swapped for
    a subclass that records what reaches the two trainable GN kernels:
    {"fwd": [(x, bias, scale, shift)] * 40, "bwd": [(x, y, dy, bias,
    scale, mean, inv)] * 40}, dy as autograd handed it over."""
    from mydetection_tpu_torch.kernels.gn import BiasGNReLU
    from mydetection_tpu_torch.models import fcos as fcos_mod

    captured = {"fwd": [], "bwd": []}

    class Recording(BiasGNReLU):
        @staticmethod
        def forward(ctx, x, bias, scale, shift, groups):
            captured["fwd"].append((x, bias, scale, shift))
            return BiasGNReLU.forward(ctx, x, bias, scale, shift, groups)

        @staticmethod
        def backward(ctx, dy):
            x, y, *rest = ctx.saved_tensors
            captured["bwd"].append((x, y, dy, *rest))
            return BiasGNReLU.backward(ctx, dy)

    fcos_mod.BiasGNReLU = Recording
    try:
        step(*data, lr)
    finally:
        fcos_mod.BiasGNReLU = BiasGNReLU
    return captured


def train_main(name: str, size: int, batch: int, smi: str,
               kernel_launches: dict) -> tuple:
    """One train main path: `name` at full width and depth, bf16, `size`²
    at `batch`, `make_train_step` with `burn_in_lr`, on a synthetic
    batch. Every step's launch counts are reset just before it and read
    just after, and must be `kernel_launches` (every other kernel none);
    TRAIN_WARMUP steps, then TRAIN_TIMED timed ones, each split by CUDA
    events into host (the batch to the card), forward, backward and
    optimizer; peak memory over the timed steps. Prints the line and
    returns (step, data, launches of the last step)."""
    from mydetection_tpu_torch import kernels
    from mydetection_tpu_torch.models.layers import init_weights
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import burn_in_lr, make_train_step

    model = get_model(name, input_size=size)            # bf16, all classes
    init_weights(model, 0)
    step = make_train_step(model, input_size=size)
    data = train_batch(2, batch, size, model.config.num_classes,
                       rotated=model.config.rotated)
    want = {fn.__name__: 0 for fn in kernels.KERNELS}
    want.update(kernel_launches)
    lat, dev, totals = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        lr = burn_in_lr(i + 1, base_lr=0.01)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        ev[0].record()
        args = step.batch(*data)
        ev[1].record()
        terms = step.forward(*args)
        ev[2].record()
        grads = step.backward(terms)
        ev[3].record()
        step.update(grads, lr)
        ev[4].record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        if launches != want:
            raise AssertionError(f"{name} train step {i} launched "
                                 f"{launches}, expected {want}")
        vals = {k: float(v.detach()) for k, v in terms.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{name} train step {i} loss terms {vals}")
        totals.append(vals["total"])
        if i >= TRAIN_WARMUP:
            lat.append(t1 - t0)
            dev.append([ev[j].elapsed_time(ev[j + 1]) for j in range(4)])
        del args, terms, grads
    peak = torch.cuda.max_memory_allocated()
    clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
    med = float(np.median(lat))
    split = np.median(np.array(dev), axis=0)
    ran = {k: v for k, v in launches.items() if v}
    print(f"train main: {name}-{size} bf16 batch {batch}, make_train_step "
          f"with burn_in_lr, {TRAIN_WARMUP} warm-up + {TRAIN_TIMED} timed "
          f"steps, kernel launches per step {ran or 'none'}, losses finite "
          f"(total {[round(v, 4) for v in totals]}); step latency median "
          f"{med * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max "
          f"{max(lat) * 1e3:.2f}), {batch / med:.1f} img/s; device "
          f"(medians) host {split[0]:.2f} ms, forward {split[1]:.2f} ms, "
          f"backward {split[2]:.2f} ms, optimizer {split[3]:.2f} ms; peak "
          f"memory allocated {peak / 2**30:.2f} GiB; on {smi} (sm clock, "
          f"power, temp after: {clocks})", flush=True)
    return step, data, launches


def phase_train_main(smi: str) -> dict:
    """The fcos-608 train main path at batch TRAIN_BATCH (the GN
    forward-with-statistics and backward kernels 40 each a step), then
    one more step that captures both kernels' inputs. Returns the
    capture, {"fwd": [...], "bwd": [...], "launches"}."""
    from mydetection_tpu_torch.training import burn_in_lr

    step, data, launches = train_main(
        "fcos", 608, TRAIN_BATCH, smi,
        {"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40})
    captured = train_step_gn_inputs(
        step, data, burn_in_lr(TRAIN_WARMUP + TRAIN_TIMED + 1, base_lr=0.01))
    captured["launches"] = launches
    return captured


@torch.no_grad()
def gn_fwd_stats_row(captured: dict) -> dict:
    """The forward-with-statistics kernel at the train main path's own
    inputs: the 40 calls of one step, summed."""
    import torch.nn.functional as F

    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_fwd_stats,
        bias_gn_relu_fwd_stats_plain,
    )

    calls = captured["fwd"]
    err = 0.0
    for args in calls:
        got = bias_gn_relu_fwd_stats(*args, groups=GN_GROUPS)
        ref = bias_gn_relu_fwd_stats_plain(*args, groups=GN_GROUPS)
        e, ok = gn_error(got[0], ref[0])
        stats = max(max_scaled(a, b) for a, b in zip(got[1:], ref[1:]))
        if not ok or stats > GN_F32_GATE:
            raise AssertionError(f"bias_gn_relu_fwd_stats outside its gates "
                                 f"on the train path's {tuple(args[0].shape)} "
                                 f"input: y {e:.3g}, mean/inv {stats:.3g}")
        err = max(err, e)
    lib_in = [(x + b.to(x.dtype)[:, None, None], s.to(x.dtype), t.to(x.dtype))
              for x, b, s, t in calls]
    ms = cuda_ms(lambda: [bias_gn_relu_fwd_stats(*a, groups=GN_GROUPS)
                          for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_fwd_stats_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [F.group_norm(x, GN_GROUPS, s, t, 1e-5)
                              for x, s, t in lib_in], 5)
    bound, bound_by = gn_bound_ms(calls, stats=True)
    print(f"gn fwd_stats on the train main path: {len(calls)} calls, kernel "
          f"{ms:.4f} ms summed (bound {bound:.4f} ms by {bound_by}), plain "
          f"{plain_ms:.3f} ms, F.group_norm {lib_ms:.4f} ms", flush=True)
    return {
        "name": "bias_gn_relu_fwd_stats", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:141",
        "launches": captured["launches"]["bias_gn_relu_fwd_stats"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "note": "times sum the 40 calls of one fcos-608 batch-16 bf16 train "
                "step; library_ms is F.group_norm on x + bias, which leaves "
                "out the bias add, the ReLU and the saved statistics",
    }


@torch.no_grad()
def gn_bwd_row(captured: dict) -> dict:
    """The fused backward kernel at the train main path's own inputs:
    the 40 calls of one step, summed."""
    from mydetection_tpu_torch.kernels.gn import (
        bias_gn_relu_bwd,
        bias_gn_relu_bwd_plain,
    )

    calls = captured["bwd"]
    err = 0.0
    layouts = {"channels_last": 0, "nchw": 0, "other": 0}
    for args in calls:
        dy = args[2]
        layouts["channels_last" if dy.is_contiguous(
            memory_format=torch.channels_last) else
            "nchw" if dy.is_contiguous() else "other"] += 1
        got = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
        again = bias_gn_relu_bwd(*args, groups=GN_GROUPS)
        ref = bias_gn_relu_bwd_plain(*args, groups=GN_GROUPS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("bias_gn_relu_bwd is not bit-reproducible on "
                                 "the train path's inputs")
        for a, b in zip(got, ref):
            e, ok = gn_train_error(a, b)
            if not ok:
                raise AssertionError(f"bias_gn_relu_bwd outside its gate on "
                                     f"the train path's {tuple(args[0].shape)} "
                                     f"input: {e:.3g}")
            err = max(err, e)
    # the library yardstick: aten's GroupNorm backward on contiguous NCHW
    # x + bias with its own statistics (no ReLU mask, no bias gradient)
    lib = []
    for x, _, dy, bias, scale, _, _ in calls:
        b, c, h, w = x.shape
        xb = (x + bias.to(x.dtype)[:, None, None]).contiguous()
        wt = scale.to(x.dtype)
        _, mean, rstd = torch.ops.aten.native_group_norm(
            xb, wt, None, b, c, h * w, GN_GROUPS, 1e-5)
        lib.append((dy.contiguous(), xb, mean, rstd, wt, b, c, h * w))
    ms = cuda_ms(lambda: [bias_gn_relu_bwd(*a, groups=GN_GROUPS)
                          for a in calls], 5)
    plain_ms = cuda_ms(lambda: [bias_gn_relu_bwd_plain(*a, groups=GN_GROUPS)
                                for a in calls], 3)
    lib_ms = cuda_ms(lambda: [torch.ops.aten.native_group_norm_backward(
        dy, xb, mean, rstd, wt, b, c, hw, GN_GROUPS, [True, True, True])
        for dy, xb, mean, rstd, wt, b, c, hw in lib], 5)
    bound, bound_by = gn_bound_ms(calls, backward=True)

    def aten(i):
        dy, xb, mean, rstd, wt, b, c, hw = lib[i]
        return torch.ops.aten.native_group_norm_backward(
            dy, xb, mean, rstd, wt, b, c, hw, GN_GROUPS, [True, True, True])

    levels = gn_levels(
        calls, "bwd", lambda a: bias_gn_relu_bwd(*a, groups=GN_GROUPS),
        lambda a: gn_bound_ms([a], backward=True)[0], aten)
    print(f"gn bwd on the train main path: {len(calls)} calls (dy layouts "
          f"{layouts}), kernel {ms:.4f} ms summed "
          f"(bound {bound:.4f} ms by {bound_by}), plain {plain_ms:.3f} ms, "
          f"aten native_group_norm_backward {lib_ms:.4f} ms; bit-reproducible, "
          f"max-scaled |d| {err:.3g}; one call a level (kernel / bound / "
          f"aten ms): {level_text(levels)}", flush=True)
    return {
        "name": "bias_gn_relu_bwd", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/gn.cu",
        "replaces": "mydetection_tpu/ops/pallas/gn_kernel.py:149",
        "launches": captured["launches"]["bias_gn_relu_bwd"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms,
        "levels": levels, "dy_layouts": layouts,
        "note": "times sum the 40 calls of one fcos-608 batch-16 bf16 train "
                "step, each call's two launches (the kernel and the sum of "
                "its channel partials) and any copy of an NCHW dy; levels "
                "time one call of each level; max_abs_err is max-scaled "
                "over dx, dbias, dscale, dshift; the resident design reads "
                "x, y and dy once and x again, the bound each once; "
                "library_ms is aten.native_group_norm_backward on "
                "contiguous x + bias, which leaves out the ReLU mask and "
                "the bias gradient",
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from mydetection_tpu_torch.kernels import build

    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "smem" in ln]
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s; {' | '.join(ptxas)}", flush=True)
    phase_kernel(np.random.RandomState(0))
    phase_gn()
    phase_gn_train()
    phase_rotated(np.random.RandomState(0))
    phase_tower()
    phase_bottleneck()
    phase_gather(np.random.RandomState(0))
    phase_parity()
    phase_parity_bf16()
    phase_train_parity()
    yolo = drive_main("yolov3", 416, 0.25, smi, {"nms_keep": 1})
    rows = [nms_row(yolo, "yolov3")]
    del yolo
    fcos = drive_main("fcos", 608, 0.005, smi,
                      {"nms_keep": 1, "bias_gn_relu": 40, "gather_rows": 1,
                       "fused_bottleneck": 6}, capture_gn=True)
    rows.append(gn_row(fcos))
    nms_row(fcos, "fcos")
    del fcos
    rapid = drive_main("rapid", 1024, 0.3, smi, {"nms_from_iou_keep": 1})
    rows.append(rotated_row(rapid))
    del rapid
    retina_launches = {"nms_keep": 1, "conv3x3_chain": 10, "gather_rows": 1,
                       "fused_bottleneck": 6}
    retina = drive_main("retinanet", 608, 0.005, smi, retina_launches)
    rows += [tower_row(retina), gather_row(retina), bottleneck_row(retina)]
    nms_row(retina, "retinanet")
    del retina
    drive_main("retinanet_r101", 608, 0.005, smi, retina_launches)
    train = phase_train_main(smi)
    rows += [gn_fwd_stats_row(train), gn_bwd_row(train)]
    del train
    for name, size, batch in TRAIN_MAINS:   # no kernel runs on these
        train_main(name, size, batch, smi, {})
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
