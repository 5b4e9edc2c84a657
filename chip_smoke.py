"""Smoke run of the PyTorch port (`mydetection_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. device   the card (nvidia-smi name, power limit), torch and CUDA;
  2. build    nvcc for every kernel source, all started at once;
  3. kernel   the CUDA NMS keep-mask bit-equal to its plain version on
              B=32, K=1024 hard cases (duplicates, tied scores, pairs
              within 1 ulp of iou_thres, an all-padding image, mixed
              classes through the float32 class offset);
  4. parity   Detector("yolov3", 416, float32, TF32 off) on the card
              against the same seeded weights on the CPU, on a
              procedural 416² canvas;
  5. main     the main path once: bf16 `detect_prepared` on 32 canvases,
              with the kernel launch counts reset just before and read
              just after; then the batch's latency and img/s.

Then one JSON line per kernel table, the card's name and power limit,
and the result line `{"ok": true, "device": {...}}`. Needs no network
and runs in a few minutes, the kernel build included.
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
OPS_PER_IOU = 12    # min/max x4, sub x2, clamp x2, mul, add, sub, div
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores


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
            pairs = near_threshold_pairs(rng, k // 2, thr,
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


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn()` over `iters` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def nms_bound_ms(boxes: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> tuple[float, str]:
    """Least time for the keep-mask of these inputs: bytes (boxes and
    valid read once, keep written once) over HBM rate, against the IoUs
    greedy needs here (each valid box against the kept boxes before it,
    up to its first suppressor) over the fp32 rate."""
    from mydetection_tpu_torch.ops.boxes import pairwise_iou

    b, k, _ = boxes.shape
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel()
    kept = keep.long()
    rank = torch.cumsum(kept, dim=1)                       # kept at <= i
    iou = pairwise_iou(boxes, boxes)
    sup = ((iou > np.float32(IOU_THRES)) & keep[:, :, None]
           & torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1))
    has_sup = sup.any(dim=1)                               # (B, K) over j
    first = sup.to(torch.uint8).argmax(dim=1)              # first suppressor
    tested = torch.where(has_sup, torch.gather(rank, 1, first), rank - kept)
    pairs = int((tested * valid.long()).sum())
    ops = pairs * OPS_PER_IOU + 3 * b * k                  # + the areas
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def smi_line(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel(rng) -> None:
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain

    boxes_np, valid_np = nms_cases(rng, BATCH, PRE_NMS)
    boxes = torch.from_numpy(boxes_np).cuda()
    valid = torch.from_numpy(valid_np).cuda()
    keep = nms_keep(boxes, valid, IOU_THRES)
    plain = nms_keep_plain(boxes, valid, IOU_THRES)
    torch.cuda.synchronize()
    diff = int((keep != plain).sum())
    if diff:
        bad = sorted({int(i) for i in (keep != plain).nonzero()[:, 0]})
        raise AssertionError(f"kernel keep-mask differs from the plain "
                             f"version in {diff} entries (images {bad})")
    if keep[4].any() or not keep.any():
        raise AssertionError("all-padding image kept a box, or none kept")
    print(f"kernel: nms_keep bit-equal to plain on B={BATCH} K={PRE_NMS} "
          f"hard cases ({int(keep.sum())} kept of {int(valid.sum())} valid); "
          f"kernel {cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)):.4f} ms, "
          f"plain {cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 3):.3f} ms",
          flush=True)


def phase_parity() -> None:
    from mydetection_tpu_torch import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from mydetection_tpu_torch.kernels.nms import nms_keep

    canvas, info = padded_canvas(golden_image(), 416, 8, 58)
    kw = dict(input_size=416, compute_dtype=torch.float32, rng_seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        det = Detector("yolov3", device=device, **kw)
        before = nms_keep.launches
        runs[device] = det.detect_prepared(canvas[None], [info],
                                           conf_thres=0.25, nms_iou=IOU_THRES)[0]
        launched = nms_keep.launches - before
    cpu, gpu = runs["cpu"], runs["cuda"]
    if launched != 1:
        raise AssertionError(f"CUDA detect launched the NMS kernel "
                             f"{launched} times, expected 1")
    if len(gpu) != len(cpu) or not np.array_equal(gpu.classes, cpu.classes):
        raise AssertionError(f"cuda/cpu detections differ: {len(gpu)} vs "
                             f"{len(cpu)} boxes, classes "
                             f"{gpu.classes[:10]} vs {cpu.classes[:10]}")
    if len(cpu) == 0:
        raise AssertionError("parity canvas produced no detections")
    ds = float(np.abs(gpu.scores - cpu.scores).max())
    db = float(np.abs(gpu.boxes_xyxy - cpu.boxes_xyxy).max())
    if ds > 1e-4 or db > 1e-2:
        raise AssertionError(f"cuda/cpu max |d score| {ds:.3g} (gate 1e-4), "
                             f"max |d box| {db:.3g} px (gate 1e-2)")
    print(f"parity: yolov3-416 f32 (TF32 off) cuda == cpu on {len(cpu)} "
          f"detections, max |d score| {ds:.3g}, max |d box| {db:.3g} px",
          flush=True)


def phase_main(smi: str) -> dict:
    """The main path once with fresh launch counts, then its timing.
    Returns the NMS kernel's table row."""
    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch import kernels
    from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain
    from mydetection_tpu_torch.ops import nms as ops_nms
    from mydetection_tpu_torch.registry import forward_dense

    det = Detector("yolov3", input_size=416, rng_seed=0)  # cuda, bf16
    rng = np.random.RandomState(1)
    img = golden_image()
    canvases, infos = [], []
    for _ in range(BATCH):
        noisy = np.clip(img.astype(np.int16) + rng.randint(-20, 21, img.shape),
                        0, 255).astype(np.uint8)
        c, i = padded_canvas(noisy, 416, rng.randint(0, 17), rng.randint(0, 117))
        canvases.append(c)
        infos.append(i)
    canvases = np.stack(canvases)
    det.warmup(batch_size=BATCH)

    captured = {}

    def capture(boxes, valid, thr):
        captured.update(boxes=boxes, valid=valid)
        return nms_keep(boxes, valid, thr)

    ops_nms.nms_keep = capture
    try:
        kernels.reset_launches()
        dets = det.detect_prepared(canvases, infos, conf_thres=0.25,
                                   nms_iou=IOU_THRES)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    finally:
        ops_nms.nms_keep = nms_keep
    if launches["nms_keep"] < 1:
        raise AssertionError(f"main path launched no NMS kernel: {launches}")
    for d, info in zip(dets, infos):
        s = d.scores
        if not (np.isfinite(s).all() and np.isfinite(d.boxes_xyxy).all()):
            raise AssertionError("non-finite detections")
        if len(s) > 1 and (np.diff(s) > 0).any():
            raise AssertionError("scores are not descending")
        bx = d.boxes_xyxy
        if len(bx) and ((bx < 0).any() or (bx[:, 0::2] > info.ori_w).any()
                        or (bx[:, 1::2] > info.ori_h).any()):
            raise AssertionError("a box lies outside its image")

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        det.detect_prepared(canvases, infos, conf_thres=0.25,
                            nms_iou=IOU_THRES)
        times.append(time.perf_counter() - t0)
    clocks = smi_line("clocks.sm,power.draw,temperature.gpu")
    lat = float(np.median(times))
    # device time of the two halves of the batch, by CUDA events
    images = torch.from_numpy(canvases).cuda()
    conf = torch.full((BATCH,), 0.25, device="cuda")
    with torch.inference_mode():
        dense = forward_dense(det.model, images)
        fwd_ms = cuda_ms(lambda: forward_dense(det.model, images), 5)
        post_ms = cuda_ms(lambda: det._post(dense, conf, IOU_THRES), 5)
    print(f"main: yolov3-416 bf16 detect_prepared batch {BATCH}: "
          f"{len(dets)} images, {sum(len(d) for d in dets)} detections, "
          f"nms launches {launches['nms_keep']}; median batch latency "
          f"{lat * 1e3:.2f} ms (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {BATCH / lat:.1f} img/s; device: "
          f"forward_dense {fwd_ms:.2f} ms, postprocess {post_ms:.2f} ms; "
          f"on {smi} (sm clock, power, temp after: {clocks})", flush=True)

    boxes, valid = captured["boxes"], captured["valid"]
    keep = nms_keep(boxes, valid, IOU_THRES)
    plain = nms_keep_plain(boxes, valid, IOU_THRES)
    err = float((keep.float() - plain.float()).abs().max())
    if err:
        raise AssertionError("kernel and plain keep-masks differ on the "
                             "main path's NMS inputs")
    bound, bound_by = nms_bound_ms(boxes, valid, keep)
    return {
        "name": "nms_keep", "route": "cuda",
        "source": "mydetection_tpu_torch/kernels/csrc/nms.cu",
        "replaces": "mydetection_tpu/ops/pallas/nms_kernel.py:38",
        "launches": launches["nms_keep"], "max_abs_err": err,
        "ms": cuda_ms(lambda: nms_keep(boxes, valid, IOU_THRES)),
        "plain_ms": cuda_ms(lambda: nms_keep_plain(boxes, valid, IOU_THRES), 3),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
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
    phase_parity()
    row = phase_main(smi)
    print(json.dumps({"kernels": [row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
