"""Rotated-box AP evaluator for fisheye person datasets.

A port of `mydetection_tpu/eval/rotated_eval.py`: the custom evaluator
of the reference for the rotated-person datasets (CEPDOF / MW-R /
HABBOF), reporting AP at IoU 0.5 (the RAPiD paper's headline metric)
with rotated-IoU matching.

Matching uses the port's analytic rotated IoU
(`mydetection_tpu_torch.ops.rotated`) in float32 on the CPU; the greedy
assignment and PR accumulation mirror the COCO protocol (score-ranked,
one GT per detection, 101-point interpolated AP). The JAX package pads
each image's boxes to power-of-two buckets to bound its jit compiles;
eager tensor ops need no padding, and padding rows never match, so the
matches are the same.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict

import numpy as np
import torch

from mydetection_tpu_torch.ops.rotated import (
    pairwise_rotated_iou,
    rotated_intersection_area_lb,
)

REC_THRS = np.linspace(0.0, 1.0, 101)


def _rotated_iou_matrix(dets5: np.ndarray, gts5: np.ndarray) -> np.ndarray:
    """(D, 5) × (G, 5) cxcywhθ(rad) float32 → (D, G) rotated IoU."""
    if len(dets5) == 0 or len(gts5) == 0:
        return np.zeros((len(dets5), len(gts5)), np.float32)
    return pairwise_rotated_iou(torch.from_numpy(dets5),
                                torch.from_numpy(gts5)).numpy()


def _rotated_iof_matrix(dets5: np.ndarray, crowds5: np.ndarray) -> np.ndarray:
    """Intersection-over-foreground (det area) vs crowd regions — the
    pycocotools iscrowd semantics: a det counts as covered by a crowd
    when most of the DET lies inside it, regardless of the crowd's own
    (large) area."""
    if len(dets5) == 0 or len(crowds5) == 0:
        return np.zeros((len(dets5), len(crowds5)), np.float32)
    d, c = len(dets5), len(crowds5)
    inter = rotated_intersection_area_lb(
        torch.from_numpy(dets5)[:, None, :],
        torch.from_numpy(crowds5)[None, :, :]).numpy()
    areas = np.maximum(dets5[:, 2] * dets5[:, 3], 1e-9)
    return (inter / areas[:, None]).astype(np.float32).reshape(d, c)


def evaluate_rotated(results: list[dict] | str, gt: dict | str, *,
                     iou_thrs: tuple[float, ...] = (0.5, 0.75),
                     verbose: bool = True) -> dict:
    """AP for rotated detections.

    results rows: {image_id, bbox [cx, cy, w, h, degrees], score}.
    gt: COCO-style dict/path whose annotations carry the same rotated
    bbox format (single category assumed — person).
    Returns {"AP50": ..., "AP75": ..., "AP": mean over iou_thrs}.
    """
    if isinstance(results, str):
        with open(results) as fh:
            results = json.load(fh)
    if isinstance(gt, str):
        with open(gt) as fh:
            gt = json.load(fh)

    gts_by_img: dict[int, list] = defaultdict(list)
    crowds_by_img: dict[int, list] = defaultdict(list)
    for ann in gt.get("annotations", []):
        # crowd/ignore regions: never counted as GT, but detections
        # covered by one are excluded from scoring (COCO protocol,
        # mirroring eval/cocoeval.py) instead of becoming FPs
        if ann.get("iscrowd", 0):
            crowds_by_img[ann["image_id"]].append(ann["bbox"])
            continue
        gts_by_img[ann["image_id"]].append(ann["bbox"])
    img_ids = sorted({im["id"] for im in gt.get("images", [])})
    # count only GTs on evaluated images — annotations referencing
    # image_ids absent from gt["images"] can never be matched and would
    # silently deflate recall/AP
    num_gt = sum(len(gts_by_img.get(i, ())) for i in img_ids)

    dets_by_img: dict[int, list] = defaultdict(list)
    for r in results:
        dets_by_img[r["image_id"]].append((float(r["score"]), r["bbox"]))

    # per-image IoU (vs GT) + IoF (vs crowd) matrices, score-sorted dets
    per_img = {}
    for img_id in img_ids:
        dets = sorted(dets_by_img.get(img_id, []), key=lambda x: -x[0])
        gts = gts_by_img.get(img_id, [])
        crowds = crowds_by_img.get(img_id, [])
        d5 = np.asarray([d[1] for d in dets], np.float32).reshape(-1, 5)
        g5 = np.asarray(gts, np.float32).reshape(-1, 5)
        c5 = np.asarray(crowds, np.float32).reshape(-1, 5)
        for arr in (d5, g5, c5):
            if len(arr):
                arr[:, 4] = np.radians(arr[:, 4])
        per_img[img_id] = (np.asarray([d[0] for d in dets], np.float32),
                           _rotated_iou_matrix(d5, g5),
                           _rotated_iof_matrix(d5, c5))

    out = {}
    aps = []
    for thr in iou_thrs:
        scores_all, tp_all = [], []
        for img_id in img_ids:
            scores, iou, iof = per_img[img_id]
            g = iou.shape[1]
            taken = np.zeros(g, bool)
            for di in range(len(scores)):
                best, best_g = thr, -1
                for gi in range(g):
                    if not taken[gi] and iou[di, gi] >= best:
                        best, best_g = iou[di, gi], gi
                tp = best_g >= 0
                if tp:
                    taken[best_g] = True
                elif iof.shape[1] and iof[di].max() >= thr:
                    # unmatched det covered by a crowd region: ignored
                    # (neither TP nor FP), per the COCO crowd protocol
                    continue
                scores_all.append(scores[di])
                tp_all.append(tp)
        if not scores_all or num_gt == 0:
            ap = 0.0
        else:
            order = np.argsort(-np.asarray(scores_all), kind="mergesort")
            tp = np.asarray(tp_all)[order]
            tp_cum = np.cumsum(tp)
            fp_cum = np.cumsum(~tp)
            rc = tp_cum / num_gt
            pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, REC_THRS, side="left")
            q = np.where(inds < len(pr), pr[np.minimum(inds, len(pr) - 1)], 0.0)
            ap = float(np.mean(q))
        out[f"AP{int(thr * 100)}"] = ap
        aps.append(ap)
    out["AP"] = float(np.mean(aps))
    if verbose:
        print(" ".join(f"{k}={v:.4f}" for k, v in out.items()))
    return out


def evaluate_rotated_detector(detector, ann_file: str | dict, img_dir: str, *,
                              conf_thres: float = 0.3, nms_iou: float = 0.45,
                              batch_size: int = 16,
                              input_size: int | None = None,
                              max_images: int | None = None,
                              num_threads: int = 4,
                              results_path: str | None = None,
                              verbose: bool = True) -> dict:
    """Run a rotated Detector over a fisheye dataset and score it.

    `results_path` dumps the detection rows (cxcywhθ_deg) as JSON —
    same contract as the axis-aligned evaluator's --out.
    """
    import os

    from mydetection_tpu_torch.data.loader import StreamingPipeline

    if isinstance(ann_file, str):
        with open(ann_file) as fh:
            gt = json.load(fh)
    else:
        gt = ann_file
    imgs = gt["images"][:max_images] if max_images else gt["images"]
    paths = [os.path.join(img_dir, im.get("file_name", f"{im['id']}.jpg"))
             for im in imgs]
    ids = [im["id"] for im in imgs]
    size = input_size or detector.cfg.input_size

    results = []
    pos = 0
    t0 = time.perf_counter()
    pipe = StreamingPipeline(paths, input_size=size, batch_size=batch_size,
                             num_threads=num_threads, device=detector.device)
    for canvases, infos, _ in pipe:
        dets = detector.detect_prepared(canvases, infos,
                                        conf_thres=conf_thres,
                                        nms_iou=nms_iou)
        for d in dets:
            rot = d.boxes_rot
            for k in range(len(d)):
                cx, cy, w, h, th = (float(v) for v in rot[k])
                results.append({"image_id": ids[pos],
                                "bbox": [cx, cy, w, h, float(np.degrees(th))],
                                "score": float(d.scores[k])})
            pos += 1
    dt = time.perf_counter() - t0
    if verbose:
        print(f"inference: {len(paths)} images in {dt:.3f}s "
              f"({len(paths) / max(dt, 1e-9):.1f} img/s), "
              f"{len(results)} detections")
    if results_path:
        with open(results_path, "w") as fh:
            json.dump(results, fh)
    ids_set = set(ids)
    sub_gt = {"images": imgs,
              "annotations": [a for a in gt.get("annotations", [])
                              if a["image_id"] in ids_set]}
    t0 = time.perf_counter()
    stats = evaluate_rotated(results, sub_gt, verbose=verbose)
    if verbose:
        print(f"scoring: {time.perf_counter() - t0:.3f}s")
    return stats
