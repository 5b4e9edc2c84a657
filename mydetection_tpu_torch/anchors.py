"""Anchor derivation: IoU-distance k-means over dataset GT (w, h).

A numpy copy of `mydetection_tpu/anchors.py`, with the same CLI
(`python -m mydetection_tpu_torch.anchors --ann train.json`).

The reference inherits YOLOv3's canonical COCO anchors and RAPiD's
person anchors from the published checkpoints; when a user retrains on
their own (fisheye) dataset the anchor priors should come from THEIR
label statistics. This is the darknet `calc_anchors` idiom [recalled;
SURVEY.md §2.7b]: k-means on GT (w, h) pairs with distance
d(box, centroid) = 1 − IoU_wh(box, centroid), where IoU_wh aligns both
boxes at the origin (pure shape/scale similarity, position-free).

Usage:
    wh = collect_wh(dataset)                       # (N, 2) pixels
    table = anchor_table(wh)                       # ((3×(w,h)),)*3
    model = get_model("rapid", anchors=table)      # registry override
"""

from __future__ import annotations

import numpy as np


def iou_wh(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Origin-aligned IoU between (N, 2) boxes and (K, 2) centroids."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] \
        + (centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_anchors(wh: np.ndarray, k: int = 9, *, iters: int = 300,
                   seed: int = 0) -> np.ndarray:
    """K-means over (w, h) with 1−IoU distance. Returns (k, 2) float32
    sorted by area ascending. Fully deterministic (greedy farthest-
    point init; `seed` is accepted for API stability but unused).

    Empty clusters are re-seeded to the point currently worst-served
    (lowest best-IoU) — the standard fix that keeps k clusters alive on
    clumpy data.
    """
    wh = np.asarray(wh, np.float64).reshape(-1, 2)
    if len(wh) < k:
        raise ValueError(f"need at least k={k} boxes, got {len(wh)}")
    if (wh <= 0).any():
        raise ValueError("boxes must have positive width/height")
    # greedy farthest-point init (k-means++-style, deterministic):
    # random init routinely merges nearby true clusters into one and
    # leaves another split — observed on planted-cluster tests
    centroids = wh[int(np.argmax(wh[:, 0] * wh[:, 1]))][None].copy()
    while len(centroids) < k:
        d = 1.0 - np.max(iou_wh(wh, centroids), axis=1)
        centroids = np.concatenate([centroids,
                                    wh[int(np.argmax(d))][None]])
    assign = None
    for _ in range(iters):
        ious = iou_wh(wh, centroids)                    # (N, K)
        new_assign = np.argmax(ious, axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for ki in range(k):
            members = wh[assign == ki]
            if len(members):
                # median, not mean: robust to the long tail of box sizes
                centroids[ki] = np.median(members, axis=0)
            else:
                worst = np.argmin(np.max(ious, axis=1))
                centroids[ki] = wh[worst]
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order].astype(np.float32)


def mean_best_iou(wh: np.ndarray, centroids: np.ndarray) -> float:
    """Avg best-anchor IoU — the quality score darknet prints (~0.6+
    is healthy for k=9 on COCO)."""
    return float(np.mean(np.max(iou_wh(np.asarray(wh, np.float64),
                                       np.asarray(centroids, np.float64)),
                                axis=1)))


def anchor_table(wh: np.ndarray, *, num_levels: int = 3,
                 per_level: int = 3, iters: int = 300,
                 seed: int = 0) -> tuple:
    """Dataset (w, h) pairs → the registry's anchor-table shape:
    ((per_level × (w, h)), …) with LARGEST anchors first (P5 → P3
    order, matching models.yolov3.ANCHORS / models.rapid.ANCHORS)."""
    k = num_levels * per_level
    cents = kmeans_anchors(wh, k, iters=iters, seed=seed)  # area asc
    levels = []
    for li in range(num_levels):  # largest level first
        start = k - (li + 1) * per_level
        block = cents[start:start + per_level]
        levels.append(tuple((float(w), float(h)) for w, h in block))
    return tuple(levels)


def collect_wh(dataset) -> np.ndarray:
    """Gather all GT (w, h) pairs (pixels) from a CocoDataset-style
    object (items expose boxes as cxcywh[θ] rows)."""
    out = []
    for i in range(len(dataset)):
        boxes = dataset[i]["boxes"]
        if len(boxes):
            out.append(np.asarray(boxes, np.float64)[:, 2:4])
    if not out:
        raise ValueError("dataset has no ground-truth boxes")
    return np.concatenate(out, axis=0)


def main(argv=None) -> None:
    """CLI: derive an anchor table from a dataset's GT boxes.

        python -m mydetection_tpu_torch.anchors --ann data/train.json \
            [--levels 3 --per-level 3]

    Prints the table in registry/ModelConfig format — paste it into
    `get_model(..., anchors=...)` or a Detector(...) override. Box
    (w, h) are used as stored (network-pixel convention: rotated
    fisheye sets annotate at the training resolution; for plain COCO
    sets letterbox-scale offline if the training size differs).
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ann", required=True, help="COCO-style annotation JSON")
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--per-level", type=int, default=3,
                    help="anchors per level; note the yolov3/rapid heads "
                         "consume exactly 3 levels x 3 anchors")
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args(argv)

    with open(args.ann) as fh:
        gt = json.load(fh)
    wh = np.asarray([[a["bbox"][2], a["bbox"][3]]
                     for a in gt.get("annotations", [])
                     if not a.get("iscrowd", 0)], np.float64)
    if not len(wh):
        raise SystemExit(f"no ground-truth boxes in {args.ann}")
    table = anchor_table(wh, num_levels=args.levels,
                         per_level=args.per_level, iters=args.iters)
    quality = mean_best_iou(wh, np.asarray(
        [c for lvl in table for c in lvl], np.float64))
    print(f"# {len(wh)} boxes, mean best-anchor IoU {quality:.3f}")
    if (args.levels, args.per_level) != (3, 3):
        print("# NOTE: the yolov3/rapid heads consume exactly 3 levels "
              "x 3 anchors; get_model(anchors=...) will reject this "
              "table (it is printed for analysis only)")
    print("ANCHORS = (")
    for lvl in table:
        cells = ", ".join(f"({w:.1f}, {h:.1f})" for w, h in lvl)
        print(f"    ({cells}),")
    print(")")


if __name__ == "__main__":
    main()
