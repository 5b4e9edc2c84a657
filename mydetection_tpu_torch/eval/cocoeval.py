"""COCO bbox mAP evaluation, pure numpy, pycocotools-protocol-compatible.

The reference shells out to `pycocotools.cocoeval.COCOeval` (C/Cython)
[recalled; SURVEY.md §2.14]. pycocotools is not a dependency
of this package, so the metric oracle is reimplemented here following the
published COCO evaluation protocol exactly:

  * IoU thresholds 0.50:0.05:0.95 (10), recall thresholds 0:0.01:1
    (101-point interpolation);
  * area ranges all / small(<32²) / medium(32²..96²) / large(>96²),
    maxDets 1/10/100;
  * greedy per-(image, category) matching in descending score order;
    each detection takes the not-yet-matched GT with the highest IoU
    above threshold; already-matched non-crowd GTs are skipped; crowd
    GTs may match repeatedly and use intersection/det-area "IoU";
  * ignored GTs (iscrowd or outside the area range) don't count as
    misses; detections matched to them are removed from scoring, as
    are unmatched detections outside the area range.

A verbatim copy of `mydetection_tpu/eval/cocoeval.py`. Output indices
mirror COCOeval.stats[0:12]. Validated in
tests/test_cocoeval.py on hand-built scenarios with known AP values.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)

STAT_NAMES = (
    "AP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "AR1", "AR10", "AR100", "AR_small", "AR_medium", "AR_large",
)


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """pycocotools `maskUtils.iou` semantics for xywh boxes.

    dets (D, 4), gts (G, 4) top-left xywh. For crowd GTs the
    denominator is the DET area alone (a det fully inside a crowd
    region scores 1.0). Returns (D, G).
    """
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = np.maximum(0.0, np.minimum(dx2[:, None], gx2) - np.maximum(dx1[:, None], gx1))
    iy = np.maximum(0.0, np.minimum(dy2[:, None], gy2) - np.maximum(dy1[:, None], gy1))
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = gts[:, 2] * gts[:, 3]
    union = np.where(iscrowd[None, :], d_area, d_area + g_area[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


class COCOGt:
    """Minimal COCO ground-truth container (bbox annotations)."""

    def __init__(self, gt: dict | str):
        if isinstance(gt, str):
            with open(gt) as fh:
                gt = json.load(fh)
        self.dataset = gt
        self.imgs = {im["id"]: im for im in gt.get("images", [])}
        self.cats = {c["id"]: c for c in gt.get("categories", [])}
        self.img_ids = sorted(self.imgs)
        self.cat_ids = sorted(self.cats)
        self.anns_by_img_cat: dict[tuple, list] = defaultdict(list)
        for ann in gt.get("annotations", []):
            self.anns_by_img_cat[(ann["image_id"], ann["category_id"])].append(ann)


def _prep_img_cat(dt_rows, gt_anns):
    """One-time arrays + IoU matrix for an (image, category) pair.

    dt_rows: list of (score, bbox) already sorted by score desc.
    The IoU matrix is area-range independent, so it is computed ONCE
    here and sliced by every (areaRng, maxDet) cell in `_evaluate_img`
    — the naive per-cell recompute cost 12x (4 areas x 3 maxDets) of
    both the IoU and the array construction on full-size datasets.
    """
    if not dt_rows and not gt_anns:
        return None
    gt_boxes = np.asarray([g["bbox"] for g in gt_anns], np.float64).reshape(-1, 4)
    gt_crowd = np.asarray([bool(g.get("iscrowd", 0)) for g in gt_anns], bool)
    gt_area = np.asarray([g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gt_anns],
                         np.float64)
    gt_ignore_in = np.asarray([bool(g.get("ignore", 0)) for g in gt_anns], bool)
    dt_scores = np.asarray([r[0] for r in dt_rows], np.float64)
    dt_boxes = np.asarray([r[1] for r in dt_rows], np.float64).reshape(-1, 4)
    return {
        "gt_boxes": gt_boxes, "gt_crowd": gt_crowd, "gt_area": gt_area,
        "gt_ignore_in": gt_ignore_in,
        "dt_scores": dt_scores,
        "dt_area": dt_boxes[:, 2] * dt_boxes[:, 3],
        "ious": box_iou_xywh(dt_boxes, gt_boxes, gt_crowd),  # (D, G)
    }


def _truncate_cell(cell, max_det: int):
    """Slice a matched cell down to its first `max_det` detections.

    Greedy matching in score order has the prefix property — det i's
    match depends only on dets < i — so the maxDet=1/10 results are
    exactly the first-k rows of the maxDet=100 matching (pycocotools
    likewise matches once at maxDets[-1] and truncates in accumulate).
    Matching once per (image, category, areaRng) and slicing here
    removes the 3x matching-loop recompute that dominated eval time."""
    if cell is None or len(cell["dt_scores"]) <= max_det:
        return cell
    return {
        "dt_scores": cell["dt_scores"][:max_det],
        "dt_matched": cell["dt_matched"][:, :max_det],
        "dt_ignore": cell["dt_ignore"][:, :max_det],
        "num_gt": cell["num_gt"],
    }


def _evaluate_img(prep, *, area_rng, max_det):
    """Greedy matching for one (image, category, areaRng, maxDet) cell,
    over arrays precomputed by `_prep_img_cat`."""
    if prep is None:
        return None
    t = len(IOU_THRS)
    d = min(len(prep["dt_scores"]), max_det)

    gt_ignore = (prep["gt_ignore_in"] | prep["gt_crowd"]
                 | (prep["gt_area"] < area_rng[0])
                 | (prep["gt_area"] > area_rng[1]))
    # sort GTs: non-ignored first (pycocotools matching order)
    order = np.argsort(gt_ignore, kind="stable")
    gt_crowd = prep["gt_crowd"][order]
    gt_ignore = gt_ignore[order]
    g = len(gt_ignore)

    dt_scores = prep["dt_scores"][:d]
    dt_area = prep["dt_area"][:d]
    ious = prep["ious"][:d][:, order]          # (D, G) view for this cell

    dtm = np.zeros((t, d), np.int64) - 1       # matched gt index or -1
    gtm = np.zeros((t, g), np.int64) - 1
    for ti, thr in enumerate(IOU_THRS):
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for gi in range(g):
                if gtm[ti, gi] >= 0 and not gt_crowd[gi]:
                    continue  # non-crowd GT already taken
                if best_g >= 0 and not gt_ignore[best_g] and gt_ignore[gi]:
                    break  # rest are ignored; keep the real match
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                dtm[ti, di] = best_g
                gtm[ti, best_g] = di

    # det ignore: matched-to-ignored-GT, or unmatched + outside area range
    dt_out_of_range = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
    dt_ignore = np.zeros((t, d), bool)
    for ti in range(t):
        matched = dtm[ti] >= 0
        ign_of_match = np.zeros(d, bool)
        ign_of_match[matched] = gt_ignore[dtm[ti][matched]]
        dt_ignore[ti] = np.where(matched, ign_of_match, dt_out_of_range)

    return {
        "dt_scores": dt_scores,
        "dt_matched": dtm >= 0,
        "dt_ignore": dt_ignore,
        "num_gt": int(np.sum(~gt_ignore)),
    }


class COCOEvaluator:
    """Drop-in bbox evaluator: construct with GT, feed results, summarize."""

    def __init__(self, gt: dict | str):
        self.gt = COCOGt(gt) if not isinstance(gt, COCOGt) else gt

    def evaluate(self, results: list[dict] | str, *, verbose: bool = True) -> dict:
        """results: COCO results-JSON rows
        {image_id, category_id, bbox [x,y,w,h], score}."""
        if isinstance(results, str):
            with open(results) as fh:
                results = json.load(fh)
        dts = defaultdict(list)
        for r in results:
            dts[(r["image_id"], r["category_id"])].append((r["score"], r["bbox"]))
        for key in dts:
            dts[key].sort(key=lambda x: -x[0])

        img_ids, cat_ids = self.gt.img_ids, self.gt.cat_ids
        t, r = len(IOU_THRS), len(REC_THRS)
        a, m = len(AREA_RNG), len(MAX_DETS)
        k = len(cat_ids)
        precision = -np.ones((t, r, k, a, m))
        recall = -np.ones((t, k, a, m))

        area_items = list(AREA_RNG.items())
        for ki, cat in enumerate(cat_ids):
            # arrays + IoU matrices once per (image, cat); every
            # (areaRng, maxDet) cell below slices them
            preps = [_prep_img_cat(dts.get((img, cat), []),
                                   self.gt.anns_by_img_cat.get((img, cat), []))
                     for img in img_ids]
            for ai, (_, rng) in enumerate(area_items):
                # match ONCE per (image, cat, areaRng) at the largest
                # maxDet; each maxDet cell is a prefix slice (see
                # _truncate_cell)
                full = [_evaluate_img(prep, area_rng=rng,
                                      max_det=max(MAX_DETS))
                        for prep in preps]
                for mi, max_det in enumerate(MAX_DETS):
                    cells = [c for c in
                             (_truncate_cell(f, max_det) for f in full)
                             if c is not None]
                    if not cells:
                        continue
                    scores = np.concatenate([c["dt_scores"] for c in cells])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([c["dt_matched"] for c in cells], 1)[:, order]
                    ignored = np.concatenate([c["dt_ignore"] for c in cells], 1)[:, order]
                    num_gt = sum(c["num_gt"] for c in cells)
                    if num_gt == 0:
                        continue
                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_cum = np.cumsum(tps, 1).astype(np.float64)
                    fp_cum = np.cumsum(fps, 1).astype(np.float64)
                    for ti in range(t):
                        tp, fp = tp_cum[ti], fp_cum[ti]
                        nd = len(tp)
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(r)
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self.precision, self.recall = precision, recall
        stats = self._summarize()
        if verbose:
            self.print_summary(stats)
        return stats

    def _mean(self, x):
        x = x[x > -1]
        return float(np.mean(x)) if x.size else -1.0

    def _summarize(self) -> dict:
        p, rec = self.precision, self.recall
        ai = {name: i for i, name in enumerate(AREA_RNG)}
        mi = {d: i for i, d in enumerate(MAX_DETS)}
        t50 = int(np.argmin(np.abs(IOU_THRS - 0.5)))
        t75 = int(np.argmin(np.abs(IOU_THRS - 0.75)))
        s = {
            "AP": self._mean(p[:, :, :, ai["all"], mi[100]]),
            "AP50": self._mean(p[t50, :, :, ai["all"], mi[100]]),
            "AP75": self._mean(p[t75, :, :, ai["all"], mi[100]]),
            "AP_small": self._mean(p[:, :, :, ai["small"], mi[100]]),
            "AP_medium": self._mean(p[:, :, :, ai["medium"], mi[100]]),
            "AP_large": self._mean(p[:, :, :, ai["large"], mi[100]]),
            "AR1": self._mean(rec[:, :, ai["all"], mi[1]]),
            "AR10": self._mean(rec[:, :, ai["all"], mi[10]]),
            "AR100": self._mean(rec[:, :, ai["all"], mi[100]]),
            "AR_small": self._mean(rec[:, :, ai["small"], mi[100]]),
            "AR_medium": self._mean(rec[:, :, ai["medium"], mi[100]]),
            "AR_large": self._mean(rec[:, :, ai["large"], mi[100]]),
        }
        return s

    @staticmethod
    def print_summary(stats: dict) -> None:
        tmpl = " Average {:9s} (AP) @[ IoU={:9s} | area={:6s} | maxDets={:3d} ] = {:0.3f}"
        rows = [
            ("Precision", "0.50:0.95", "all", 100, stats["AP"]),
            ("Precision", "0.50", "all", 100, stats["AP50"]),
            ("Precision", "0.75", "all", 100, stats["AP75"]),
            ("Precision", "0.50:0.95", "small", 100, stats["AP_small"]),
            ("Precision", "0.50:0.95", "medium", 100, stats["AP_medium"]),
            ("Precision", "0.50:0.95", "large", 100, stats["AP_large"]),
            ("Recall", "0.50:0.95", "all", 1, stats["AR1"]),
            ("Recall", "0.50:0.95", "all", 10, stats["AR10"]),
            ("Recall", "0.50:0.95", "all", 100, stats["AR100"]),
            ("Recall", "0.50:0.95", "small", 100, stats["AR_small"]),
            ("Recall", "0.50:0.95", "medium", 100, stats["AR_medium"]),
            ("Recall", "0.50:0.95", "large", 100, stats["AR_large"]),
        ]
        for name, iou, area, md, val in rows:
            print(tmpl.format(name, iou, area, md, val))
