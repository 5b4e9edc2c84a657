"""The numbers that decide `correct`, each against its limit.

Detect (what `Detector.detect_prepared` returned for the sampled
images, against the reference's detections and its dense outputs, every
box with every class's score, of the same canvases; boxes in image
pixels):

  score_gap    the largest, over images, of the median gap between a
               row's score and the reference's score of its class at the
               best-overlapping box (`row_gaps`; a row that overlaps no
               reference box by IoU 0.5, and a row the reference has
               beyond the program's count, gap 1): the precision of the
               scores.
  wrong_rows   the largest share, over images, of rows whose gap exceeds
               ROW_TOL, counting the rows that clipping to the image
               left untouched (at the edge, boxes clipped alike make the
               match ambiguous) and the rows the reference has beyond
               the program's count: an answer altered, moved or left
               out, a class row gathered for the wrong box.
  nms_overlap  the largest IoU between two returned rows of one class,
               neither touching the image's edge (clipping moves the
               IoU), in the postprocess's own arithmetic: on the canvas,
               each box shifted by CLASS_OFFSET times its class in
               float32. Greedy NMS keeps no pair above the
               configuration's `nms_iou`.
  uncovered    the share, over the sampled images together, of the
               reference's candidates scoring MARGIN or more above their
               image's cut (its lowest returned score when it returned
               `max_dets` rows, else `conf_thres`) that no returned row
               of their class overlaps by COVER_IOU: each such candidate
               is kept or suppressed by a kept row, whatever the
               rounding, unless top-k, NMS or the gather is wrong.
  rank_gap, count_gap, unmatched
               printed only: the k-th best scores, the row counts and
               the share of rows overlapping no reference box, which the
               top-k and NMS cuts move where seeded scores crowd.

Train (the first three steps, against the reference's three from the
same weights and batches):

  loss_gap     the largest |loss − reference loss| / reference loss.
  grad_gap     the worst leaf's gap between the norms of the program's
               first gradient (from its velocity after step 1) and the
               reference's, over the larger of that leaf's reference
               norm and the median leaf's.
  update_gap   the same for each parameter's change over the three.
  grad_gap_median, update_gap_median
               the median leaf's |‖program‖ − ‖reference‖| / ‖reference‖
               of the same two norms.
  grad_gap_kernels, update_gap_kernels
               grad_gap and update_gap over the leaves whose gradient the
               port's own kernels compute (the configuration's
               `kernel_leaves` patterns), against that group's median.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf numbers: they move by round-off.

A cell compares the numbers its `limits` (workloads/<cell>.json) name;
the others are printed for the record (PERF.md, section 6).
"""

from __future__ import annotations

from fnmatch import fnmatchcase

import numpy as np

from portbench.reference import postprocess as ref_post

LEAF_FLOOR = 1e-3
MATCH_IOU = 0.5
MATCH_TIE = 0.01
ROW_TOL = 0.1
MARGIN = 0.05
COVER_IOU = 0.4
EDGE = 0.5
CLASS_OFFSET = np.float32(8192.0)


class AxisAligned:
    """The detect check's box geometry for axis-aligned boxes: rows of
    (x1, y1, x2, y2). A family's GEOMETRY (families/<family>.py) gives
    these six parts, in whatever row layout its boxes take:

      rows(detections)     the program's boxes of one image, in image
                           pixels, from its `Detections`
      to_original(boxes, info)
                           the reference's canvas boxes of one image in
                           image pixels, clipped as the program clips
      iou(a, b)            the pairwise IoU (len(a), len(b))
      grow(boxes)          each box grown by half a pixel a side
      inside(boxes, size)  the boxes that clipping to the image (w, h)
                           left untouched
      on_canvas(boxes, classes, letterbox)
                           the boxes back on the canvas (letterbox:
                           ratio, pad_x, pad_y), shifted by CLASS_OFFSET
                           times their class in float32, as the
                           postprocess compares them
    """

    @staticmethod
    def rows(detections) -> np.ndarray:
        return detections.boxes_xyxy

    to_original = staticmethod(ref_post.to_original)

    @staticmethod
    def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        lt = np.maximum(a[:, None, :2], b[None, :, :2])
        rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]

        def area(x):
            return np.clip(x[:, 2] - x[:, 0], 0, None) * np.clip(x[:, 3] - x[:, 1], 0, None)
        return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)

    @staticmethod
    def grow(boxes: np.ndarray) -> np.ndarray:
        return boxes + np.array([-0.5, -0.5, 0.5, 0.5], np.float32)

    @staticmethod
    def inside(boxes: np.ndarray, size) -> np.ndarray:
        w, h = size
        return ((boxes[:, 0] > EDGE) & (boxes[:, 1] > EDGE)
                & (boxes[:, 2] < w - EDGE) & (boxes[:, 3] < h - EDGE))

    @staticmethod
    def on_canvas(boxes: np.ndarray, classes: np.ndarray,
                  letterbox) -> np.ndarray:
        ratio, pad_x, pad_y = letterbox
        canvas = (boxes * np.float32(ratio)
                  + np.array([pad_x, pad_y, pad_x, pad_y], np.float32))
        offset = canvas + (classes.astype(np.float32) * CLASS_OFFSET)[:, None]
        return offset.astype(np.float32)


def _match(pb: np.ndarray, dense_boxes: np.ndarray, geometry) -> np.ndarray:
    """The IoU of each row with every reference box, both grown by half a
    pixel a side, so that a box the image's edge clipped to no area still
    overlaps its own."""
    return geometry.iou(geometry.grow(pb), geometry.grow(dense_boxes))


def row_gaps(iou: np.ndarray, ps, pc, n_ref: int, den: dict) -> np.ndarray:
    """Each row's |score − reference score of its class| at its
    best-overlapping reference box, the least over boxes that overlap it
    within MATCH_TIE of the best (boxes that clipping made alike), and 1
    where it overlaps none by MATCH_IOU; and 1 for each row the reference
    has beyond the program's count. `iou`: `_match` of the rows."""
    gap = np.ones(max(len(ps), n_ref))
    if len(ps):
        best = iou.max(axis=1)
        near = iou >= best[:, None] - MATCH_TIE
        ref = den["scores"][:, pc].T                 # (rows, boxes)
        err = np.where(near, np.abs(ref - ps[:, None]), np.inf).min(axis=1)
        found = best >= MATCH_IOU
        gap[:len(ps)][found] = err[found]
    return gap


def nms_overlap(pb, pc, den: dict, geometry) -> float:
    """The largest IoU between two returned rows of one class, neither
    touching the image's edge, on the canvas with the class offset added
    in float32, as the postprocess compares them."""
    inside = geometry.inside(pb, den["size"])
    b, c = pb[inside], pc[inside]
    if len(b) < 2:
        return 0.0
    offset = geometry.on_canvas(b, c, den["letterbox"])
    iou = geometry.iou(offset, offset)
    same = (c[:, None] == c[None, :]) & ~np.eye(len(b), dtype=bool)
    return float(iou[same].max()) if same.any() else 0.0


def candidate_cover(pb, ps, pc, den: dict, geometry, *, cut: float,
                    multi_label: bool) -> tuple[np.ndarray, np.ndarray]:
    """The reference's candidates scoring above `cut` that clipping left
    untouched: (their score − cut, the largest IoU of a returned row of
    their class with them). Multi-label, a candidate is a (box, class)
    pair; single-label, a box at its best score, whose class may be any
    that scores within MARGIN of that best, as rounding may pick it."""
    scores = den["scores"]
    if multi_label:
        n, c = np.nonzero(scores > cut)
        ok = np.arange(scores.shape[1])[None, :] == c[:, None]
        best = scores[n, c]
    else:
        best = scores.max(axis=1)
        n = np.nonzero(best > cut)[0]
        best = best[n]
        ok = scores[n] >= best[:, None] - MARGIN
    inside = geometry.inside(den["boxes"][n], den["size"])
    n, ok, best = n[inside], ok[inside], best[inside]
    if not len(n) or not len(ps):
        return best - cut, np.zeros(len(n))
    iou = geometry.iou(den["boxes"][n], pb)
    iou[~ok[:, pc]] = 0.0
    return best - cut, iou.max(axis=1)


def detect_numbers(program: list, reference: list, dense: list, *,
                   geometry, nms_iou: float, conf_thres: float,
                   max_dets: int, multi_label: bool) -> dict:
    """program: [(boxes (K, ...), scores (K,), classes (K,))] an image, in
    image pixels; reference: [{"boxes", "scores", "classes"}] an image,
    the reference's detections; dense: [{"boxes" (N, ...) in image
    pixels, "scores" (N, C), "size" (w, h), "letterbox" (ratio, pad_x,
    pad_y)}] an image, the reference's every box and class score before
    the postprocess. Boxes are rows of the family's `geometry`
    (`AxisAligned` lists its parts)."""
    out = dict.fromkeys(("rank_gap", "count_gap", "unmatched", "score_gap",
                         "wrong_rows", "nms_overlap", "uncovered"), 0.0)
    due = uncovered = 0
    for (pb, ps, pc), ref, den in zip(program, reference, dense):
        rs = ref["scores"]
        n = max(len(ps), len(rs))
        a, b = np.zeros(n), np.zeros(n)
        a[:len(ps)] = np.sort(ps)[::-1]
        b[:len(rs)] = np.sort(rs)[::-1]
        if n:
            out["rank_gap"] = max(out["rank_gap"], float(np.abs(a - b).max()))
        out["count_gap"] = max(out["count_gap"],
                               abs(len(ps) - len(rs)) / max(len(rs), 1))
        iou = _match(pb, den["boxes"], geometry)
        gap = row_gaps(iou, ps, pc, len(rs), den)
        if len(ps):
            out["unmatched"] = max(out["unmatched"], float(
                (iou.max(axis=1) < MATCH_IOU).mean()))
        counted = np.ones(len(gap), bool)
        counted[:len(ps)] = geometry.inside(pb, den["size"])
        if len(gap):
            out["score_gap"] = max(out["score_gap"], float(np.median(gap)))
        if counted.any():
            out["wrong_rows"] = max(out["wrong_rows"], float(
                (gap[counted] > ROW_TOL).mean()))
        out["nms_overlap"] = max(out["nms_overlap"],
                                 nms_overlap(pb, pc, den, geometry))
        cut = float(ps.min()) if len(ps) >= max_dets else conf_thres
        above, cover = candidate_cover(pb, ps, pc, den, geometry, cut=cut,
                                       multi_label=multi_label)
        due += int((above >= MARGIN).sum())
        uncovered += int(((above >= MARGIN) & (cover < COVER_IOU)).sum())
    out["uncovered"] = uncovered / due if due else 0.0
    return out


def leaf_gap(got: dict, ref: dict, keep: list[str]) -> float:
    """The worst leaf's |‖got‖ − ‖ref‖| over max(‖ref‖, median ‖ref‖),
    over the leaves named in `keep`."""
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med) for k in keep)


def kept_leaves(ref_grad_norms: dict) -> list[str]:
    """Leaves whose reference first gradient is at least LEAF_FLOOR of
    the median leaf's."""
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * med]


def median_leaf_gap(got: dict, ref: dict, keep: list[str]) -> float:
    """The median over leaves of |‖got‖ − ‖ref‖| / ‖ref‖."""
    return float(np.median([abs(got[k] - ref[k]) / ref[k] for k in keep]))


def kernel_group(names, patterns: list[str]) -> list[str]:
    """The leaves matching any of the glob `patterns`."""
    return [k for k in names if any(fnmatchcase(k, p) for p in patterns)]


def train_numbers(program: dict, reference: dict,
                  kernel_leaves: list[str] = ()) -> dict:
    """program, reference: {"losses": [3 floats], "grad": {leaf: norm},
    "update": {leaf: norm}}; `kernel_leaves`: glob patterns of the leaves
    the port's kernels compute the gradient of."""
    keep = kept_leaves(reference["grad"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(program["losses"], reference["losses"]))
    out = {"loss_gap": loss_gap}
    for key in ("grad", "update"):
        out[f"{key}_gap"] = leaf_gap(program[key], reference[key], keep)
        out[f"{key}_gap_median"] = median_leaf_gap(program[key],
                                                   reference[key], keep)
    group = kernel_group(keep, kernel_leaves)
    if group:
        for key in ("grad", "update"):
            out[f"{key}_gap_kernels"] = leaf_gap(program[key],
                                                 reference[key], group)
    return out


def worst_leaves(program: dict, reference: dict, n: int = 3) -> dict:
    """The `n` worst leaves of the gradient and of the change, by
    `leaf_gap`'s measure: {key: [[leaf, program norm, reference norm]]}."""
    keep = kept_leaves(reference["grad"])
    out = {}
    for key in ("grad", "update"):
        got, ref = program[key], reference[key]
        med = float(np.median([ref[k] for k in keep]))
        order = sorted(keep, key=lambda k: -abs(got[k] - ref[k])
                       / max(ref[k], med))
        out[key] = [[k, got[k], ref[k]] for k in order[:n]]
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number that is not finite fails."""
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
