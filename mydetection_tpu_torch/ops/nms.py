"""Static-shape postprocess and class-offset NMS, batched.

A port of `mydetection_tpu/ops/nms.py` (`batched_class_nms_impl`,
`postprocess_impl` on all its branches: pre-reduced single-label, dense
(N, C) `scores` single- and multi-label, and `score_logits`;
`_multilabel_pairs`, `_nms_and_select`), with the image axis written
out where the JAX package vmaps one image at a time:

    single-label: conf gate → top-`pre_nms` boxes
    multi-label:  top-`pre_nms` boxes by their best class score →
                  their class rows (one `kernels.gather.gather_rows`
                  launch for the batch) → their (box, class) pairs,
                  conf gate → top-`pre_nms`
    then: CLASS_OFFSET shift → greedy NMS (one kernel launch for the
    batch) → top-`max_dets` rows + mask.

Exactness rules kept from the JAX package: top-k is a stable descending
sort (ties go to the lower index, as `jax.lax.top_k`), the class offset
is added in float32 before the IoU, and padding rows carry NEG_INF and
are valid iff score > NEG_INF/2.
"""

from __future__ import annotations

import torch

from mydetection_tpu_torch.kernels.gather import gather_rows, gather_rows_plain
from mydetection_tpu_torch.kernels.nms import nms_keep, nms_keep_plain
from mydetection_tpu_torch.kernels.route import pick

CLASS_OFFSET = 8192.0  # > any input_size; guarantees class separation
NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: values descending, ties to
    the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor,
                      classes: torch.Tensor, *,
                      iou_thres: float = 0.45) -> torch.Tensor:
    """Per-class NMS over (B, K) score-sorted rows via the class-offset
    trick; returns the (B, K) bool keep-mask."""
    offset = boxes + (classes.to(boxes.dtype) * CLASS_OFFSET)[..., None]
    return pick(nms_keep, nms_keep_plain)(
        offset.contiguous(), (scores > NEG_INF / 2).contiguous(), iou_thres)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for every image i: (B, N, ...) by (B, K) → (B, K, ...)."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


def _top_k_padded(x: torch.Tensor, pre_nms: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-min(pre_nms, N) of (B, N), padded up to the static pre_nms
    with NEG_INF scores at index 0."""
    b, n = x.shape
    k = min(pre_nms, n)
    values, idx = top_k(x, k)
    if k < pre_nms:
        pad = pre_nms - k
        values = torch.cat([values, values.new_full((b, pad), NEG_INF)], 1)
        idx = torch.cat([idx, idx.new_zeros((b, pad))], 1)
    return values, idx


def postprocess(boxes: torch.Tensor, scores: torch.Tensor | None = None,
                classes: torch.Tensor | None = None, *, conf_thres,
                iou_thres: float, score_logits: torch.Tensor | None = None,
                score_mul: torch.Tensor | None = None,
                gate_logits: torch.Tensor | None = None,
                pre_nms: int = 1024, max_dets: int = 100,
                multi_label: bool = False) -> dict[str, torch.Tensor]:
    """Dense predictions → padded detections per image.

    boxes (B, N, 4) xyxy and either
      * scores (B, N) per-box best-class scores with classes (B, N),
      * scores (B, N, C) per-class scores (multi-label: every (box,
        class) pair; single-label: each box's best class), or
      * score_logits (B, N, C) class logits in their own dtype, with
        optional score_mul (B, N), a per-box factor applied outside the
        sigmoid (FCOS centerness), and gate_logits (B, N), each box's
        max-over-classes logit when the head has it. The sigmoid runs
        in float32 after the box top-k.
    conf_thres is a float or a (B,) float32 tensor. Returns (B,
    max_dets, ...) boxes, scores, classes (-1 on padding) and the bool
    valid mask.
    """
    conf = torch.as_tensor(conf_thres, dtype=torch.float32,
                           device=boxes.device).reshape(-1, 1)
    if score_logits is not None:
        if scores is not None:
            raise ValueError("pass scores or score_logits, not both")
        gmax = (gate_logits if gate_logits is not None
                else torch.amax(score_logits, dim=-1))
        box_max = torch.sigmoid(gmax.float())
        if score_mul is not None:
            box_max = box_max * score_mul
        if multi_label:
            _, box_sel = top_k(box_max, pre_nms)               # (B, kb)
            sel = torch.sigmoid(
                pick(gather_rows, gather_rows_plain)(score_logits, box_sel)
                .float())
            if score_mul is not None:
                sel = sel * torch.gather(score_mul, 1, box_sel)[..., None]
            return _multilabel_pairs(boxes, sel, box_sel, conf,
                                     iou_thres=iou_thres, pre_nms=pre_nms,
                                     max_dets=max_dets)
        # best class per box: argmax is sigmoid-invariant
        scores = box_max
        classes = torch.argmax(score_logits, dim=-1)
    elif scores.dim() == 2:
        if classes is None:
            raise ValueError("per-box (B, N) scores require classes")
    elif multi_label:
        _, box_sel = top_k(torch.amax(scores, dim=-1), pre_nms)
        return _multilabel_pairs(boxes,
                                 pick(gather_rows, gather_rows_plain)(
                                     scores, box_sel),
                                 box_sel, conf, iou_thres=iou_thres,
                                 pre_nms=pre_nms, max_dets=max_dets)
    else:
        classes = torch.argmax(scores, dim=-1)
        scores = torch.amax(scores, dim=-1)
    gated = torch.where(scores >= conf, scores, NEG_INF)
    top_scores, box_idx = _top_k_padded(gated, pre_nms)
    cls_idx = torch.gather(classes.to(torch.int32), 1, box_idx)
    return nms_and_select(_rows(boxes, box_idx), top_scores, cls_idx,
                          iou_thres=iou_thres, max_dets=max_dets)


def _multilabel_pairs(boxes, sel, box_sel, conf, *, iou_thres: float,
                      pre_nms: int, max_dets: int) -> dict:
    """Stage 2 over the stage-1 boxes `box_sel` (B, kb) and their class
    scores `sel` (B, kb, C): the top-pre_nms (box, class) pairs above
    conf, then NMS."""
    c = sel.shape[-1]
    flat = sel.reshape(sel.shape[0], -1)
    flat = torch.where(flat >= conf, flat, NEG_INF)
    top_scores, top_idx = _top_k_padded(flat, pre_nms)
    box_idx = torch.gather(box_sel, 1, torch.div(top_idx, c,
                                                 rounding_mode="floor"))
    cls_idx = (top_idx % c).to(torch.int32)
    return nms_and_select(_rows(boxes, box_idx), top_scores, cls_idx,
                          iou_thres=iou_thres, max_dets=max_dets)


def nms_and_select(sel_boxes: torch.Tensor, top_scores: torch.Tensor,
                   cls_idx: torch.Tensor, *, iou_thres: float,
                   max_dets: int) -> dict[str, torch.Tensor]:
    """Class-offset NMS over sorted candidates + final top-max_dets."""
    keep = batched_class_nms(sel_boxes, top_scores, cls_idx,
                             iou_thres=iou_thres)
    final_scores = torch.where(keep, top_scores, NEG_INF)
    out_scores, order = top_k(final_scores, max_dets)
    out_valid = out_scores > NEG_INF / 2
    out_boxes = _rows(sel_boxes, order)
    out_classes = torch.gather(cls_idx, 1, order)
    return {
        "boxes": torch.where(out_valid[..., None], out_boxes, 0.0),
        "scores": torch.where(out_valid, out_scores, 0.0),
        "classes": torch.where(out_valid, out_classes, -1),
        "valid": out_valid,
    }
