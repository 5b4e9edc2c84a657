"""Static-shape single-label postprocess and class-offset NMS, batched.

A port of the single-label branch of `mydetection_tpu/ops/nms.py`
(`batched_class_nms_impl`, `postprocess_impl(multi_label=False)`,
`_nms_and_select`), with the image axis written out where the JAX
package vmaps one image at a time:

    conf gate → top-`pre_nms` → CLASS_OFFSET shift → greedy NMS
    (one kernel launch for the batch) → top-`max_dets` rows + mask.

Exactness rules kept from the JAX package: top-k is a stable descending
sort (ties go to the lower index, as `jax.lax.top_k`), the class offset
is added in float32 before the IoU, and padding rows carry NEG_INF and
are valid iff score > NEG_INF/2.
"""

from __future__ import annotations

import torch

from mydetection_tpu_torch.kernels.nms import nms_keep

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
    return nms_keep(offset.contiguous(), (scores > NEG_INF / 2).contiguous(),
                    iou_thres)


def postprocess(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, *, conf_thres, iou_thres: float,
                pre_nms: int = 1024, max_dets: int = 100,
                multi_label: bool = False) -> dict[str, torch.Tensor]:
    """Dense single-label predictions → padded detections per image.

    boxes (B, N, 4) xyxy; scores (B, N) per-box best-class score;
    classes (B, N); conf_thres a float or a (B,) float32 tensor.
    Returns (B, max_dets, ...) boxes, scores, classes (-1 on padding)
    and the bool valid mask.
    """
    if multi_label or scores.dim() != 2:
        raise NotImplementedError(
            "the multi-label postprocess arrives with the RetinaNet slice "
            "of the port; this slice ports the single-label branch")
    b, n = scores.shape
    conf = torch.as_tensor(conf_thres, dtype=torch.float32,
                           device=scores.device).reshape(-1, 1)
    gated = torch.where(scores >= conf, scores, NEG_INF)
    k = min(pre_nms, n)
    top_scores, box_idx = top_k(gated, k)
    if k < pre_nms:  # pad up to the static pre_nms
        pad = pre_nms - k
        top_scores = torch.cat([top_scores, top_scores.new_full(
            (b, pad), NEG_INF)], dim=1)
        box_idx = torch.cat([box_idx, box_idx.new_zeros((b, pad))], dim=1)
    cls_idx = torch.gather(classes.to(torch.int32), 1, box_idx)
    sel_boxes = torch.gather(boxes, 1, box_idx[..., None].expand(-1, -1, 4))
    return nms_and_select(sel_boxes, top_scores, cls_idx,
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
    out_boxes = torch.gather(sel_boxes, 1, order[..., None].expand(-1, -1, 4))
    out_classes = torch.gather(cls_idx, 1, order)
    return {
        "boxes": torch.where(out_valid[..., None], out_boxes, 0.0),
        "scores": torch.where(out_valid, out_scores, 0.0),
        "classes": torch.where(out_valid, out_classes, -1),
        "valid": out_valid,
    }
