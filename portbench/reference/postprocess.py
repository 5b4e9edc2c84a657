"""Dense predictions → padded detections, and the inverse letterbox.

single-label (YOLOv3): conf gate → top-`pre_nms` boxes;
multi-label (FCOS): top-`pre_nms` boxes by their best class score →
their (box, class) pairs above conf → top-`pre_nms`;
then class-offset greedy NMS → top-`max_dets` rows. Top-k is a stable
descending sort (ties to the lower index); padding rows carry NEG_INF.
`greedy_keep` is the textbook sequential greedy over the IoU matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.boxes import pairwise_iou

CLASS_OFFSET = 8192.0
NEG_INF = -1e30


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _top_k_padded(x: torch.Tensor, k: int):
    b, n = x.shape
    values, idx = top_k(x, min(k, n))
    if n < k:
        values = torch.cat([values, values.new_full((b, k - n), NEG_INF)], 1)
        idx = torch.cat([idx, idx.new_zeros((b, k - n))], 1)
    return values, idx


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                iou_thres: float) -> torch.Tensor:
    """(B, K) keep-mask of score-sorted boxes (B, K, 4): box j goes when
    a kept box i < j overlaps it by IoU > iou_thres."""
    iou = pairwise_iou(boxes, boxes) > np.float32(iou_thres)
    keep = valid.clone()
    for i in range(boxes.shape[1] - 1):
        keep[:, i + 1:] &= ~(iou[:, i, i + 1:] & keep[:, i:i + 1])
    return keep


def postprocess(dense: dict, *, multi_label: bool, conf_thres: float,
                iou_thres: float, pre_nms: int, max_dets: int) -> dict:
    """Padded (B, max_dets) boxes, scores, classes, valid, and the NMS's
    inputs and output: `nms_boxes` (B, K, 4) class-offset, `nms_valid`,
    `nms_keep` (B, K), and the candidates' own boxes and classes."""
    boxes = dense["boxes"]
    if "score_logits" in dense:
        logits = dense["score_logits"]
        box_max = torch.sigmoid(logits.amax(-1)) * dense["score_mul"]
        _, box_sel = top_k(box_max, pre_nms)
        sel = torch.sigmoid(_rows(logits, box_sel)) \
            * torch.gather(dense["score_mul"], 1, box_sel)[..., None]
        c = sel.shape[-1]
        flat = sel.reshape(sel.shape[0], -1)
        flat = torch.where(flat >= conf_thres, flat, NEG_INF)
        scores, top_idx = _top_k_padded(flat, pre_nms)
        box_idx = torch.gather(box_sel, 1, torch.div(top_idx, c,
                                                     rounding_mode="floor"))
        classes = top_idx % c
    else:
        if multi_label:
            raise ValueError("multi-label postprocess takes score_logits")
        gated = torch.where(dense["scores"] >= conf_thres, dense["scores"],
                            NEG_INF)
        scores, box_idx = _top_k_padded(gated, pre_nms)
        classes = torch.gather(dense["classes"].long(), 1, box_idx)
    sel_boxes = _rows(boxes, box_idx)
    offset = sel_boxes + (classes.float() * CLASS_OFFSET)[..., None]
    valid = scores > NEG_INF / 2
    keep = greedy_keep(offset, valid, iou_thres)
    out_scores, order = top_k(torch.where(keep, scores, NEG_INF), max_dets)
    out_valid = out_scores > NEG_INF / 2
    return {"boxes": _rows(sel_boxes, order), "scores": out_scores,
            "classes": torch.gather(classes, 1, order), "valid": out_valid,
            "nms_boxes": offset, "nms_valid": valid, "nms_keep": keep,
            "candidate_boxes": sel_boxes, "candidate_classes": classes}


def to_original(boxes: np.ndarray, info) -> np.ndarray:
    """Network-pixel xyxy → original-image pixels, clipped (`info` has
    ratio, pad_x, pad_y, ori_w, ori_h)."""
    out = np.array(boxes, dtype=np.float32, copy=True)
    out[:, 0::2] = (out[:, 0::2] - info.pad_x) / info.ratio
    out[:, 1::2] = (out[:, 1::2] - info.pad_y) / info.ratio
    out[:, 0::2] = np.clip(out[:, 0::2], 0.0, info.ori_w)
    out[:, 1::2] = np.clip(out[:, 1::2], 0.0, info.ori_h)
    return out


def detections(out: dict, infos) -> list[dict]:
    """Padded rows → one dict an image (boxes in original pixels, scores,
    classes), valid rows only."""
    host = {k: out[k].cpu().numpy() for k in ("boxes", "scores", "classes",
                                              "valid")}
    dets = []
    for i, info in enumerate(infos):
        v = host["valid"][i]
        dets.append({"boxes": to_original(host["boxes"][i][v], info),
                     "scores": host["scores"][i][v].astype(np.float32),
                     "classes": host["classes"][i][v].astype(np.int32)})
    return dets
