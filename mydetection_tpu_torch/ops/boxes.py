"""Axis-aligned box ops: format conversion, the pairwise IoU matrix and
the matched (elementwise) IoU and GIoU of the losses.

A port of `mydetection_tpu/ops/boxes.py` with its evaluation order:
each area is its own rounded product, the union is
`area_a + area_b - inter`, floored at 1e-9 before the division (the
GIoU hull too).
"""

from __future__ import annotations

import torch

EPS = 1e-9


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes[..., :4].unbind(-1)
    half_w, half_h = w * 0.5, h * 0.5
    return torch.stack([cx - half_w, cy - half_h, cx + half_w, cy + half_h],
                       dim=-1)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between xyxy box sets a (..., N, 4) and b (..., M, 4)
    → (..., N, M) float32. Degenerate boxes give 0."""
    a = a[..., :, None, :4]
    b = b[..., None, :, :4]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    aw = torch.clamp(a[..., 2] - a[..., 0], min=0.0)
    ah = torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    bw = torch.clamp(b[..., 2] - b[..., 0], min=0.0)
    bh = torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = aw * ah + bw * bh - inter
    return inter / torch.clamp(union, min=EPS)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes[..., :4].unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1],
                       dim=-1)


def _floor(x: torch.Tensor, v: float) -> torch.Tensor:
    """max(x, v) differentiated as `jnp.maximum` is: at a tie the
    gradient splits in half (`torch.clamp` would pass all of it)."""
    return torch.maximum(x, x.new_tensor(v))


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    w = _floor(boxes_xyxy[..., 2] - boxes_xyxy[..., 0], 0.0)
    h = _floor(boxes_xyxy[..., 3] - boxes_xyxy[..., 1], 0.0)
    return w * h


def _iou_union(a: torch.Tensor, b: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(iou, union) for matched xyxy boxes, the one definition IoU and
    GIoU share."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = _floor(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / _floor(union, EPS), union


def elementwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between matched xyxy boxes of identical shape (..., 4)."""
    return _iou_union(a, b)[0]


def elementwise_giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized IoU between matched xyxy boxes (..., 4) → (...)."""
    iou, union = _iou_union(a, b)
    lt = torch.minimum(a[..., :2], b[..., :2])
    rb = torch.maximum(a[..., 2:4], b[..., 2:4])
    wh = _floor(rb - lt, 0.0)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / _floor(hull, EPS)
