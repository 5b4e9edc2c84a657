"""Axis-aligned box ops: cxcywh → xyxy and the pairwise IoU matrix.

A port of `mydetection_tpu/ops/boxes.py` with its evaluation order:
each area is its own rounded product, the union is
`area_a + area_b - inter`, floored at 1e-9 before the division.
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
