"""RAPiD's angle-aware decode and loss over the YOLOv3 heads.

A port of `mydetection_tpu/models/rapid.py` (the anchor table, the
decode and the loss). RAPiD is Darknet-53 and
the YOLOv3 neck with one extra channel per anchor: each anchor predicts
(x, y, w, h, θ, conf) for a single class (people in overhead fisheye
images). The box decode is YOLOv3's; θ = (sigmoid(t_θ) − 0.5)·π in
(−π/2, π/2), radians, all in float32 whatever the conv dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from mydetection_tpu_torch.losses import bce_with_logits, period_l1
from mydetection_tpu_torch.models.yolov3 import (
    best_anchors,
    decode_boxes_level,
    grid_anchor_tables,
    level_targets,
)
from mydetection_tpu_torch.ops.boxes import pairwise_iou

# Person anchors (w, h) in input pixels per level, P5/P4/P3 order: the
# JAX package's person-shaped priors (override through the config for
# retrained models).
ANCHORS = (
    ((187, 374), (259, 311), (374, 187)),   # P5, stride 32
    ((94, 187), (130, 155), (187, 94)),     # P4, stride 16
    ((47, 94), (65, 78), (94, 47)),         # P3, stride 8
)
STRIDES = (32, 16, 8)
IGNORE_THRES = 0.6
CHANNELS_PER_ANCHOR = 6  # x, y, w, h, theta, conf


def decode_level(raw: torch.Tensor, anchors, stride: int
                 ) -> dict[str, torch.Tensor]:
    """One level's raw (B, H, W, A*6) → {"boxes5": (B, N, 5) cxcywhθ in
    net pixels, "conf": (B, N)}, float32."""
    b, h, w, _ = raw.shape
    r = raw.reshape(b, h * w * len(anchors), CHANNELS_PER_ANCHOR)
    grid, anc = grid_anchor_tables(h, w, anchors, raw.device)
    xywh = decode_boxes_level(r, grid, anc, stride)
    theta = (torch.sigmoid(r[..., 4:5].float()) - 0.5) * math.pi
    conf = torch.sigmoid(r[..., 5].float())
    return {"boxes5": torch.cat([xywh, theta], dim=-1), "conf": conf}


def decode(raw_outputs: Sequence[torch.Tensor], *, anchors=ANCHORS
           ) -> dict[str, torch.Tensor]:
    """All levels (P5, P4, P3) → boxes5 (B, ΣN, 5) and conf (B, ΣN)."""
    parts = [decode_level(raw, anchors[i], STRIDES[i])
             for i, raw in enumerate(raw_outputs)]
    return {"boxes5": torch.cat([p["boxes5"] for p in parts], dim=1),
            "conf": torch.cat([p["conf"] for p in parts], dim=1)}


def enclose(boxes5: torch.Tensor) -> torch.Tensor:
    """cxcywhθ (..., 5) → the axis-aligned hull of each rotated box,
    (..., 4) xyxy."""
    cos = torch.abs(torch.cos(boxes5[..., 4]))
    sin = torch.abs(torch.sin(boxes5[..., 4]))
    w = boxes5[..., 2] * cos + boxes5[..., 3] * sin
    h = boxes5[..., 2] * sin + boxes5[..., 3] * cos
    return torch.stack([boxes5[..., 0] - w / 2, boxes5[..., 1] - h / 2,
                        boxes5[..., 0] + w / 2, boxes5[..., 1] + h / 2], -1)


def loss(raw_outputs: Sequence[torch.Tensor], gt_boxes5: torch.Tensor,
         gt_valid: torch.Tensor, *, input_size: int, anchors=ANCHORS
         ) -> dict:
    """RAPiD loss over padded GT, `rapid.py::loss`: `loss_from_sums` of
    `loss_sums`. Returns {"conf", "box", "angle", "total"}."""
    return loss_from_sums(loss_sums(raw_outputs, gt_boxes5, gt_valid,
                                    input_size=input_size, anchors=anchors))


def loss_sums(raw_outputs: Sequence[torch.Tensor], gt_boxes5: torch.Tensor,
              gt_valid: torch.Tensor, *, input_size: int, anchors=ANCHORS
              ) -> dict:
    """The RAPiD loss's sums, `rapid.py::loss`: YOLOv3's assignment
    and box terms (`yolov3.loss`), a periodic L1 (period π) between
    (sigmoid(t_θ) − 0.5)·π and the GT angle on the assigned predictions,
    and BCE confidence whose negatives drop where the hull of the
    decoded box overlaps a valid GT's hull by IoU > IGNORE_THRES. The
    angle target rides in the same scatter as the others, so a GT that
    wins a collision wins every channel. These are the batch's sums,
    with its normalisers: the positives and B (`loss_from_sums` divides
    conf by B, box and angle by max(positives, 1)).

    gt_boxes5: (B, M, 5) cxcywhθ (radians) in net pixels, gt_valid
    (B, M) bool. Returns {"conf", "box", "angle", "num_pos", "b"}, b an
    int."""
    b = gt_valid.shape[0]
    best = best_anchors(gt_boxes5[..., 2:4], anchors)
    with torch.no_grad():
        decoded = decode(raw_outputs, anchors=anchors)
        iou = pairwise_iou(enclose(decoded["boxes5"]), enclose(gt_boxes5))
        iou = torch.where(gt_valid[:, None, :], iou, 0.0)
        ignore_flat = iou.amax(-1) > IGNORE_THRES
        del iou, decoded

    total_conf = total_box = total_angle = num_pos = 0.0
    offset = 0
    for li, raw in enumerate(raw_outputs):
        bb, h, w, _ = raw.shape
        n = h * w * 3
        tgt = level_targets(gt_boxes5, gt_valid, gt_boxes5[..., 4:5], best,
                            li, h, w, anchors, input_size)
        assigned = tgt[..., 0] > 0
        xy_tgt, wh_tgt = tgt[..., 1:3], tgt[..., 3:5]
        wbox, th_tgt = tgt[..., 5], tgt[..., 6]

        flat_raw = raw.float().reshape(bb, n, CHANNELS_PER_ANCHOR)
        ignore = ignore_flat[:, offset:offset + n]
        conf_bce = bce_with_logits(flat_raw[..., 5], assigned.float())
        total_conf = total_conf + (conf_bce * (assigned | ~ignore)).sum()
        xy_bce = bce_with_logits(flat_raw[..., 0:2], xy_tgt).sum(-1)
        wh_mse = ((flat_raw[..., 2:4] - wh_tgt) ** 2).sum(-1) * 0.5
        total_box = total_box + ((xy_bce + wh_mse) * wbox * assigned).sum()
        pred_theta = (torch.sigmoid(flat_raw[..., 4]) - 0.5) * math.pi
        total_angle = total_angle + (period_l1(pred_theta, th_tgt)
                                     * assigned).sum()
        num_pos = num_pos + assigned.sum()
        offset += n

    return {"conf": total_conf, "box": total_box, "angle": total_angle,
            "num_pos": num_pos, "b": b}


def loss_from_sums(sums: dict) -> dict:
    """`loss_sums`' terms divided by their normalisers, which a
    data-parallel step first sums over the replicas: conf by B, box and
    angle by max(positives, 1)."""
    norm = torch.clamp(torch.as_tensor(sums["num_pos"], dtype=torch.float32),
                       min=1.0)
    b = sums["b"]
    out = {"conf": sums["conf"] / (b if b else 1), "box": sums["box"] / norm,
           "angle": sums["angle"] / norm}
    out["total"] = out["conf"] + out["box"] + out["angle"]
    return out
