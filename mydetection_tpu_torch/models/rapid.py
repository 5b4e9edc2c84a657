"""RAPiD's angle-aware decode over the YOLOv3 heads.

A port of `mydetection_tpu/models/rapid.py` (the anchor table and the
decode; the loss waits for the training slice). RAPiD is Darknet-53 and
the YOLOv3 neck with one extra channel per anchor: each anchor predicts
(x, y, w, h, θ, conf) for a single class (people in overhead fisheye
images). The box decode is YOLOv3's; θ = (sigmoid(t_θ) − 0.5)·π in
(−π/2, π/2), radians, all in float32 whatever the conv dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from mydetection_tpu_torch.models.yolov3 import (
    decode_boxes_level,
    grid_anchor_tables,
)

# Person anchors (w, h) in input pixels per level, P5/P4/P3 order: the
# JAX package's person-shaped priors (override through the config for
# retrained models).
ANCHORS = (
    ((187, 374), (259, 311), (374, 187)),   # P5, stride 32
    ((94, 187), (130, 155), (187, 94)),     # P4, stride 16
    ((47, 94), (65, 78), (94, 47)),         # P3, stride 8
)
STRIDES = (32, 16, 8)
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
