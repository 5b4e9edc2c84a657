"""YOLOv3 neck, detection heads and the single-label decode.

A port of `mydetection_tpu/models/yolov3.py` (`apply`, the anchor
tables, the multi-label `decode_level` / `decode` / `scores_from` and
`decode_single_label`). The neck runs NCHW; each raw head
output is permuted to JAX's NHWC `(B, H, W, A*(5+C))` before it leaves
the module, because the decode flattens it to `(B, H*W*A, 5+C)` with
cells row-major and anchors minor — an NCHW map flattened directly would
put every box in the wrong cell. The decode runs in float32 whatever the
conv compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from mydetection_tpu_torch.models.darknet import Darknet53
from mydetection_tpu_torch.models.layers import (
    ConvBNLeaky,
    conv2d,
    normalize_input,
    upsample2x,
)

# Canonical YOLOv3 COCO anchors (w, h) in input pixels, paper order.
ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),  # P5, stride 32
    ((30, 61), (62, 45), (59, 119)),      # P4, stride 16
    ((10, 13), (16, 30), (33, 23)),       # P3, stride 8
)
STRIDES = (32, 16, 8)
TWH_CLAMP = 8.0  # exp(8)*373 ≈ 1.1e6 px — generous but finite


class Conv5(nn.Module):
    """The 1x1/3x3/1x1/3x3/1x1 conv stack before each branch."""

    def __init__(self, c_in: int, c_mid: int):
        super().__init__()
        self.c0 = ConvBNLeaky(c_in, c_mid, 1)
        self.c1 = ConvBNLeaky(c_mid, c_mid * 2, 3)
        self.c2 = ConvBNLeaky(c_mid * 2, c_mid, 1)
        self.c3 = ConvBNLeaky(c_mid, c_mid * 2, 3)
        self.c4 = ConvBNLeaky(c_mid * 2, c_mid, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c4(self.c3(self.c2(self.c1(self.c0(x)))))


class Branch(nn.Module):
    """3x3 conv-BN-leaky, then the 1x1 output conv plus its bias; the
    result is returned NHWC."""

    def __init__(self, c_in: int, c_mid: int, c_out: int):
        super().__init__()
        self.conv = ConvBNLeaky(c_in, c_mid, 3)
        self.out = nn.Conv2d(c_mid, c_out, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d(self.conv(x), self.out.weight)
        out = out + self.out.bias.to(out.dtype)[:, None, None]
        return out.permute(0, 2, 3, 1)


class YOLOv3Head(nn.Module):
    """Neck + 3 detection branches over Darknet-53's C3/C4/C5."""

    def __init__(self, num_classes: int = 80, num_anchors: int = 3, *,
                 channels_per_anchor: int | None = None):
        super().__init__()
        per_anchor = (5 + num_classes if channels_per_anchor is None
                      else channels_per_anchor)
        no = num_anchors * per_anchor
        self.block5 = Conv5(1024, 512)
        self.head5 = Branch(512, 1024, no)
        self.lateral4 = ConvBNLeaky(512, 256, 1)
        self.block4 = Conv5(512 + 256, 256)
        self.head4 = Branch(256, 512, no)
        self.lateral3 = ConvBNLeaky(256, 128, 1)
        self.block3 = Conv5(256 + 128, 128)
        self.head3 = Branch(128, 256, no)

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """(C3, C4, C5) NCHW → raw [P5, P4, P3], each (B, H, W, A*no)."""
        c3, c4, c5 = feats
        x5 = self.block5(c5)
        out5 = self.head5(x5)
        x4 = torch.cat([upsample2x(self.lateral4(x5)), c4], dim=1)
        x4 = self.block4(x4)
        out4 = self.head4(x4)
        x3 = torch.cat([upsample2x(self.lateral3(x4)), c3], dim=1)
        x3 = self.block3(x3)
        out3 = self.head3(x3)
        return [out5, out4, out3]


class YOLOv3(nn.Module):
    """Darknet-53 + YOLOv3 head: uint8 NHWC images → raw NHWC heads.
    `channels_per_anchor` overrides the per-anchor output width (default
    5 + num_classes); RAPiD passes 6 for (x, y, w, h, θ, conf)."""

    def __init__(self, num_classes: int = 80,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 channels_per_anchor: int | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = Darknet53()
        self.head = YOLOv3Head(num_classes,
                               channels_per_anchor=channels_per_anchor)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = images.permute(0, 3, 1, 2)
        if x.dtype == torch.uint8:
            x = normalize_input(x, self.compute_dtype)
        else:
            x = x.to(self.compute_dtype)
        return self.head(self.backbone(x))


def grid_anchor_tables(h: int, w: int, anchors, device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (N, 2) grid-offset and anchor-wh tables, N = h·w·A, in the
    head's flatten order (cells row-major, anchors minor)."""
    na = len(anchors)
    gy, gx = np.mgrid[0:h, 0:w]
    grid = np.stack([gx, gy], -1)[:, :, None, :].astype(np.float32)
    grid = np.broadcast_to(grid, (h, w, na, 2)).reshape(-1, 2)
    anc = np.broadcast_to(np.asarray(anchors, np.float32)[None, None],
                          (h, w, na, 2)).reshape(-1, 2)
    return (torch.from_numpy(grid).to(device),
            torch.from_numpy(np.ascontiguousarray(anc)).to(device))


def decode_boxes_level(r: torch.Tensor, grid: torch.Tensor,
                       anc: torch.Tensor, stride: int) -> torch.Tensor:
    """Channels 0-3 of flat raw (B, N, C_any) → (B, N, 4) cxcywh in net
    pixels, float32."""
    xy = (torch.sigmoid(r[..., 0:2].float()) + grid[None]) * float(stride)
    twh = torch.clamp(r[..., 2:4].float(), -TWH_CLAMP, TWH_CLAMP)
    wh = torch.exp(twh) * anc[None]
    return torch.cat([xy, wh], dim=-1)


def decode_level(raw: torch.Tensor, anchors, stride: int,
                 num_classes: int) -> dict[str, torch.Tensor]:
    """One level's raw (B, H, W, A·(5+C)) → boxes (B, N, 4) cxcywh net
    pixels, obj (B, N) and cls (B, N, C) sigmoids, float32."""
    b, h, w, _ = raw.shape
    r = raw.reshape(b, h * w * len(anchors), 5 + num_classes)
    grid, anc = grid_anchor_tables(h, w, anchors, raw.device)
    return {"boxes": decode_boxes_level(r, grid, anc, stride),
            "obj": torch.sigmoid(r[..., 4].float()),
            "cls": torch.sigmoid(r[..., 5:].float())}


def decode(raw_outputs: Sequence[torch.Tensor], num_classes: int = 80, *,
           anchors=ANCHORS) -> dict[str, torch.Tensor]:
    """All levels → concatenated dense predictions (B, ΣN, ...)."""
    parts = [decode_level(raw, anchors[i], STRIDES[i], num_classes)
             for i, raw in enumerate(raw_outputs)]
    return {k: torch.cat([p[k] for p in parts], dim=1)
            for k in ("boxes", "obj", "cls")}


def scores_from(decoded: dict) -> torch.Tensor:
    """Per-class scores obj·cls (B, N, C), the YOLO convention."""
    return decoded["obj"][..., None] * decoded["cls"]


def decode_single_label(raw_outputs: Sequence[torch.Tensor],
                        num_classes: int = 80, *,
                        anchors=ANCHORS) -> dict[str, torch.Tensor]:
    """All levels → per-box best-class detections: boxes (B, ΣN, 4)
    cxcywh, scores (B, ΣN) = sigmoid(obj)·sigmoid(max class logit),
    classes (B, ΣN) int32 = the first maximal class logit."""
    boxes, scores, classes = [], [], []
    for i, raw in enumerate(raw_outputs):
        b, h, w, _ = raw.shape
        na = len(anchors[i])
        r = raw.reshape(b, h * w * na, 5 + num_classes)
        grid, anc = grid_anchor_tables(h, w, anchors[i], raw.device)
        # max/argmax on the raw logits in their own dtype: sigmoid is
        # monotone, so only the winning logit is cast up
        cls_logits = r[..., 5:]
        score = (torch.sigmoid(r[..., 4].float())
                 * torch.sigmoid(torch.amax(cls_logits, dim=-1).float()))
        boxes.append(decode_boxes_level(r, grid, anc, STRIDES[i]))
        scores.append(score)
        classes.append(torch.argmax(cls_logits, dim=-1).to(torch.int32))
    return {"boxes": torch.cat(boxes, dim=1),
            "scores": torch.cat(scores, dim=1),
            "classes": torch.cat(classes, dim=1)}
