"""FCOS: ResNet-50 + FPN P3–P7 + two GroupNorm conv towers, the box
decode and the loss (float32).

Tian et al., arXiv:1904.01355: per-level towers of four 3x3 conv → GN
(32 groups) → ReLU, class logits, ltrb distances exp(s_l·raw)·stride
and centerness; the loss is focal (classes), centerness-weighted GIoU
(boxes) and BCE (centerness) under center sampling (radius 1.5
strides) and per-level ranges of max(l, t, r, b). Locations come out
level-major, then h·w row-major.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from portbench.reference import precision
from portbench.reference.boxes import cxcywh_to_xyxy
from portbench.reference.fpn import FPN, conv_bias
from portbench.reference.losses import (
    bce_with_logits,
    focal_loss,
    giou_loss,
    take_along_dim,
)
from portbench.reference.resnet import ResNet, prepare_input

STRIDES = (8, 16, 32, 64, 128)
# per-level regression range for max(l, t, r, b)
LEVEL_RANGES = ((0, 64), (64, 128), (128, 256), (256, 512), (512, 1e8))
PRIOR_PROB = 0.01
CENTER_RADIUS = 1.5  # center-sampling radius in stride units
GN_GROUPS = 32
HEAD_INIT_STD = 0.01  # N(0, 0.01) tower and out convs (torchvision's head)


def level_shapes(input_size: int) -> list[tuple[int, int]]:
    return [(math.ceil(input_size / s), math.ceil(input_size / s))
            for s in STRIDES]


@functools.lru_cache(maxsize=16)
def _locations_np(input_size: int) -> tuple[np.ndarray, np.ndarray]:
    locs, strides = [], []
    for stride, (h, w) in zip(STRIDES, level_shapes(input_size)):
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        locs.append(np.stack([gx * stride, gy * stride], -1).reshape(-1, 2))
        strides.append(np.full((h * w,), stride, np.float32))
    return np.concatenate(locs), np.concatenate(strides)


def generate_locations(input_size: int, device=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """All pyramid locations: ((N, 2) xy pixels, (N,) stride), at
    grid·stride (torchvision's convention)."""
    locs, strides = _locations_np(input_size)
    return (torch.tensor(locs, device=device),
            torch.tensor(strides, device=device))


def group_norm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *,
               groups: int = GN_GROUPS) -> torch.Tensor:
    """GroupNorm (two-pass variance) over an NCHW tensor."""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, groups, c // groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(b, c, h, w)
    return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm affine parameters keyed like the JAX tree."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def _head_conv(c_in: int, c_out: int, bias: float = 0.0) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 3, bias=True)
    conv.init_std = HEAD_INIT_STD
    conv.init_bias = bias
    return conv


class Tower(nn.Module):
    """4 × (3x3 conv → bias → GroupNorm(32) → ReLU)."""

    def __init__(self, channels: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", _head_conv(channels, channels))
            self.add_module(f"gn{i}", GroupNorm(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            conv, gn = getattr(self, f"conv{i}"), getattr(self, f"gn{i}")
            x = torch.relu(precision.stored(
                group_norm(conv_bias(conv, x), gn.scale, gn.bias)))
        return x


def _flat(y: torch.Tensor) -> torch.Tensor:
    """NCHW head output → (B, H·W, C), locations row-major."""
    b, c, h, w = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, h * w, c)


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int = 80, channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.cls_tower = Tower(channels)
        self.box_tower = Tower(channels)
        self.cls_out = _head_conv(channels, num_classes,
                                  -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        self.box_out = _head_conv(channels, 4)
        self.ctr_out = _head_conv(channels, 1)
        self.scales = nn.Parameter(torch.ones(len(STRIDES)))

    def forward(self, pyramid) -> tuple[torch.Tensor, ...]:
        """[P3..P7] NCHW → (cls logits (B, N, C), ltrb (B, N, 4) pixel
        distances exp(s_l·raw)·stride, centerness logits (B, N))."""
        cls_f, box_f, ctr_f = [], [], []
        for li, feat in enumerate(pyramid):
            ct = self.cls_tower(feat)
            bt = self.box_tower(feat)
            cls_f.append(_flat(conv_bias(self.cls_out, ct)))
            raw_box = _flat(conv_bias(self.box_out, bt))
            ltrb = torch.exp(torch.clamp(raw_box * self.scales[li], -10.0,
                                         10.0))
            box_f.append(ltrb * float(STRIDES[li]))
            ctr_f.append(_flat(conv_bias(self.ctr_out, bt))[..., 0])
        return torch.cat(cls_f, 1), torch.cat(box_f, 1), torch.cat(ctr_f, 1)


class FCOS(nn.Module):
    """ResNet-50 + FPN + FCOS head: uint8 NHWC images → raw heads."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.backbone = ResNet(50)
        self.fpn = FPN()
        self.head = FCOSHead(num_classes)

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        x = prepare_input(images.permute(0, 3, 1, 2))
        return self.head(self.fpn(self.backbone(x)))


def decode_boxes(ltrb: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """ltrb pixel distances (B, N, 4) + locations (N, 2) → (B, N, 4) xyxy."""
    xy = locations[None]
    return torch.cat([xy - ltrb[..., 0:2], xy + ltrb[..., 2:4]], dim=-1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def assign(locations: torch.Tensor, strides: torch.Tensor,
           gt_xyxy: torch.Tensor, gt_valid: torch.Tensor
           ) -> tuple[torch.Tensor, ...]:
    """FCOS target assignment for a batch, `fcos.py::_assign`: a
    location's candidates are the valid GT boxes it lies inside, within
    1.5 strides of their centre and in its level's range of max(l, t, r,
    b); it takes the smallest-area one, the first index on ties (no
    candidate: every area is the 1e18 sentinel, index 0). Returns
    (positive (B, N) bool, matched (B, N) int64, target ltrb (B, N, 4),
    centerness target (B, N))."""
    x, y = locations[:, 0], locations[:, 1]                   # (N,)
    x1, y1, x2, y2 = gt_xyxy.unbind(-1)                       # (B, M)
    l = x[None, :, None] - x1[:, None, :]                     # (B, N, M)
    t = y[None, :, None] - y1[:, None, :]
    r = x2[:, None, :] - x[None, :, None]
    b = y2[:, None, :] - y[None, :, None]
    ltrb = torch.stack([l, t, r, b], -1)                      # (B, N, M, 4)
    inside = ltrb.amin(-1) > 0

    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    rad = CENTER_RADIUS * strides[None, :, None]
    near = ((torch.abs(x[None, :, None] - cx[:, None, :]) < rad)
            & (torch.abs(y[None, :, None] - cy[:, None, :]) < rad))

    maxd = ltrb.amax(-1)                                      # (B, N, M)
    lo = torch.zeros_like(strides)
    hi = torch.zeros_like(strides)
    for s, (a, c) in zip(STRIDES, LEVEL_RANGES):
        lo = torch.where(strides == s, a, lo)
        hi = torch.where(strides == s, c, hi)
    in_range = (maxd >= lo[None, :, None]) & (maxd <= hi[None, :, None])

    candidate = inside & near & in_range & gt_valid[:, None, :]
    area = (x2 - x1) * (y2 - y1)                              # (B, M)
    cand_area = torch.where(candidate, area[:, None, :],
                            torch.tensor(1e18, device=area.device))
    matched = torch.argmin(cand_area, -1)                     # (B, N)
    positive = candidate.any(-1)

    sel = take_along_dim(gt_xyxy, matched)                    # (B, N, 4)
    tgt = torch.stack([x[None, :] - sel[..., 0], y[None, :] - sel[..., 1],
                       sel[..., 2] - x[None, :], sel[..., 3] - y[None, :]],
                      -1)                                     # (B, N, 4)
    lr = tgt[..., 0::2]
    tb = tgt[..., 1::2]
    ctr_tgt = torch.sqrt(torch.clamp(
        (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-8))
        * (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-8)), 0.0, 1.0))
    return positive, matched, tgt, ctr_tgt


def loss(cls_logits: torch.Tensor, ltrb_pred: torch.Tensor,
         ctr_logits: torch.Tensor, locations: torch.Tensor,
         strides: torch.Tensor, gt_boxes: torch.Tensor,
         gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
         num_classes: int = 80) -> dict:
    """Focal (cls) + centerness-weighted GIoU (box) + BCE (centerness)
    under the FCOS assignment, `fcos.py::loss`: `loss_from_sums` of
    `loss_sums`. Returns {"cls", "box", "ctr", "total"}."""
    return loss_from_sums(loss_sums(cls_logits, ltrb_pred, ctr_logits,
                                    locations, strides, gt_boxes, gt_classes,
                                    gt_valid, num_classes=num_classes))


def loss_sums(cls_logits: torch.Tensor, ltrb_pred: torch.Tensor,
              ctr_logits: torch.Tensor, locations: torch.Tensor,
              strides: torch.Tensor, gt_boxes: torch.Tensor,
              gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
              num_classes: int = 80) -> dict:
    """The FCOS loss's sums and normalisers, `fcos.py::loss`: focal,
    centerness-weighted GIoU and centerness BCE summed over the batch,
    the number of positives and the box term's weight (the positives'
    centerness targets). gt_boxes (B, M, 4) cxcywh net pixels, padded,
    with gt_valid (B, M) bool and gt_classes (B, M) int. Returns {"cls",
    "box", "ctr", "num_pos", "box_weight"}."""
    gt_xyxy = cxcywh_to_xyxy(gt_boxes)
    positive, matched, tgt_ltrb, ctr_tgt = assign(locations, strides,
                                                  gt_xyxy, gt_valid)

    tgt_cls = take_along_dim(gt_classes, matched)
    # jax.nn.one_hot: an out-of-range class (padding) is all zeros
    onehot = (tgt_cls[..., None] == torch.arange(
        num_classes, device=tgt_cls.device)).float()
    cls_onehot = onehot * positive[..., None]
    cls_sum = focal_loss(cls_logits, cls_onehot).sum()

    pred_xyxy = decode_boxes(ltrb_pred, locations)
    tgt_xyxy = decode_boxes(tgt_ltrb, locations)
    g = giou_loss(pred_xyxy, tgt_xyxy)                        # (B, N)
    w = ctr_tgt * positive

    ctr_bce = bce_with_logits(ctr_logits, ctr_tgt)
    return {"cls": cls_sum, "box": (g * w).sum(),
            "ctr": (ctr_bce * positive).sum(),
            "num_pos": positive.sum().float(), "box_weight": w.sum()}


def loss_from_sums(sums: dict) -> dict:
    """`loss_sums`' terms over their normalisers, which a data-parallel
    step first sums over the replicas: cls and ctr by max(positives, 1),
    box by max(its weight, 1e-6)."""
    num_pos = torch.clamp(sums["num_pos"], min=1.0)
    cls_loss = sums["cls"] / num_pos
    box_loss = sums["box"] / torch.clamp(sums["box_weight"], min=1e-6)
    ctr_loss = sums["ctr"] / num_pos
    return {"cls": cls_loss, "box": box_loss, "ctr": ctr_loss,
            "total": cls_loss + box_loss + ctr_loss}
