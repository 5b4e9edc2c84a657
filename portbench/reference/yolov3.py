"""YOLOv3 neck, detection heads, the decode and the loss (float32).

Redmon & Farhadi, arXiv:1804.02767, with darknet's yolov3.cfg anchors:
the neck, three heads, the single-label decode and the training loss
(best wh-IoU anchor assignment, BCE on xy and objectness with the
ignore mask, half squared error on twh, BCE classes). The neck runs NCHW;
each raw head output is permuted to JAX's NHWC `(B, H, W, A*(5+C))`
before it leaves the module, because the decode flattens it to
`(B, H*W*A, 5+C)` with cells row-major and anchors minor — an NCHW map
flattened directly would put every box in the wrong cell. The decode
runs in float32 whatever the conv compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from portbench.reference.losses import bce_with_logits
from portbench.reference.darknet import Darknet53
from portbench.reference.layers import (
    ConvBNLeaky,
    conv2d,
    normalize_input,
    upsample2x,
)
from portbench.reference.boxes import cxcywh_to_xyxy, pairwise_iou

# Canonical YOLOv3 COCO anchors (w, h) in input pixels, paper order.
ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),  # P5, stride 32
    ((30, 61), (62, 45), (59, 119)),      # P4, stride 16
    ((10, 13), (16, 30), (33, 23)),       # P3, stride 8
)
STRIDES = (32, 16, 8)
IGNORE_THRES = 0.6
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
    """Darknet-53 + YOLOv3 head: uint8 NHWC images → raw NHWC heads."""

    def __init__(self, num_classes: int = 80):
        super().__init__()
        self.backbone = Darknet53()
        self.head = YOLOv3Head(num_classes)

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        return self.head(self.backbone(normalize_input(
            images.permute(0, 3, 1, 2))))


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


# ---------------------------------------------------------------------------
# loss (vectorized target assignment over padded GT)
# ---------------------------------------------------------------------------

def best_anchors(gt_wh: torch.Tensor, anchors) -> tuple[torch.Tensor, ...]:
    """Each GT's best anchor over all nine by the IoU of their (w, h) at
    a common origin (the union floored at 1e-9; the first maximal one on
    ties): (level (B, M) with 0 = P5, index within the level (B, M))."""
    table = torch.tensor([a for lvl in anchors for a in lvl],
                         dtype=torch.float32, device=gt_wh.device)
    gw, gh = gt_wh[..., 0:1], gt_wh[..., 1:2]
    aw, ah = table[:, 0], table[:, 1]
    inter = torch.minimum(gw, aw) * torch.minimum(gh, ah)
    union = gw * gh + aw * ah - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    return best // 3, best % 3


def scatter_targets(packed: torch.Tensor, flat_idx: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Per-GT target rows (B, M, K) → per-prediction rows (B, n, K): row
    j of image b takes GT m's row where flat_idx[b, m] == j (n is the
    trash slot of unassigned GT), zeros where no GT lands.

    Where several GT land on one row, the last of them (the highest m)
    wins for every channel: what the JAX loss's single `.at[].set` keeps
    on XLA:CPU. Written as a max-scatter of the GT index and one gather,
    so the card gives that answer too, where `index_put_` with duplicate
    indices is nondeterministic."""
    b, m, k = packed.shape
    gt_idx = torch.arange(m, device=packed.device).expand(b, m)
    winner = torch.full((b, n + 1), -1, dtype=torch.int64,
                        device=packed.device)
    winner.scatter_reduce_(1, flat_idx, gt_idx, reduce="amax")
    winner = winner[:, :n]
    rows = torch.gather(packed, 1, winner.clamp(min=0)[..., None]
                        .expand(b, n, k))
    return torch.where((winner >= 0)[..., None], rows, rows.new_zeros(()))


def level_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                  extra: torch.Tensor, best: tuple[torch.Tensor, ...],
                  li: int, h: int, w: int, anchors, input_size: int
                  ) -> torch.Tensor:
    """Level li's targets (B, h·w·3, 6 + E) in its flat (cell, anchor)
    order: [assigned (1 or 0), in-cell xy offsets (2), log(wh / anchor)
    (2) with the ratio floored at 1e-9, the box weight 2 − w·h /
    input_size², then the GT's `extra` columns (B, M, E)], zeros where
    no GT lands. A GT takes the cell of its centre over the stride,
    truncated toward zero and clipped, and the anchor `best`
    (`best_anchors`) names when its level is li; one `scatter_targets`
    moves every column, so a GT that wins a collision wins them all."""
    na, stride = 3, STRIDES[li]
    best_level, best_sub = best
    cx, cy = gt_boxes[..., 0] / stride, gt_boxes[..., 1] / stride
    ci = torch.clamp(cx.to(torch.int32), 0, w - 1)
    cj = torch.clamp(cy.to(torch.int32), 0, h - 1)
    flat_idx = ((cj * w + ci) * na + best_sub).to(torch.int64)
    flat_idx = torch.where(gt_valid & (best_level == li), flat_idx,
                           h * w * na)
    anc = torch.tensor(anchors[li], dtype=torch.float32,
                       device=gt_boxes.device)[best_sub]
    t_xy = torch.stack([cx - torch.floor(cx), cy - torch.floor(cy)], -1)
    t_wh = torch.log(torch.clamp(gt_boxes[..., 2:4] / anc, min=1e-9))
    w_box = 2.0 - (gt_boxes[..., 2] * gt_boxes[..., 3]) \
        / float(input_size) ** 2
    packed = torch.cat([torch.ones_like(w_box[..., None]), t_xy, t_wh,
                        w_box[..., None], extra], -1)
    return scatter_targets(packed, flat_idx, h * w * na)


def loss(raw_outputs: Sequence[torch.Tensor], gt_boxes: torch.Tensor,
         gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
         input_size: int, num_classes: int = 80, anchors=ANCHORS) -> dict:
    """YOLOv3 loss over padded GT, `yolov3.py::loss`: `loss_from_sums`
    of `loss_sums`. Returns {"obj", "box", "cls", "total"}."""
    return loss_from_sums(loss_sums(raw_outputs, gt_boxes, gt_classes,
                                    gt_valid, input_size=input_size,
                                    num_classes=num_classes, anchors=anchors))


def loss_sums(raw_outputs: Sequence[torch.Tensor], gt_boxes: torch.Tensor,
              gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
              input_size: int, num_classes: int = 80, anchors=ANCHORS
              ) -> dict:
    """The YOLOv3 loss's sums, `yolov3.py::loss`: each GT goes to
    its best wh-IoU anchor of all nine, at the cell of its centre;
    BCE on sigmoid(t_xy) against the in-cell offset and half the squared
    error of t_wh against log(gt_wh / anchor), both weighted by
    2 − w·h/input_size²; BCE objectness, whose negatives drop where the
    decoded box overlaps a valid GT by IoU > IGNORE_THRES; BCE classes
    on the assigned predictions. These are the batch's sums, with its
    normalisers: the positives and B (`loss_from_sums` divides obj by
    B, box and cls by max(positives, 1)).

    raw_outputs: [P5, P4, P3] raw (B, H, W, 3·(5+C)) maps (cast to
    float32 per level); gt_boxes (B, M, 4) cxcywh in net pixels,
    gt_classes (B, M) int, gt_valid (B, M) bool. Returns {"obj", "box",
    "cls", "num_pos", "b"}, b an int."""
    b = gt_classes.shape[0]
    best = best_anchors(gt_boxes[..., 2:4], anchors)
    with torch.no_grad():
        pred_xyxy = cxcywh_to_xyxy(decode(raw_outputs, num_classes,
                                          anchors=anchors)["boxes"])
        iou = pairwise_iou(pred_xyxy, cxcywh_to_xyxy(gt_boxes))
        iou = torch.where(gt_valid[:, None, :], iou, 0.0)
        ignore_flat = iou.amax(-1) > IGNORE_THRES
        del iou
    onehot = (gt_classes[..., None] == torch.arange(
        num_classes, device=gt_classes.device)).float()

    total_obj = total_box = total_cls = num_pos = 0.0
    offset = 0
    for li, raw in enumerate(raw_outputs):
        bb, h, w, _ = raw.shape
        n = h * w * 3
        tgt = level_targets(gt_boxes, gt_valid, onehot, best, li, h, w,
                            anchors, input_size)
        assigned = tgt[..., 0] > 0
        xy_tgt, wh_tgt, wbox = tgt[..., 1:3], tgt[..., 3:5], tgt[..., 5]
        cls_tgt = tgt[..., 6:]

        flat_raw = raw.float().reshape(bb, n, 5 + num_classes)
        ignore = ignore_flat[:, offset:offset + n]
        obj_bce = bce_with_logits(flat_raw[..., 4], assigned.float())
        total_obj = total_obj + (obj_bce * (assigned | ~ignore)).sum()
        xy_bce = bce_with_logits(flat_raw[..., 0:2], xy_tgt).sum(-1)
        wh_mse = ((flat_raw[..., 2:4] - wh_tgt) ** 2).sum(-1) * 0.5
        total_box = total_box + ((xy_bce + wh_mse) * wbox * assigned).sum()
        cls_bce = bce_with_logits(flat_raw[..., 5:], cls_tgt).sum(-1)
        total_cls = total_cls + (cls_bce * assigned).sum()
        num_pos = num_pos + assigned.sum()
        offset += n

    return {"obj": total_obj, "box": total_box, "cls": total_cls,
            "num_pos": num_pos, "b": b}


def loss_from_sums(sums: dict) -> dict:
    """`loss_sums`' terms divided by their normalisers, which a
    data-parallel step first sums over the replicas: obj by B, box and
    cls by max(positives, 1)."""
    norm = torch.clamp(torch.as_tensor(sums["num_pos"], dtype=torch.float32),
                       min=1.0)
    b = sums["b"]
    out = {"obj": sums["obj"] / (b if b else 1), "box": sums["box"] / norm,
           "cls": sums["cls"] / norm}
    out["total"] = out["obj"] + out["box"] + out["cls"]
    return out
