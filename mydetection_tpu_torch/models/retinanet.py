"""RetinaNet: anchors, the shared class and box subnets, decode, encode
and the loss.

A port of `mydetection_tpu/models/retinanet.py` (`level_shapes`,
`anchor_wh`, `generate_anchors`, `init`, `_subnet`, `apply`,
`decode_boxes`, `decode`, `encode`, `loss`) and of the registry's
`_build_retinanet`: ResNet-50/101 → FPN P3–P7 → two subnets of four
3x3 conv(256→256) + bias + ReLU layers and an output conv, A = 9
anchors a cell.

Each subnet's four tower layers run as one `kernels.tower.
conv3x3_chain` call per level (the CUDA kernel on the card, its plain
version on the CPU), 2 subnets × 5 levels = 10 calls a forward; the
subnet's weights are packed into the kernel's layout once per forward,
outside the level loop. The chain has no backward, and neither has the
TPU kernel (the JAX package trains its towers through `_subnet`'s XLA
convs): under autograd the towers run `conv3x3_chain_plain`, the same
loop on cuDNN, chosen by grad mode as `fcos.Tower` chooses its GN
kernels. The output conv stays a cuDNN conv plus its bias, as the JAX
package computes it outside any Pallas kernel.

Outputs leave the head NHWC-flattened: flat index (h·W + w)·9 + a,
channel a·C + c, levels concatenated in order. Class logits (and the
per-level max-over-classes gate) stay in the compute dtype; box deltas
are float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from mydetection_tpu_torch.kernels.route import kernels_enabled
from mydetection_tpu_torch.kernels.tower import (
    conv3x3_chain,
    conv3x3_chain_plain,
    pack_weights,
)
from mydetection_tpu_torch.losses import focal_loss, smooth_l1, take_along_dim
from mydetection_tpu_torch.models.fpn import FPN, conv_bias
from mydetection_tpu_torch.models.resnet import ResNet, prepare_input
from mydetection_tpu_torch.ops.boxes import cxcywh_to_xyxy, pairwise_iou

STRIDES = (8, 16, 32, 64, 128)
OCTAVE_SCALES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
ASPECT_RATIOS = (0.5, 1.0, 2.0)  # h/w
NUM_ANCHORS = len(OCTAVE_SCALES) * len(ASPECT_RATIOS)
DWH_CLAMP = math.log(1000.0 / 16)
PRIOR_PROB = 0.01
POS_IOU, NEG_IOU = 0.5, 0.4
HEAD_INIT_STD = 0.01  # every subnet conv N(0, 0.01) (paper §4.1)
TOWER_LAYERS = 4


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------

def level_shapes(input_size: int) -> list[tuple[int, int]]:
    return [(math.ceil(input_size / s), math.ceil(input_size / s))
            for s in STRIDES]


def anchor_wh(base_size: float) -> np.ndarray:
    """The 9 (w, h) anchors of a level with `base_size` px, (A, 2)
    float32: torchvision's octave sizes (x, int(x·2^⅓), int(x·2^⅔)),
    aspect by √ratio, half-extents rounded by Python's round (banker's,
    as torch's), ratio-major then scale."""
    scales = (base_size, float(int(base_size * 2 ** (1 / 3))),
              float(int(base_size * 2 ** (2 / 3))))
    shapes = []
    for ratio in ASPECT_RATIOS:
        h_r = math.sqrt(ratio)
        w_r = 1.0 / h_r
        for scale in scales:
            shapes.append((2.0 * round(w_r * scale / 2.0),
                           2.0 * round(h_r * scale / 2.0)))
    return np.asarray(shapes, np.float32)


@functools.lru_cache(maxsize=16)
def _anchors_np(input_size: int) -> np.ndarray:
    out = []
    for stride, (h, w) in zip(STRIDES, level_shapes(input_size)):
        wh = anchor_wh(4.0 * stride)
        gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
        ctr = np.stack([gx * stride, gy * stride], -1)[:, :, None, :]
        boxes = np.concatenate(
            [np.broadcast_to(ctr, (h, w, NUM_ANCHORS, 2)),
             np.broadcast_to(wh[None, None], (h, w, NUM_ANCHORS, 2))], -1)
        out.append(boxes.reshape(-1, 4))
    table = np.concatenate(out).astype(np.float32)
    table.flags.writeable = False
    return table


def generate_anchors(input_size: int, device=None) -> torch.Tensor:
    """All anchors, (N, 4) cxcywh pixels: level-major, then row-major
    cells, then the 9 shapes; centres at grid·stride (torchvision's)."""
    return torch.tensor(_anchors_np(input_size), device=device)


# ---------------------------------------------------------------------------
# head
# ---------------------------------------------------------------------------

def _head_conv(c_in: int, c_out: int, bias: float = 0.0) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 3, bias=True)
    conv.init_std = HEAD_INIT_STD
    conv.init_bias = bias
    return conv


class Subnet(nn.Module):
    """conv0..conv3 (the tower, one `conv3x3_chain` call a level, or
    `conv3x3_chain_plain` under autograd) and the output conv; names
    follow the JAX tree (`head/cls/conv0/w`)."""

    def __init__(self, channels: int, c_final: int, final_bias: float):
        super().__init__()
        for i in range(TOWER_LAYERS):
            self.add_module(f"conv{i}", _head_conv(channels, channels))
        self.out = _head_conv(channels, c_final, final_bias)

    def packed(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """The tower's weights in the chain's layout and dtype, and its
        (L, C) float32 biases."""
        convs = [getattr(self, f"conv{i}") for i in range(TOWER_LAYERS)]
        return (pack_weights([c.weight for c in convs], dtype),
                torch.stack([c.bias.float() for c in convs]).contiguous())

    def forward(self, x: torch.Tensor, packed: torch.Tensor,
                biases: torch.Tensor) -> torch.Tensor:
        args = (x, packed, biases)
        if not kernels_enabled() or (torch.is_grad_enabled() and any(
                t.requires_grad for t in args)):
            return conv_bias(self.out, conv3x3_chain_plain(*args))
        return conv_bias(self.out, conv3x3_chain(*args))


def _flat(y: torch.Tensor, per_anchor: int) -> torch.Tensor:
    """NCHW (B, A·K, H, W) → (B, H·W·A, K), anchor-major within a cell."""
    b, _, h, w = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, h * w * NUM_ANCHORS, per_anchor)


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int = 80, channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.cls = Subnet(channels, NUM_ANCHORS * num_classes,
                          -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        self.box = Subnet(channels, NUM_ANCHORS * 4, 0.0)

    def forward(self, pyramid, *, with_gate: bool = False
                ) -> tuple[torch.Tensor, ...]:
        """[P3..P7] NCHW → (cls (B, N, C) compute dtype, deltas (B, N, 4)
        f32[, gate (B, N) compute dtype: the max-over-classes logit, per
        level])."""
        dtype = pyramid[0].dtype
        cls_w = self.cls.packed(dtype)
        box_w = self.box.packed(dtype)
        cls_f, box_f, gate_f = [], [], []
        for feat in pyramid:
            cl = _flat(self.cls(feat, *cls_w), self.num_classes)
            cls_f.append(cl)
            if with_gate:
                gate_f.append(torch.amax(cl, dim=-1))
            box_f.append(_flat(self.box(feat, *box_w), 4).float())
        out = (torch.cat(cls_f, 1), torch.cat(box_f, 1))
        return out + (torch.cat(gate_f, 1),) if with_gate else out


class RetinaNet(nn.Module):
    """ResNet-50/101 + FPN + RetinaNet head: uint8 NHWC images → raw
    heads."""

    def __init__(self, depth: int = 50, num_classes: int = 80,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 with_gate: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.with_gate = with_gate
        self.backbone = ResNet(depth)
        self.fpn = FPN()
        self.head = RetinaNetHead(num_classes)

    def forward(self, images: torch.Tensor, *,
                with_gate: bool | None = None) -> tuple[torch.Tensor, ...]:
        """uint8 NHWC images → raw heads; `with_gate` None = the
        config's (the loss asks for none)."""
        x = prepare_input(images.permute(0, 3, 1, 2), self.compute_dtype)
        return self.head(self.fpn(self.backbone(x)),
                         with_gate=self.with_gate if with_gate is None
                         else with_gate)


# ---------------------------------------------------------------------------
# decode + encode
# ---------------------------------------------------------------------------

def decode_boxes(box_deltas: torch.Tensor,
                 anchors_cxcywh: torch.Tensor) -> torch.Tensor:
    """Deltas (B, N, 4) + anchors (N, 4) → (B, N, 4) xyxy, float32:
    ctr = d·wh_a + ctr_a, wh = exp(clip(d, ±log(1000/16)))·wh_a."""
    ctr_a = anchors_cxcywh[None, :, :2]
    wh_a = anchors_cxcywh[None, :, 2:]
    ctr = box_deltas[..., :2] * wh_a + ctr_a
    wh = torch.exp(torch.clamp(box_deltas[..., 2:], -DWH_CLAMP,
                               DWH_CLAMP)) * wh_a
    return cxcywh_to_xyxy(torch.cat([ctr, wh], -1))


def decode(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
           anchors_cxcywh: torch.Tensor) -> dict:
    """Dense detections with materialized scores: {"boxes": (B, N, 4)
    xyxy, "scores": (B, N, C) float32 sigmoid}. The detect path hands
    logits to the postprocess instead."""
    return {"boxes": decode_boxes(box_deltas, anchors_cxcywh),
            "scores": torch.sigmoid(cls_logits.float())}


def encode(gt_cxcywh: torch.Tensor,
           anchors_cxcywh: torch.Tensor) -> torch.Tensor:
    """Inverse of `decode_boxes`: GT boxes → regression targets."""
    d_ctr = (gt_cxcywh[..., :2] - anchors_cxcywh[..., :2]) \
        / anchors_cxcywh[..., 2:]
    d_wh = torch.log(torch.clamp(gt_cxcywh[..., 2:] / anchors_cxcywh[..., 2:],
                                 min=1e-8))
    return torch.cat([d_ctr, d_wh], -1)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@torch.no_grad()
def assign(anchors_cxcywh: torch.Tensor, gt_boxes: torch.Tensor,
           gt_valid: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """RetinaNet's anchor assignment, `retinanet.py::loss`: an anchor
    whose best valid-GT IoU is at least POS_IOU is positive, below
    NEG_IOU negative, the band between ignored. Each valid GT's best
    anchor (the first on ties) is also forced positive and matched to
    it; where several GT force one anchor the highest GT index wins (a
    max-scatter of GT votes, padded GT voting −1, which is
    deterministic on the card too). Other anchors match their best GT
    (the first on ties). Returns (positive (B, N) bool, negative (B, N)
    bool, matched (B, N) int64)."""
    iou = pairwise_iou(cxcywh_to_xyxy(anchors_cxcywh)[None],
                       cxcywh_to_xyxy(gt_boxes))               # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_gt_iou = iou.amax(-1)                                  # (B, N)
    best_gt = torch.argmax(iou, -1)
    best_anchor = torch.argmax(iou, 1)                          # (B, M)
    del iou
    b, m = gt_valid.shape
    votes = torch.where(gt_valid, torch.arange(m, device=gt_valid.device), -1)
    force_votes = torch.full((b, anchors_cxcywh.shape[0]), -1,
                             dtype=torch.int64, device=gt_valid.device)
    force_votes.scatter_reduce_(1, best_anchor, votes, reduce="amax")
    force = force_votes >= 0
    positive = (best_gt_iou >= POS_IOU) | force
    negative = (best_gt_iou < NEG_IOU) & ~force
    return positive, negative, torch.where(force, force_votes.clamp(min=0),
                                           best_gt)


def loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
         anchors_cxcywh: torch.Tensor, gt_boxes: torch.Tensor,
         gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
         num_classes: int = 80) -> dict:
    """Focal (cls) + smooth-L1 (box) under `assign`,
    `retinanet.py::loss`: `loss_from_sums` of `loss_sums`. Returns
    {"cls", "box", "total"}."""
    return loss_from_sums(loss_sums(cls_logits, box_deltas, anchors_cxcywh,
                                    gt_boxes, gt_classes, gt_valid,
                                    num_classes=num_classes))


def loss_sums(cls_logits: torch.Tensor, box_deltas: torch.Tensor,
              anchors_cxcywh: torch.Tensor, gt_boxes: torch.Tensor,
              gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
              num_classes: int = 80) -> dict:
    """The RetinaNet loss's sums, `retinanet.py::loss`: focal loss over
    positive | negative anchors and smooth-L1 of the deltas against
    `encode` of the matched GT on the positives, with the number of
    positives (`loss_from_sums` divides both by max(positives, 1)).

    cls_logits (B, N, C) float32, box_deltas (B, N, 4), anchors (N, 4)
    cxcywh; gt_boxes (B, M, 4) cxcywh net pixels, gt_classes (B, M)
    int, gt_valid (B, M) bool. Returns {"cls", "box", "num_pos"}."""
    positive, negative, matched = assign(anchors_cxcywh, gt_boxes, gt_valid)
    tgt_cls = take_along_dim(gt_classes, matched)               # (B, N)
    cls_onehot = ((tgt_cls[..., None] == torch.arange(
        num_classes, device=tgt_cls.device)) & positive[..., None]).float()
    fl = focal_loss(cls_logits, cls_onehot)                     # (B, N, C)
    cls_sum = (fl * (positive | negative)[..., None]).sum()

    reg_tgt = encode(take_along_dim(gt_boxes, matched), anchors_cxcywh[None])
    reg = smooth_l1(box_deltas, reg_tgt).sum(-1)                # (B, N)
    return {"cls": cls_sum, "box": (reg * positive).sum(),
            "num_pos": positive.sum().float()}


def loss_from_sums(sums: dict) -> dict:
    """`loss_sums`' terms divided by max(positives, 1), the positives
    first summed over the replicas in a data-parallel step."""
    num_pos = torch.clamp(sums["num_pos"], min=1.0)
    cls_loss = sums["cls"] / num_pos
    box_loss = sums["box"] / num_pos
    return {"cls": cls_loss, "box": box_loss, "total": cls_loss + box_loss}
