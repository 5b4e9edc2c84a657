"""FCOS: ResNet-50 + FPN P3–P7 + two GroupNorm conv towers, and its loss.

A port of `mydetection_tpu/models/fcos.py` (`generate_locations`,
`group_norm`, `_tower`, `_head_conv`, `apply`, `decode_boxes`,
`decode`, `_assign`, `loss`) and of the registry's `_build_fcos`. Each
tower conv runs without its bias; the bias, the GroupNorm and the ReLU
after it are one call of `kernels.gn.bias_gn_relu` (the CUDA kernel on
the card, its plain version on the CPU), as the JAX package's fused
branch does: 8 calls per level, 40 per forward. Under autograd the call
is `BiasGNReLU`, the forward-with-statistics kernel paired with the
fused backward kernel.

The heads run NCHW (channels_last on the card); each output is permuted
to NHWC before it is flattened, so locations come out level-major, then
h·w row-major, as in the JAX concat. Class logits (and the per-level
max-over-classes gate) stay in the compute dtype; ltrb and centerness
are float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from mydetection_tpu_torch.kernels.gn import (
    BiasGNReLU,
    bias_gn_relu,
    bias_gn_relu_plain,
)
from mydetection_tpu_torch.kernels.route import pick
from mydetection_tpu_torch.losses import (
    bce_with_logits,
    focal_loss,
    giou_loss,
    take_along_dim,
)
from mydetection_tpu_torch.models.fpn import FPN, conv_bias
from mydetection_tpu_torch.models.layers import conv2d
from mydetection_tpu_torch.models.resnet import ResNet, prepare_input
from mydetection_tpu_torch.ops.boxes import cxcywh_to_xyxy

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
    """The JAX package's unfused GroupNorm (two-pass variance) over an
    NCHW tensor, float32 statistics, output in x's dtype. The tests'
    oracle; the model runs `bias_gn_relu`."""
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
    """4 × (3x3 conv → bias + GroupNorm(32) + ReLU). Under autograd the
    bias, GN and ReLU are `BiasGNReLU` (the forward-with-statistics and
    fused backward kernels on the card); otherwise `bias_gn_relu`."""

    def __init__(self, channels: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"conv{i}", _head_conv(channels, channels))
            self.add_module(f"gn{i}", GroupNorm(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            conv, gn = getattr(self, f"conv{i}"), getattr(self, f"gn{i}")
            y = conv2d(x, conv.weight)
            args = (y, conv.bias, gn.scale, gn.bias)
            if torch.is_grad_enabled() and any(t.requires_grad for t in args):
                x = BiasGNReLU.apply(*args, GN_GROUPS)
            else:
                x = pick(bias_gn_relu, bias_gn_relu_plain)(
                    *args, groups=GN_GROUPS)
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

    def forward(self, pyramid, *, ltrb_decode: str = "exp",
                with_gate: bool = False) -> tuple[torch.Tensor, ...]:
        """[P3..P7] NCHW → (cls (B, N, C) compute dtype, ltrb (B, N, 4)
        f32 pixel distances, ctr (B, N) f32 logits[, gate (B, N) compute
        dtype: the max-over-classes logit, per level])."""
        if ltrb_decode not in ("exp", "linear"):
            raise ValueError(f"ltrb_decode must be 'exp' or 'linear', got "
                             f"{ltrb_decode!r}")
        cls_f, box_f, ctr_f, gate_f = [], [], [], []
        for li, feat in enumerate(pyramid):
            ct = self.cls_tower(feat)
            bt = self.box_tower(feat)
            cls = _flat(conv_bias(self.cls_out, ct))
            raw_box = _flat(conv_bias(self.box_out, bt)).float()
            ctr = _flat(conv_bias(self.ctr_out, bt)).float()
            if ltrb_decode == "exp":
                ltrb = torch.exp(torch.clamp(raw_box * self.scales[li],
                                             -10.0, 10.0))
            else:
                ltrb = torch.relu(raw_box)
            cls_f.append(cls)
            if with_gate:
                gate_f.append(torch.amax(cls, dim=-1))
            box_f.append(ltrb * float(STRIDES[li]))
            ctr_f.append(ctr[..., 0])
        out = (torch.cat(cls_f, 1), torch.cat(box_f, 1), torch.cat(ctr_f, 1))
        return out + (torch.cat(gate_f, 1),) if with_gate else out


class FCOS(nn.Module):
    """ResNet-50 + FPN + FCOS head: uint8 NHWC images → raw heads."""

    def __init__(self, num_classes: int = 80,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 ltrb_decode: str = "exp", with_gate: bool = True):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ltrb_decode = ltrb_decode
        self.with_gate = with_gate
        self.backbone = ResNet(50)
        self.fpn = FPN()
        self.head = FCOSHead(num_classes)

    def forward(self, images: torch.Tensor, *,
                with_gate: bool | None = None) -> tuple[torch.Tensor, ...]:
        """uint8 NHWC images → raw heads; `with_gate` None = the
        config's (the loss asks for none)."""
        x = prepare_input(images.permute(0, 3, 1, 2), self.compute_dtype)
        return self.head(self.fpn(self.backbone(x)),
                         ltrb_decode=self.ltrb_decode,
                         with_gate=self.with_gate if with_gate is None
                         else with_gate)


def decode_boxes(ltrb: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """ltrb pixel distances (B, N, 4) + locations (N, 2) → (B, N, 4) xyxy."""
    xy = locations[None]
    return torch.cat([xy - ltrb[..., 0:2], xy + ltrb[..., 2:4]], dim=-1)


def decode(cls_logits: torch.Tensor, ltrb: torch.Tensor,
           ctr_logits: torch.Tensor, locations: torch.Tensor) -> dict:
    """Dense detections with materialized scores sigmoid(cls)·
    sigmoid(ctr): {"boxes": (B, N, 4) xyxy, "scores": (B, N, C) f32}.
    The detect path hands logits to the postprocess instead."""
    scores = (torch.sigmoid(cls_logits.float())
              * torch.sigmoid(ctr_logits)[..., None])
    return {"boxes": decode_boxes(ltrb, locations), "scores": scores}


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
