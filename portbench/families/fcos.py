"""FCOS (ResNet-50-FPN with GroupNorm towers): the reference's entry
points for configurations whose `family` is "fcos"."""

from __future__ import annotations

import torch
from torch import nn

from portbench import judge
from portbench.reference import fcos
from portbench.reference import postprocess as ref_post

GEOMETRY = judge.AxisAligned


def build(num_classes: int) -> nn.Module:
    return fcos.FCOS(num_classes)


def dense(model: nn.Module, images_u8: torch.Tensor) -> dict:
    """uint8 NHWC batch → what the postprocess takes: boxes (B, N, 4)
    xyxy, class logits and sigmoid(centerness)."""
    cls_logits, ltrb, ctr = model(images_u8)
    locations, _ = fcos.generate_locations(int(images_u8.shape[1]),
                                           images_u8.device)
    return {"boxes": fcos.decode_boxes(ltrb, locations),
            "score_logits": cls_logits.float(),
            "score_mul": torch.sigmoid(ctr)}


def class_scores(model: nn.Module, images_u8: torch.Tensor,
                 dense_out: dict) -> torch.Tensor:
    """Every box's score for every class (B, N, C): sigmoid(class logit)
    · sigmoid(centerness)."""
    return torch.sigmoid(dense_out["score_logits"]) \
        * dense_out["score_mul"][..., None]


def loss(model: nn.Module, images_u8, gt_boxes, gt_classes,
         gt_valid) -> dict:
    """The loss terms ({..., "total"}) on a train-mode model."""
    size = int(images_u8.shape[1])
    cls_logits, ltrb, ctr = model(images_u8)
    locations, strides = fcos.generate_locations(size, images_u8.device)
    return fcos.loss(cls_logits.float(), ltrb, ctr, locations, strides,
                     gt_boxes, gt_classes, gt_valid,
                     num_classes=cls_logits.shape[-1])


postprocess = ref_post.configured
