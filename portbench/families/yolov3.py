"""YOLOv3 (Darknet-53, the YOLOv3 neck and heads): the reference's entry
points for configurations whose `family` is "yolov3"."""

from __future__ import annotations

import torch
from torch import nn

from portbench import judge
from portbench.reference import postprocess as ref_post
from portbench.reference import yolov3
from portbench.reference.boxes import cxcywh_to_xyxy

GEOMETRY = judge.AxisAligned


def build(num_classes: int) -> nn.Module:
    return yolov3.YOLOv3(num_classes)


def dense(model: nn.Module, images_u8: torch.Tensor) -> dict:
    """uint8 NHWC batch → what the postprocess takes: boxes (B, N, 4)
    xyxy, best-class scores and classes."""
    d = yolov3.decode_single_label(model(images_u8),
                                   model.head.head5.out.out_channels // 3 - 5)
    return {"boxes": cxcywh_to_xyxy(d["boxes"]), "scores": d["scores"],
            "classes": d["classes"]}


def class_scores(model: nn.Module, images_u8: torch.Tensor,
                 dense_out: dict) -> torch.Tensor:
    """Every box's score for every class (B, N, C): obj·cls."""
    d = yolov3.decode(model(images_u8),
                      model.head.head5.out.out_channels // 3 - 5)
    return yolov3.scores_from(d)


def loss(model: nn.Module, images_u8, gt_boxes, gt_classes,
         gt_valid) -> dict:
    """The loss terms ({..., "total"}) on a train-mode model."""
    size = int(images_u8.shape[1])
    return yolov3.loss(model(images_u8), gt_boxes, gt_classes, gt_valid,
                       input_size=size,
                       num_classes=model.head.head5.out.out_channels // 3 - 5)


postprocess = ref_post.configured
