"""The reference's entry points by family: build, dense forward, loss,
and the SGD update the train step applies."""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference import fcos, yolov3
from portbench.reference.boxes import cxcywh_to_xyxy

FAMILIES = ("yolov3", "fcos")


def build(family: str, num_classes: int) -> nn.Module:
    if family == "yolov3":
        return yolov3.YOLOv3(num_classes)
    if family == "fcos":
        return fcos.FCOS(num_classes)
    raise ValueError(f"no reference for family {family!r}; have {FAMILIES}")


def dense(model: nn.Module, family: str, images_u8: torch.Tensor) -> dict:
    """uint8 NHWC batch → what the postprocess takes: yolov3 boxes (B, N,
    4) xyxy, best-class scores and classes; fcos boxes, class logits and
    sigmoid(centerness)."""
    if family == "yolov3":
        d = yolov3.decode_single_label(model(images_u8),
                                       model.head.head5.out.out_channels // 3 - 5)
        return {"boxes": cxcywh_to_xyxy(d["boxes"]), "scores": d["scores"],
                "classes": d["classes"]}
    cls_logits, ltrb, ctr = model(images_u8)
    locations, _ = fcos.generate_locations(int(images_u8.shape[1]),
                                           images_u8.device)
    return {"boxes": fcos.decode_boxes(ltrb, locations),
            "score_logits": cls_logits.float(),
            "score_mul": torch.sigmoid(ctr)}


def class_scores(model: nn.Module, family: str, images_u8: torch.Tensor,
                 dense_out: dict) -> torch.Tensor:
    """Every box's score for every class (B, N, C): yolov3 obj·cls,
    fcos sigmoid(class logit)·sigmoid(centerness)."""
    if family == "yolov3":
        d = yolov3.decode(model(images_u8),
                          model.head.head5.out.out_channels // 3 - 5)
        return yolov3.scores_from(d)
    return torch.sigmoid(dense_out["score_logits"]) \
        * dense_out["score_mul"][..., None]


def loss(model: nn.Module, family: str, images_u8, gt_boxes, gt_classes,
         gt_valid) -> dict:
    """The family's loss terms ({..., "total"}) on a train-mode model."""
    size = int(images_u8.shape[1])
    if family == "yolov3":
        return yolov3.loss(model(images_u8), gt_boxes, gt_classes, gt_valid,
                           input_size=size,
                           num_classes=model.head.head5.out.out_channels // 3 - 5)
    cls_logits, ltrb, ctr = model(images_u8)
    locations, strides = fcos.generate_locations(size, images_u8.device)
    return fcos.loss(cls_logits.float(), ltrb, ctr, locations, strides,
                     gt_boxes, gt_classes, gt_valid,
                     num_classes=cls_logits.shape[-1])


@torch.no_grad()
def sgd(params: dict, grads: dict, velocity: dict, *, lr: float,
        momentum: float, weight_decay: float) -> None:
    """v ← m·v + g + wd·p, then p ← p − lr·v, for every parameter."""
    for k, p in params.items():
        v = velocity[k]
        v.mul_(momentum).add_(grads[k]).add_(weight_decay * p)
        p.sub_(lr * v)
