"""Model factory: string name → model module (the build-by-name surface).

A port of `mydetection_tpu/registry.py` for the YOLOv3, RetinaNet,
FCOS and RAPiD families: `ModelConfig` keeps the JAX package's fields,
`get_model` builds the `nn.Module` with the config on its `config`
attribute, and `forward_dense` is the decode glue of `dense_from_raw`
(raw heads → dense xyxy boxes with per-box or per-class scores, class
logits for the multi-label postprocess, or rotated cxcywhθ boxes with
scores); `loss` is the family's training loss, wired for every
registered name as the JAX registry wires it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from mydetection_tpu_torch.models import fcos, rapid, retinanet, yolov3
from mydetection_tpu_torch.ops.boxes import cxcywh_to_xyxy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_classes: int = 80
    input_size: int = 416
    conf_thres: float = 0.005
    nms_iou: float = 0.45
    pre_nms: int = 1024
    max_dets: int = 100
    rotated: bool = False
    # multi_label: every (box, class) pair above conf (RetinaNet/FCOS);
    # False = per-box best class only (the YOLO decode idiom)
    multi_label: bool = True
    compute_dtype: Any = torch.bfloat16  # conv compute; decode is always f32
    class_names: tuple[str, ...] | None = None
    # FCOS ltrb decode: "exp" (the paper, exp(s_l·raw)·stride) or
    # "linear" (torchvision's relu(raw)·stride)
    ltrb_decode: str = "exp"
    # anchor table override for the darknet families: 3 levels (P5→P3)
    # of 3 (w, h) pairs in input pixels; None = the family default
    anchors: tuple | None = None
    # the JAX package's TPU approximate pre-NMS top-k; accepted and
    # ignored, the port's top-k is exact everywhere
    approx_topk: bool = True
    # the JAX package's switch for its fused Pallas GN; accepted and
    # ignored: the port's towers always run the GN kernels
    # (`kernels.gn.bias_gn_relu`, or `BiasGNReLU` under autograd; the
    # CUDA kernels on the card, their plain versions on the CPU)
    fused_gn: bool | None = None


_REGISTRY: dict[str, Callable[[ModelConfig], nn.Module]] = {}
_CONFIGS: dict[str, ModelConfig] = {}


def register(name: str, config: ModelConfig):
    def deco(build_fn: Callable[[ModelConfig], nn.Module]):
        _REGISTRY[name] = build_fn
        _CONFIGS[name] = config
        return build_fn
    return deco


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def default_config(name: str) -> ModelConfig:
    """The registered (pre-override) config for `name`."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown model '{name}'; available: {list_models()}")
    return _CONFIGS[name]


def get_model(name: str, **overrides) -> nn.Module:
    """Build a model by name; keyword overrides patch the registered
    config (e.g. `get_model('yolov3', compute_dtype=torch.float32)`).
    The module's weights are torch's defaults until loaded or set by
    `models.layers.init_weights`."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {list_models()}")
    cfg = dataclasses.replace(_CONFIGS[name], **overrides)
    check_input_size(cfg.input_size)
    if cfg.anchors is not None:
        check_anchor_table(cfg.anchors, cfg.family)
    model = _REGISTRY[name](cfg)
    model.config = cfg
    return model


def check_anchor_table(anchors, family: str) -> None:
    """Reject anchor tables the darknet heads can't consume: exactly 3
    levels of 3 positive (w, h) pairs."""
    if family not in ("yolov3", "rapid"):
        raise ValueError(f"anchors override is only meaningful for the "
                         f"darknet families (yolov3/rapid), not {family}")
    ok = (isinstance(anchors, (tuple, list)) and len(anchors) == 3
          and all(len(lvl) == 3 for lvl in anchors)
          and all(len(a) == 2 and float(a[0]) > 0 and float(a[1]) > 0
                  for lvl in anchors for a in lvl))
    if not ok:
        raise ValueError("anchors must be 3 levels (P5→P3) × 3 (w, h) "
                         f"pairs with positive sizes; got {anchors!r}")


def check_input_size(size: int) -> None:
    """Reject sizes the feature pyramid can't tile: the backbone
    downsamples by 32 and the neck re-merges levels with exact 2x
    upsampling."""
    if size < 32 or size % 32 != 0:
        raise ValueError(
            f"input_size must be a positive multiple of 32, got {size} "
            "(the backbone downsamples by 32 and the neck re-merges "
            "levels with exact 2x upsampling)")


def forward_dense(model: nn.Module, images: torch.Tensor) -> dict:
    """uint8 NHWC batch → the dense dict the postprocess takes, by
    family. yolov3: boxes (B, N, 4) xyxy and, single-label, scores
    (B, N) with classes (B, N), multi-label scores (B, N, C) = obj·cls,
    all from the f32 decode. retinanet: boxes (B, N, 4) xyxy f32 from
    the anchors, score_logits (B, N, C) in the compute dtype and, on
    multi-label configs, score_gate (B, N), the max-over-classes logit.
    fcos: the same with score_mul (B, N) = sigmoid(ctr); the sigmoid of
    the class logits waits until after the postprocess's top-k. rapid:
    boxes (B, N, 5) cxcywhθ (radians) and scores (B, N), float32."""
    cfg = model.config
    if cfg.family == "retinanet":
        cls_logits, deltas, *gate = model(images)
        anchors = retinanet.generate_anchors(int(images.shape[1]),
                                             images.device)
        out = {"boxes": retinanet.decode_boxes(deltas, anchors),
               "score_logits": cls_logits}
        if gate:
            out["score_gate"] = gate[0]
        return out
    if cfg.family == "fcos":
        cls_logits, ltrb, ctr, *gate = model(images)
        locations, _ = fcos.generate_locations(int(images.shape[1]),
                                               images.device)
        out = {"boxes": fcos.decode_boxes(ltrb, locations),
               "score_logits": cls_logits,
               "score_mul": torch.sigmoid(ctr)}
        if gate:
            out["score_gate"] = gate[0]
        return out
    if cfg.family == "rapid":
        anchors = cfg.anchors if cfg.anchors is not None else rapid.ANCHORS
        decoded = rapid.decode(model(images), anchors=anchors)
        return {"boxes": decoded["boxes5"], "scores": decoded["conf"]}
    anchors = cfg.anchors if cfg.anchors is not None else yolov3.ANCHORS
    if cfg.multi_label:
        decoded = yolov3.decode(model(images), cfg.num_classes,
                                anchors=anchors)
        return {"boxes": cxcywh_to_xyxy(decoded["boxes"]),
                "scores": yolov3.scores_from(decoded)}
    decoded = yolov3.decode_single_label(model(images), cfg.num_classes,
                                         anchors=anchors)
    return {"boxes": cxcywh_to_xyxy(decoded["boxes"]),
            "scores": decoded["scores"],
            "classes": decoded["classes"]}


def loss(model: nn.Module, images: torch.Tensor, gt_boxes: torch.Tensor,
         gt_classes: torch.Tensor, gt_valid: torch.Tensor, *,
         input_size: int | None = None) -> dict:
    """The training loss of a uint8 NHWC batch against padded GT: boxes
    (B, M, 4) cxcywh in net pixels (rapid: (B, M, 5) cxcywhθ, θ in
    radians), classes (B, M) int (unused by rapid), valid (B, M) bool.
    Scalar tensors by family, the JAX `_build_*.loss` terms: yolov3
    {"obj", "box", "cls", "total"}, rapid {"conf", "box", "angle",
    "total"}, retinanet {"cls", "box", "total"}, fcos {"cls", "box",
    "ctr", "total"}. `input_size` is the darknet box weight's size, the
    step's own input-size bucket (None: the config's). Run the model in
    train mode for batch-statistics BatchNorm, as
    `forward_raw(train=True)` does; the heads run without the
    max-over-classes gate."""
    cfg = model.config
    size = input_size or cfg.input_size
    if cfg.family == "yolov3":
        anchors = cfg.anchors if cfg.anchors is not None else yolov3.ANCHORS
        return yolov3.loss(model(images), gt_boxes, gt_classes, gt_valid,
                           input_size=size, num_classes=cfg.num_classes,
                           anchors=anchors)
    if cfg.family == "rapid":
        anchors = cfg.anchors if cfg.anchors is not None else rapid.ANCHORS
        return rapid.loss(model(images), gt_boxes, gt_valid,
                          input_size=size, anchors=anchors)
    if cfg.family == "retinanet":
        cls_logits, deltas = model(images, with_gate=False)
        anchors = retinanet.generate_anchors(int(images.shape[1]),
                                             images.device)
        return retinanet.loss(cls_logits.float(), deltas, anchors, gt_boxes,
                              gt_classes, gt_valid,
                              num_classes=cfg.num_classes)
    cls_logits, ltrb, ctr = model(images, with_gate=False)
    locations, strides = fcos.generate_locations(int(images.shape[1]),
                                                 images.device)
    return fcos.loss(cls_logits.float(), ltrb, ctr, locations, strides,
                     gt_boxes, gt_classes, gt_valid,
                     num_classes=cfg.num_classes)


def _build_yolov3(cfg: ModelConfig) -> nn.Module:
    return yolov3.YOLOv3(cfg.num_classes, cfg.compute_dtype)


def _build_rapid(cfg: ModelConfig) -> nn.Module:
    return yolov3.YOLOv3(cfg.num_classes, cfg.compute_dtype,
                         channels_per_anchor=rapid.CHANNELS_PER_ANCHOR)


def _build_retinanet(depth: int) -> Callable[[ModelConfig], nn.Module]:
    def build(cfg: ModelConfig) -> nn.Module:
        return retinanet.RetinaNet(depth, cfg.num_classes, cfg.compute_dtype,
                                   with_gate=cfg.multi_label)
    return build


def _build_fcos(cfg: ModelConfig) -> nn.Module:
    return fcos.FCOS(cfg.num_classes, cfg.compute_dtype,
                     ltrb_decode=cfg.ltrb_decode, with_gate=cfg.multi_label)


register("yolov3", ModelConfig(name="yolov3", family="yolov3",
                               num_classes=80, input_size=416,
                               multi_label=False))(_build_yolov3)
register("yolov3_608", ModelConfig(name="yolov3_608", family="yolov3",
                                   num_classes=80, input_size=608,
                                   multi_label=False))(_build_yolov3)
register("rapid", ModelConfig(name="rapid", family="rapid", num_classes=1,
                              input_size=1024, rotated=True, conf_thres=0.3,
                              pre_nms=512,
                              class_names=("person",)))(_build_rapid)
register("fcos", ModelConfig(name="fcos", family="fcos", num_classes=80,
                             input_size=608, conf_thres=0.05))(_build_fcos)
register("retinanet", ModelConfig(name="retinanet", family="retinanet",
                                  num_classes=80, input_size=608,
                                  conf_thres=0.05))(_build_retinanet(50))
register("retinanet_r101", ModelConfig(name="retinanet_r101",
                                       family="retinanet", num_classes=80,
                                       input_size=608,
                                       conf_thres=0.05))(_build_retinanet(101))
