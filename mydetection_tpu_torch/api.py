"""User-facing Detector API: build-by-name → detect on images.

A port of `mydetection_tpu/api.py` for the YOLOv3, RetinaNet, FCOS and
RAPiD families:

  host:   image load + letterbox (PIL, bilinear)
  device: the model's dense forward (`registry.forward_dense`) — yolov3:
          normalize → Darknet-53 → neck + heads → f32 decode;
          retinanet: ImageNet standardize → ResNet-50/101 → FPN → the
          class and box towers (10 launches of the CUDA conv-chain
          kernel) → output convs → anchor decode, class logits kept for
          the postprocess; fcos: the same backbone and FPN → GN towers
          (40 launches of the CUDA bias+GN+ReLU kernel) → heads → box
          decode; rapid: normalize → Darknet-53 → neck + 6-channel
          heads → f32 angle-aware decode —
          then the postprocess: top-k (two stages on multi-label
          configs, the class rows of the stage-1 boxes gathered by one
          CUDA kernel launch) → class-offset greedy NMS (one CUDA
          kernel launch for the whole batch) → max_dets rows + mask;
          rotated: top-k →
          the rotated-IoU matrix → the greedy suppress kernel (one
          launch for the batch) → max_dets rows + mask
  host:   strip invalid rows, inverse-letterbox to original pixels.

The device is explicit: `Detector(..., device=None)` means "cuda" and
raises when no GPU is present; pass `device="cpu"` to run on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from mydetection_tpu_torch import checkpoint as ckpt_lib
from mydetection_tpu_torch import weight_import as wi
from mydetection_tpu_torch.convert import from_jax_params, model_tree
from mydetection_tpu_torch.models.layers import init_weights
from mydetection_tpu_torch.ops.nms import postprocess
from mydetection_tpu_torch.ops.rotated import box_corners, rotated_postprocess
from mydetection_tpu_torch.registry import (
    check_input_size,
    forward_dense,
    get_model,
)
from mydetection_tpu_torch.utils.image_ops import (
    LetterboxInfo,
    boxes_xyxy_to_original,
    detections_to_original,
    letterbox_pil,
)


@dataclasses.dataclass
class Detections:
    """Final detections for one image, in ORIGINAL image pixel coords.

    boxes_xyxy: (K, 4) float32 axis-aligned corners (K = 0 is fine); for
                rotated models the unclipped envelope of each box.
    scores:     (K,) float32, descending.
    classes:    (K,) int32 contiguous class ids.
    boxes_rot:  (K, 5) float32 (cx, cy, w, h, θ radians) for rotated
                models, else None.
    """

    boxes_xyxy: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    boxes_rot: np.ndarray | None = None

    def __len__(self) -> int:
        return int(self.scores.shape[0])

    def as_array(self) -> np.ndarray:
        """Reference-style rows (x1, y1, x2, y2, score, cls) or, for
        rotated models, (cx, cy, w, h, θ degrees, score)."""
        if self.boxes_rot is not None:
            rot = self.boxes_rot.copy()
            rot[:, 4] = np.degrees(rot[:, 4])
            return np.concatenate([rot, self.scores[:, None]], axis=1)
        return np.concatenate(
            [self.boxes_xyxy, self.scores[:, None],
             self.classes[:, None].astype(np.float32)], axis=1)

    def to_coco(self, image_id: int,
                category_map: Sequence[int] | None = None) -> list[dict]:
        """COCO results-JSON rows (bbox xywh top-left) for evaluation."""
        out = []
        for box, score, cls in zip(self.boxes_xyxy, self.scores, self.classes):
            x1, y1, x2, y2 = (float(v) for v in box)
            cat = int(cls) if category_map is None else int(category_map[int(cls)])
            out.append({"image_id": int(image_id), "category_id": cat,
                        "bbox": [x1, y1, x2 - x1, y2 - y1],
                        "score": float(score)})
        return out


def load_image_any(im):
    """Path / PIL image / uint8 HWC ndarray → PIL image."""
    from PIL import Image

    if isinstance(im, str):
        return Image.open(im)
    if isinstance(im, np.ndarray):
        return Image.fromarray(im)
    if isinstance(im, Image.Image):
        return im
    raise TypeError(f"expected an image path, PIL image or ndarray, got "
                    f"{type(im).__name__}")


def strip_detections(out: dict, i: int, info: LetterboxInfo, *,
                     rotated: bool = False) -> Detections:
    """Padded host output row `i` → `Detections` in original pixels.
    Rotated rows map back with their angle kept (radians), and their
    xyxy is the envelope of the box's corners, not clipped to the image
    (the JAX package does not clip it either)."""
    valid = out["valid"][i]
    scores = out["scores"][i][valid].astype(np.float32)
    classes = out["classes"][i][valid].astype(np.int32)
    boxes = out["boxes"][i][valid].astype(np.float32)
    if rotated:
        rot = detections_to_original(boxes, info)
        corners = box_corners(torch.from_numpy(rot)).numpy()   # (K, 4, 2)
        xyxy = np.concatenate([corners.min(axis=1), corners.max(axis=1)],
                              axis=1)
        return Detections(boxes_xyxy=xyxy, scores=scores, classes=classes,
                          boxes_rot=rot)
    return Detections(boxes_xyxy=boxes_xyxy_to_original(boxes, info),
                      scores=scores, classes=classes)


def make_post(cfg):
    """Dense batch → padded detections for a model config: the JAX
    package's `make_post_one`, with the batch axis written out in place
    of its vmap, so NMS launches once per batch."""

    def post(dense: dict, conf_thres: torch.Tensor, nms_iou: float) -> dict:
        if cfg.rotated:
            return rotated_postprocess(dense["boxes"], dense["scores"],
                                       conf_thres=conf_thres,
                                       iou_thres=nms_iou, pre_nms=cfg.pre_nms,
                                       max_dets=cfg.max_dets)
        return postprocess(dense["boxes"], dense.get("scores"),
                           dense.get("classes"),
                           score_logits=dense.get("score_logits"),
                           score_mul=dense.get("score_mul"),
                           gate_logits=dense.get("score_gate"),
                           conf_thres=conf_thres, iou_thres=nms_iou,
                           pre_nms=cfg.pre_nms, max_dets=cfg.max_dets,
                           multi_label=cfg.multi_label)

    return post


def _conf_vector(conf_thres, n_real: int, b: int) -> np.ndarray:
    """One float for the batch, or one per real image; padding rows
    (b > n_real) reuse the last value, their outputs are dropped."""
    if np.ndim(conf_thres) == 0:
        return np.full((b,), conf_thres, np.float32)
    cv = np.asarray(conf_thres, np.float32)
    if len(cv) != n_real:
        raise ValueError(f"per-image conf_thres has {len(cv)} entries for "
                         f"{n_real} images")
    return np.concatenate([cv, np.repeat(cv[-1:], b - len(cv))])


class Detector:
    """Build a detector by name and run inference.

    Example:
        det = Detector(model_name='yolov3', weights_path='weights/x.npz')
        detections = det.detect_one(img_path='dog.jpg', conf_thres=0.3)

    `params` takes a JAX parameter tree, nested or flattened with
    `checkpoint.flatten_tree`; `weights_path` an `.npz` checkpoint, a
    darknet `.weights` file (yolov3, rapid) or a torchvision `.pt` /
    `.pth` state dict (retinanet, fcos with `ltrb_decode="linear"`);
    with neither, the weights come from `init_weights(model,
    rng_seed)`.
    """

    def __init__(self, model_name: str = "yolov3",
                 weights_path: str | None = None, *, params=None,
                 rng_seed: int = 0, device: str | torch.device | None = None,
                 **config_overrides):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector runs on CUDA by default and no GPU "
                               "is visible; pass device='cpu' to run on the "
                               "CPU")
        self.device = device
        self.model = get_model(model_name, **config_overrides)
        self.cfg = self.model.config
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                params = ckpt_lib.flatten_tree(params)
            self.model.load_state_dict(from_jax_params(params), strict=True)
        elif weights_path is not None:
            self.model.load_state_dict(
                self._load_weights(weights_path, rng_seed), strict=True)
        else:
            init_weights(self.model, rng_seed)
        self.model.eval().requires_grad_(False).to(device)
        if device.type == "cuda":  # cuDNN's NHWC convs; inputs arrive NHWC
            self.model.to(memory_format=torch.channels_last)
        self._post = make_post(self.cfg)

    def _load_weights(self, path: str, rng_seed: int) -> dict:
        """A state_dict from a weights file, by its format:

          *.npz          the checkpoint format both packages write,
                         checked against the model's geometry first;
          *.weights      a darknet binary (yolov3 and rapid only);
          *.pt / *.pth   a torch checkpoint, through the torchvision
                         RetinaNet or FCOS importer.

        The importers fill the JAX-named tree of the model at
        `init_weights(rng_seed)`, so what a file lacks (FCOS's per-level
        scales) keeps that init."""
        lower = path.lower()
        if lower.endswith(".weights"):
            if self.cfg.family not in ("yolov3", "rapid"):
                raise ValueError(
                    f"darknet .weights files hold Darknet-53-family "
                    f"parameters (yolov3/rapid), not '{self.cfg.name}' — "
                    "use an .npz checkpoint or a torch .pt with the "
                    "matching importer")
            return self._import(wi.load_darknet_weights, path, rng_seed)
        if lower.endswith((".pt", ".pth")):
            state = wi.load_torch_checkpoint(path)
            name = self.cfg.name
            if name.startswith("retinanet"):
                return self._import(wi.import_retinanet_state_dict, state,
                                    rng_seed)
            if name.startswith("fcos"):
                if self.cfg.ltrb_decode != "linear":
                    raise ValueError(
                        "torchvision FCOS checkpoints regress relu-linear "
                        "ltrb (not the paper's exp decode this framework "
                        "trains with) — construct the detector with "
                        "Detector(model_name='fcos', ltrb_decode='linear', "
                        "weights_path=...) so imported boxes decode "
                        "correctly")
                return self._import(wi.import_fcos_state_dict, state,
                                    rng_seed)
            raise ValueError(
                f"no torch-checkpoint importer for model '{name}'; use "
                "weight_import.import_state_dict with an explicit name "
                "mapping, or convert to .npz via checkpoint.save_checkpoint")
        params = ckpt_lib.load_params(path)
        ckpt_lib.check_params_compatible(model_tree(self.model), params,
                                         context=f" '{self.cfg.name}'")
        return from_jax_params(ckpt_lib.flatten_tree(params))

    def _import(self, importer, source, rng_seed: int) -> dict:
        """`importer(template, source)` on the JAX-named tree of the
        model at `init_weights(rng_seed)` → a state_dict."""
        init_weights(self.model, rng_seed)
        return from_jax_params(ckpt_lib.flatten_tree(
            importer(model_tree(self.model), source)))

    def _run_batch(self, canvases, conf_thres, nms_iou: float,
                   n_real: int) -> dict:
        """uint8 (B, S, S, 3) canvases (numpy, or a tensor on any
        device) → padded detections as host numpy arrays."""
        images = torch.as_tensor(canvases).to(self.device)
        if images.dtype != torch.uint8 or images.dim() != 4 \
                or images.shape[-1] != 3:
            raise ValueError(f"expected uint8 (B, S, S, 3) canvases, got "
                             f"{tuple(images.shape)} {images.dtype}")
        check_input_size(int(images.shape[1]))
        conf = torch.from_numpy(
            _conf_vector(conf_thres, n_real, images.shape[0])).to(self.device)
        with torch.inference_mode():
            out = self._post(forward_dense(self.model, images), conf,
                             float(nms_iou))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _strip(self, out: dict, i: int, info: LetterboxInfo) -> Detections:
        return strip_detections(out, i, info, rotated=self.cfg.rotated)

    # -- public surface ----------------------------------------------------

    def warmup(self, *, input_sizes: Sequence[int] | None = None,
               batch_size: int = 1) -> None:
        """Run one zero batch per input size, so the first request does
        not pay for cuDNN autotuning or the kernels' builds."""
        for s in input_sizes or [self.cfg.input_size]:
            check_input_size(s)
            canvas = np.zeros((batch_size, s, s, 3), np.uint8)
            self._run_batch(canvas, self.cfg.conf_thres, self.cfg.nms_iou,
                            batch_size)

    def detect_one(self, *, img_path=None, pil_img=None, np_img=None,
                   conf_thres: float | None = None,
                   nms_iou: float | None = None,
                   input_size: int | None = None) -> Detections:
        """Detect objects on one image (a path, PIL image or ndarray)."""
        src = next((x for x in (img_path, pil_img, np_img) if x is not None),
                   None)
        if src is None:
            raise ValueError("provide one of img_path / pil_img / np_img")
        return self.detect_batch([src], conf_thres=conf_thres,
                                 nms_iou=nms_iou, input_size=input_size)[0]

    def detect_batch(self, images: Iterable, *,
                     conf_thres: float | None = None,
                     nms_iou: float | None = None,
                     input_size: int | None = None) -> list[Detections]:
        """Batched detection over an iterable of paths / PIL / ndarray."""
        size = input_size or self.cfg.input_size
        check_input_size(size)
        conf = conf_thres if conf_thres is not None else self.cfg.conf_thres
        iou = nms_iou if nms_iou is not None else self.cfg.nms_iou
        canvases, infos = [], []
        for im in images:
            canvas, info = letterbox_pil(load_image_any(im), size)
            canvases.append(canvas)
            infos.append(info)
        if not canvases:
            return []
        out = self._run_batch(np.stack(canvases), conf, iou, len(infos))
        return [self._strip(out, i, info) for i, info in enumerate(infos)]

    # reference-name alias (detect_imgSeq in myDetection's api.py)
    def detect_imgSeq(self, img_paths: Sequence[str], **kw) -> list[Detections]:
        return self.detect_batch(list(img_paths), **kw)

    def detect_prepared(self, canvases, infos: Sequence[LetterboxInfo], *,
                        conf_thres=None,
                        nms_iou: float | None = None) -> list[Detections]:
        """Detect on already-letterboxed uint8 canvases (B, S, S, 3),
        numpy or a tensor already on the device; only the first
        len(infos) rows are real. conf_thres: one float, or one per
        image (len == len(infos))."""
        conf = conf_thres if conf_thres is not None else self.cfg.conf_thres
        iou = nms_iou if nms_iou is not None else self.cfg.nms_iou
        out = self._run_batch(canvases, conf, iou, len(infos))
        return [self._strip(out, i, info) for i, info in enumerate(infos)]
