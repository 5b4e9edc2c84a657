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

`Detector(..., quantized=True | path)` swaps the dense forward for the
int8 one (`quant.forward_dense_quantized`: the float prologue, int8
convs through im2col and `torch._int_mm`, float output convs; fcos's
towers launch the GN kernel 40 times at float32), before the same
postprocess. `use_pallas=False` (the JAX package's name) runs every
kernel's plain version instead, on whatever device the Detector runs
on; `data_parallel=True` splits each batch over every local CUDA
device (`parallel.mesh`); `detect_one(visualize=, save_path=)` draws
the detections (`utils.visualization`).

The device is explicit: `Detector(..., device=None)` means "cuda" and
raises when no GPU is present; pass `device="cpu"` to run on the CPU.

Under `utils.profiling.recording()` each `detect_prepared` /
`detect_batch` call records a `detect.batch` span holding
`detect.letterbox` (`detect_batch` only), `detect.inputs`,
`detect.forward`, `detect.post`, `detect.copy_back` and `detect.strip`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Iterable, Sequence

import numpy as np
import torch

from mydetection_tpu_torch import checkpoint as ckpt_lib
from mydetection_tpu_torch import quant
from mydetection_tpu_torch import weight_import as wi
from mydetection_tpu_torch.convert import from_jax_params, model_tree
from mydetection_tpu_torch.kernels.route import plain_versions
from mydetection_tpu_torch.models.layers import init_weights
from mydetection_tpu_torch.ops.nms import postprocess
from mydetection_tpu_torch.ops.rotated import box_corners, rotated_postprocess
from mydetection_tpu_torch.parallel.mesh import shard_batch
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
from mydetection_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Detections:
    """Final detections for one image, in ORIGINAL image pixel coords.

    boxes_xyxy: (K, 4) float32 axis-aligned corners (K = 0 is fine); for
                rotated models the unclipped envelope of each box.
    scores:     (K,) float32, descending.
    classes:    (K,) int32 contiguous class ids.
    boxes_rot:  (K, 5) float32 (cx, cy, w, h, θ radians) for rotated
                models, else None.
    visualized: uint8 RGB render of the detections over the original
                image; set only by `detect_one(visualize=True)`.
    """

    boxes_xyxy: np.ndarray
    scores: np.ndarray
    classes: np.ndarray
    boxes_rot: np.ndarray | None = None
    visualized: np.ndarray | None = None

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


def load_image_any(*sources):
    """The first of `sources` that is not None (a path, PIL image or
    uint8 HWC ndarray) → PIL image."""
    from PIL import Image

    im = next((x for x in sources if x is not None), None)
    if im is None:
        raise ValueError("provide one of img_path / pil_img / np_img")
    if isinstance(im, str):
        return Image.open(im)
    if isinstance(im, np.ndarray):
        return Image.fromarray(im)
    if isinstance(im, Image.Image):
        return im
    raise TypeError(f"expected an image path, PIL image or ndarray, got "
                    f"{type(im).__name__}")


def finalize_visualize(dets: Detections, img, class_names, visualize: bool,
                       save_path: str | None) -> Detections:
    """Draw the detections over the original PIL `img` when asked: keep
    the render on `dets.visualized` (visualize) and/or write it to
    `save_path`. The shared tail of `detect_one`, live and exported."""
    if visualize or save_path:
        from PIL import Image

        from mydetection_tpu_torch.utils.visualization import draw_detections

        vis = draw_detections(np.asarray(img.convert("RGB")), dets,
                              class_names=class_names)
        if save_path:
            Image.fromarray(vis).save(save_path)
        if visualize:
            dets.visualized = vis
    return dets


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


def _make_forward_dense(det: "Detector"):
    """The dense forward a Detector serves: the int8 one when it was
    built quantized, else the float model's."""
    if det._q is not None:
        qp, cfg = det._q, det.cfg
        return lambda images: quant.forward_dense_quantized(qp, images, cfg)
    model = det.model
    return lambda images: forward_dense(model, images)


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
    rng_seed)`. `quantized=True` serves the int8 path calibrated on
    `calib_images` (None: noise); `quantized="<artifact>.npz"` serves a
    `save_quantized` artifact of either package and skips the float
    weights unless `params` or `weights_path` is given.

    `use_pallas`: None or True runs the hand-written kernels (on the
    card; their plain versions on the CPU); False runs every kernel's
    plain version on every device, as the JAX package's
    `use_pallas=False` restores its oracle path. Only the caller picks
    it: nothing falls back to it. `data_parallel=True` holds one copy of
    the model on each local CUDA device and splits every batch over
    them; with one device it is the single-device path. `pack_input`
    (the TPU stem's space-to-depth input layout) is not implemented.
    """

    # the padded graph takes one conf_thres per image (`_conf_vector`),
    # so the serving daemon coalesces mixed-threshold requests
    supports_conf_vector = True

    def __init__(self, model_name: str = "yolov3",
                 weights_path: str | None = None, *, params=None,
                 rng_seed: int = 0, device: str | torch.device | None = None,
                 use_pallas: bool | None = None, data_parallel: bool = False,
                 quantized: bool | str = False,
                 calib_images: Sequence | None = None,
                 pack_input: bool = False, **config_overrides):
        if pack_input:
            raise ValueError("pack_input is the TPU darknet stem's "
                             "space-to-depth input layout; the PyTorch "
                             "port runs the standard stem on (B, S, S, 3) "
                             "canvases and does not implement it")
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Detector runs on CUDA by default and no GPU "
                               "is visible; pass device='cpu' to run on the "
                               "CPU")
        self.device = device
        self.use_pallas = use_pallas is None or bool(use_pallas)
        # served from an int8 artifact, the float weights are never
        # read: the model is built on the meta device (no init, no
        # memory) and only names the config
        float_unused = isinstance(quantized, str) and params is None \
            and weights_path is None
        with torch.device("meta") if float_unused \
                else contextlib.nullcontext():
            self.model = get_model(model_name, **config_overrides)
        self.cfg = self.model.config
        if not float_unused:
            self._set_weights(params, weights_path, rng_seed)
        # the opt-in int8 serving path (quant.py, quant_resnet.py): BN
        # folded per-channel int8 weights and static activation scales
        # from a calibration pass over `calib_images` (paths / PIL /
        # arrays, letterboxed to the serving size; None: noise, which
        # keeps the pipeline working but costs accuracy), or a
        # `save_quantized` artifact's path
        self._q = None
        if isinstance(quantized, str):
            self._q = quant.load_quantized(quantized, self.cfg, device=device)
        elif quantized:
            self._q = self._quantize(calib_images)
        self._forward_dense = _make_forward_dense(self)
        self._post = make_post(self.cfg)
        # data parallel: (device, dense forward) a device, the model or
        # int8 tree copied to each; None on one device
        self._replicas = None
        if data_parallel:
            self._replicas = self._replicate()

    def _replicate(self):
        from mydetection_tpu_torch.parallel.mesh import make_mesh, replicate

        mesh = make_mesh()
        if len(mesh) < 2:
            return None
        own = self.device
        if own.type == "cuda" and own.index is None:
            own = torch.device("cuda", torch.cuda.current_device())
        if own not in mesh:
            raise ValueError(f"data_parallel splits batches over {mesh}; "
                             f"this Detector runs on {self.device}")
        # this Detector's device keeps its own model and forward; only
        # the others get a copy
        mesh.remove(own)
        if self._q is not None:
            cfg = self.cfg
            copies = [lambda images, q=q: quant.forward_dense_quantized(
                          q, images, cfg) for q in replicate(self._q, mesh)]
        else:
            copies = [functools.partial(forward_dense, m)
                      for m in replicate(self.model, mesh)]
        return [(own, self._forward_dense), *zip(mesh, copies)]

    def _set_weights(self, params, weights_path: str | None,
                     rng_seed: int) -> None:
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                params = ckpt_lib.flatten_tree(params)
            self.model.load_state_dict(from_jax_params(params), strict=True)
        elif weights_path is not None:
            self.model.load_state_dict(
                self._load_weights(weights_path, rng_seed), strict=True)
        else:
            init_weights(self.model, rng_seed)
        self.model.eval().requires_grad_(False).to(self.device)
        if self.device.type == "cuda":  # cuDNN's NHWC convs; NHWC inputs
            self.model.to(memory_format=torch.channels_last)

    def _quantize(self, calib_images):
        """Calibrate and quantize the float model at the serving size:
        one batch of the letterboxed `calib_images`, or (None) two
        noise batches of 2 from RandomState(0)."""
        size = self.cfg.input_size
        if calib_images is None:
            rng = np.random.RandomState(0)
            batches = [rng.randint(0, 256, (2, size, size, 3), np.uint8)
                       for _ in range(2)]
        else:
            if not len(calib_images):
                raise ValueError(
                    "calib_images is empty — pass real images to "
                    "calibrate on, or calib_images=None for the noise "
                    "fallback (functional but costs mAP)")
            batches = [np.stack([letterbox_pil(load_image_any(im), size)[0]
                                 for im in calib_images])]
        return quant.quantize_model(self.model, batches)

    def save_quantized(self, path: str) -> None:
        """Write the calibrated int8 artifact; a later process serves it
        with Detector(..., quantized=path), without recalibrating."""
        if self._q is None:
            raise ValueError("this Detector is not quantized — build it "
                             "with quantized=True first")
        quant.save_quantized(path, self._q, self.cfg)

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
        with span("detect.inputs"):
            images = torch.as_tensor(canvases).to(self.device)
            if images.dtype != torch.uint8 or images.dim() != 4 \
                    or images.shape[-1] != 3:
                raise ValueError(f"expected uint8 (B, S, S, 3) canvases, "
                                 f"got {tuple(images.shape)} {images.dtype}")
            check_input_size(int(images.shape[1]))
            conf = torch.from_numpy(
                _conf_vector(conf_thres, n_real, images.shape[0]))
            if self._replicas is None:
                conf = conf.to(self.device)
            else:
                mesh = [dev for dev, _ in self._replicas]
                # shard_batch leaves out only trailing empty chunks, so
                # the chunks line up with the first replicas
                chunks = zip(self._replicas, shard_batch(images, mesh),
                             shard_batch(conf, mesh))
        with torch.inference_mode(), plain_versions(not self.use_pallas):
            if self._replicas is None:
                with span("detect.forward"):
                    dense = self._forward_dense(images)
                with span("detect.post"):
                    out = self._post(dense, conf, float(nms_iou))
                with span("detect.copy_back"):
                    return {k: v.cpu().numpy() for k, v in out.items()}
            outs = []
            for i, ((_, forward), (_, chunk), (_, c)) in enumerate(chunks):
                with span("detect.forward", replica=i):
                    dense = forward(chunk)
                with span("detect.post", replica=i):
                    outs.append(self._post(dense, c, float(nms_iou)))
            host = []
            for i, o in enumerate(outs):
                with span("detect.copy_back", replica=i):
                    host.append({k: v.cpu() for k, v in o.items()})
        return {k: torch.cat([h[k] for h in host]).numpy() for k in host[0]}

    def _strip(self, out: dict, infos) -> list[Detections]:
        with span("detect.strip"):
            return [strip_detections(out, i, info, rotated=self.cfg.rotated)
                    for i, info in enumerate(infos)]

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
                   input_size: int | None = None, visualize: bool = False,
                   save_path: str | None = None) -> Detections:
        """Detect objects on one image (a path, PIL image or ndarray).
        visualize: keep a render of the detections over the image on
        the result's `visualized`; save_path: write that render there."""
        img = load_image_any(img_path, pil_img, np_img)
        dets = self.detect_batch([img], conf_thres=conf_thres,
                                 nms_iou=nms_iou, input_size=input_size)[0]
        return finalize_visualize(dets, img, self.cfg.class_names, visualize,
                                  save_path)

    def detect_batch(self, images: Iterable, *,
                     conf_thres: float | None = None,
                     nms_iou: float | None = None,
                     input_size: int | None = None) -> list[Detections]:
        """Batched detection over an iterable of paths / PIL / ndarray."""
        size = input_size or self.cfg.input_size
        check_input_size(size)
        conf = conf_thres if conf_thres is not None else self.cfg.conf_thres
        iou = nms_iou if nms_iou is not None else self.cfg.nms_iou
        images = list(images)
        if not images:
            return []
        with span("detect.batch", new_step=True, size=len(images)):
            canvases, infos = [], []
            with span("detect.letterbox"):
                for im in images:
                    canvas, info = letterbox_pil(load_image_any(im), size)
                    canvases.append(canvas)
                    infos.append(info)
            out = self._run_batch(np.stack(canvases), conf, iou, len(infos))
            return self._strip(out, infos)

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
        with span("detect.batch", new_step=True, size=len(infos)):
            out = self._run_batch(canvases, conf, iou, len(infos))
            return self._strip(out, infos)
