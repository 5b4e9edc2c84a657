"""Host-side image geometry: letterbox + inverse mapping.

A copy of the letterbox geometry of `mydetection_tpu/utils/image_ops.py`
(numpy; PIL only for the resize, imported where it is used): an image
is resized to fit `input_size` with its aspect ratio kept (bilinear),
centre-padded with gray to a square, and detections map back with the
recorded (ratio, pad) pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD_VALUE = 114  # gray padding, standard letterbox fill
# decodable-by-PIL image extensions, shared by the CLIs and
# `anchors`/evaluation so the lists cannot diverge
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


@dataclasses.dataclass(frozen=True)
class LetterboxInfo:
    """Geometry record needed to invert a letterbox transform."""

    ori_w: int
    ori_h: int
    ratio: float   # scale from original pixels -> network pixels
    pad_x: float   # left pad in network pixels
    pad_y: float   # top pad in network pixels
    input_size: int


def letterbox_pil(img, input_size: int) -> tuple[np.ndarray, LetterboxInfo]:
    """Resize-preserving-aspect + center-pad a PIL image to a square.

    Returns (uint8 HWC RGB array of shape (input_size, input_size, 3),
    LetterboxInfo). Resampling is pinned to bilinear.
    """
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    ori_w, ori_h = img.size
    if ori_w == 0 or ori_h == 0:
        raise ValueError(f"empty image ({ori_w}x{ori_h}) cannot be "
                         "letterboxed")
    ratio = input_size / max(ori_w, ori_h)
    new_w = max(1, int(round(ori_w * ratio)))
    new_h = max(1, int(round(ori_h * ratio)))
    resized = img.resize((new_w, new_h), resample=Image.BILINEAR)

    canvas = np.full((input_size, input_size, 3), PAD_VALUE, dtype=np.uint8)
    # floor split of the padding (the JAX package's native path agrees)
    x0 = (input_size - new_w) // 2
    y0 = (input_size - new_h) // 2
    canvas[y0:y0 + new_h, x0:x0 + new_w] = np.asarray(resized, dtype=np.uint8)
    info = LetterboxInfo(
        ori_w=ori_w, ori_h=ori_h, ratio=ratio, pad_x=float(x0),
        pad_y=float(y0), input_size=input_size,
    )
    return canvas, info


def letterbox_np(img: np.ndarray, input_size: int
                 ) -> tuple[np.ndarray, LetterboxInfo]:
    """Letterbox a uint8 HWC RGB numpy array (PIL does the resize)."""
    from PIL import Image

    return letterbox_pil(Image.fromarray(img), input_size)


def detections_to_original(dets: np.ndarray, info: LetterboxInfo
                           ) -> np.ndarray:
    """Map rows with cxcywh in columns 0:4 (rotated rows carry θ after
    them, which a uniform letterbox ratio leaves as it is) from network
    to original coords. Returns a float32 copy."""
    out = np.array(dets, dtype=np.float32, copy=True)
    if out.size == 0:
        return out
    out[:, 0] = (out[:, 0] - info.pad_x) / info.ratio
    out[:, 1] = (out[:, 1] - info.pad_y) / info.ratio
    out[:, 2] = out[:, 2] / info.ratio
    out[:, 3] = out[:, 3] / info.ratio
    return out


def boxes_xyxy_to_original(boxes: np.ndarray, info: LetterboxInfo,
                           clip: bool = True) -> np.ndarray:
    """Map xyxy boxes in network coords to original coords (and clip)."""
    out = np.array(boxes, dtype=np.float32, copy=True)
    if out.size == 0:
        return out
    out[:, 0] = (out[:, 0] - info.pad_x) / info.ratio
    out[:, 2] = (out[:, 2] - info.pad_x) / info.ratio
    out[:, 1] = (out[:, 1] - info.pad_y) / info.ratio
    out[:, 3] = (out[:, 3] - info.pad_y) / info.ratio
    if clip:
        out[:, 0::2] = np.clip(out[:, 0::2], 0.0, info.ori_w)
        out[:, 1::2] = np.clip(out[:, 1::2], 0.0, info.ori_h)
    return out
