"""Train-time augmentations: HSV jitter, flips, rotation (angle-aware).

Reference parity: the augmentation set of `datasets.py` in
duanzhiihao/myDetection [recalled; SURVEY.md §2.11] — HSV color
jitter, horizontal/vertical flips, and rotation kept exact for
fisheye data via angle-aware label transforms (RAPiD trains on
overhead imagery where arbitrary rotation is a symmetry).

All host-side numpy/PIL; labels are cxcywh(θ rad) in image pixels.
A verbatim copy of `mydetection_tpu/data/transforms.py`: the arithmetic
and the order of the RNG draws are kept as they are, so the same
`RandomState` gives bit-equal images and labels in both packages.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def hsv_jitter(image: np.ndarray, rng: np.random.RandomState, *,
               h_gain: float = 0.015, s_gain: float = 0.7,
               v_gain: float = 0.4) -> np.ndarray:
    """YOLO-style random HSV distortion of a uint8 RGB image."""
    gains = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hsv = np.asarray(Image.fromarray(image).convert("HSV"), np.float32)
    hsv[..., 0] = (hsv[..., 0] * gains[0]) % 256
    hsv[..., 1] = np.clip(hsv[..., 1] * gains[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * gains[2], 0, 255)
    return np.asarray(
        Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB"))


def hflip(image: np.ndarray, boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal flip; negates θ for rotated boxes."""
    w = image.shape[1]
    out = boxes.copy()
    if len(out):
        out[:, 0] = w - out[:, 0]
        if out.shape[1] == 5:
            out[:, 4] = -out[:, 4]
    return image[:, ::-1], out


def vflip(image: np.ndarray, boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vertical flip; negates θ for rotated boxes."""
    h = image.shape[0]
    out = boxes.copy()
    if len(out):
        out[:, 1] = h - out[:, 1]
        if out.shape[1] == 5:
            out[:, 4] = -out[:, 4]
    return image[::-1], out


def rotate(image: np.ndarray, boxes: np.ndarray, degrees: float,
           *, expand: bool = False
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rotate image CCW about its center; exact label transform.

    For rotated (5-col) boxes the transform is exact: centers rotate,
    θ += angle (wrapped to (-π/2, π/2] with w/h swap when crossing —
    the box is invariant under θ→θ+π, and θ±π/2 with w↔h).
    For axis-aligned (4-col) boxes the rotated box is re-enclosed
    axis-aligned (standard approximation; the reference restricts
    arbitrary rotation to the rotated-label fisheye datasets).

    Returns (image, kept_boxes, keep_mask) — keep_mask indexes the
    INPUT boxes so callers can filter parallel arrays (class ids).
    """
    h, w = image.shape[:2]
    pil = Image.fromarray(image).rotate(degrees, resample=Image.BILINEAR,
                                        expand=expand, fillcolor=(114, 114, 114))
    out_img = np.asarray(pil)
    nh, nw = out_img.shape[:2]
    rad = np.radians(degrees)
    cos, sin = np.cos(rad), np.sin(rad)
    out = boxes.copy()
    if len(out):
        # image-coord y grows downward: CCW visual rotation maps
        # (x, y) -> (cx + c*(x-cx) + s*(y-cy), cy - s*(x-cx) + c*(y-cy))
        dx = out[:, 0] - w / 2
        dy = out[:, 1] - h / 2
        out[:, 0] = cos * dx + sin * dy + nw / 2
        out[:, 1] = -sin * dx + cos * dy + nh / 2
        if out.shape[1] == 5:
            # θ wraps with period π (a rect is invariant under θ→θ+π),
            # so wrapping into (-π/2, π/2] is exact — no w/h swap needed
            out[:, 4] = np.mod(out[:, 4] - rad + np.pi / 2, np.pi) - np.pi / 2
        else:
            # enclose the rotated rectangle axis-aligned
            bw, bh = out[:, 2], out[:, 3]
            out[:, 2] = np.abs(cos) * bw + np.abs(sin) * bh
            out[:, 3] = np.abs(sin) * bw + np.abs(cos) * bh
        if not expand:
            # objects whose center rotated off the (uncropped) canvas
            # are no longer visible — keeping them would turn invisible
            # objects into positive training targets at clipped border
            # cells
            keep = ((out[:, 0] >= 0) & (out[:, 0] < nw)
                    & (out[:, 1] >= 0) & (out[:, 1] < nh))
            out = out[keep]
        else:
            keep = np.ones(len(out), bool)
    else:
        keep = np.ones(0, bool)
    return out_img, out, keep


def random_augment(image: np.ndarray, boxes: np.ndarray,
                   rng: np.random.RandomState, *, rotated: bool = False,
                   rotate_prob: float = 0.0, classes: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """The reference's default train-time pipeline.

    Returns (image, boxes, classes); `classes` (when given) is filtered
    in lockstep with boxes that rotation drops off-canvas. Because
    rotation can DROP boxes, `classes` is required when rotate_prob > 0
    — a caller keeping a separate parallel array would otherwise
    silently desync from the returned boxes.
    """
    if rotate_prob > 0 and classes is None:
        raise ValueError(
            "random_augment(rotate_prob>0) requires `classes`: rotation "
            "drops off-canvas boxes, so any parallel per-box array must "
            "be filtered in lockstep (pass classes, even if synthetic)")
    image = hsv_jitter(image, rng)
    if rng.rand() < 0.5:
        image, boxes = hflip(image, boxes)
    if rotated and rng.rand() < 0.5:
        image, boxes = vflip(image, boxes)
    # rotation honors an explicit rotate_prob for axis-aligned labels
    # too (enclosing-box approximation); it defaults on only for
    # rotated datasets (see TrainLoader)
    if rotate_prob > 0 and rng.rand() < rotate_prob:
        image, boxes, keep = rotate(image, boxes, float(rng.uniform(0, 360)))
        if classes is not None:
            classes = classes[keep]
    return np.ascontiguousarray(image), boxes, classes
