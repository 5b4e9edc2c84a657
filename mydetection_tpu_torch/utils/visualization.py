"""Draw detections on numpy images (host side, cv2).

A copy of `mydetection_tpu/utils/visualization.py`: axis-aligned boxes
as rectangles, rotated boxes as their four corners, each with its class
label and score, in a colour drawn from the class id. Without cv2 the
image comes back as an unmarked copy.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def has_cv2() -> bool:
    """Whether `draw_detections` draws (cv2 imports) or copies."""
    return _HAS_CV2


def _color(cls_id: int) -> tuple[int, int, int]:
    rng = np.random.RandomState(int(cls_id) + 7)
    return tuple(int(v) for v in rng.randint(64, 255, size=3))


def draw_detections(img_rgb: np.ndarray, dets, *, class_names=None,
                    line_width: int = 2) -> np.ndarray:
    """Draw a `Detections` record onto a copy of an RGB uint8 image."""
    if not _HAS_CV2:
        return img_rgb.copy()
    out = np.ascontiguousarray(img_rgb.copy())
    rot = getattr(dets, "boxes_rot", None)
    for i in range(len(dets)):
        cls_id = int(dets.classes[i])
        color = _color(cls_id)
        label = (class_names[cls_id]
                 if class_names and 0 <= cls_id < len(class_names)
                 else str(cls_id))
        text = f"{label} {float(dets.scores[i]):.2f}"
        if rot is not None:
            cx, cy, w, h, th = (float(v) for v in rot[i])
            rect = cv2.boxPoints(((cx, cy), (w, h), np.degrees(th)))
            cv2.polylines(out, [rect.astype(np.int32)], True, color,
                          line_width)
            org = (int(cx - w / 2), max(12, int(cy - h / 2) - 4))
        else:
            x1, y1, x2, y2 = (int(v) for v in dets.boxes_xyxy[i])
            cv2.rectangle(out, (x1, y1), (x2, y2), color, line_width)
            org = (x1, max(12, y1 - 4))
        cv2.putText(out, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1,
                    cv2.LINE_AA)
    return out
