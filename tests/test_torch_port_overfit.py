"""The port's training stack learns: `tests/test_overfit.py`'s three
learning tests against the port's own `make_train_step` on the CPU in
float32, from `init_weights(seed 0)`.

Overfitting a tiny fixed batch checks the whole loop at once — target
assignment, the loss, its gradients, SGD with burn-in and the BN
statistics — and train-then-detect checks that what the step learns is
what the `Detector`'s decode reads. Marked slow (the Tier-1 run leaves
them out); `python -m pytest -m slow tests/test_torch_port_overfit.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mydetection_tpu_torch import Detector, registry  # noqa: E402
from mydetection_tpu_torch.convert import to_jax_params  # noqa: E402
from mydetection_tpu_torch.models.layers import init_weights  # noqa: E402
from mydetection_tpu_torch.training import burn_in_lr, make_train_step  # noqa: E402

B, S = 2, 64


def _step(name: str, **cfg):
    model = registry.get_model(name, input_size=S,
                               compute_dtype=torch.float32, **cfg)
    init_weights(model, 0)
    return model, make_train_step(model, input_size=S, device="cpu")


def _overfit(step, images, boxes, classes, valid, iters: int, burn_in: int,
             base_lr: float = 2e-3):
    first = m = None
    for it in range(iters):
        m = step(images, boxes, classes, valid,
                 burn_in_lr(it, base_lr=base_lr, burn_in=burn_in))
        if it == 0:
            first = float(m["total"])
    return first, {k: float(v) for k, v in m.items()}


@pytest.mark.slow
def test_overfit_tiny_batch():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (B, S, S, 3), np.uint8)
    boxes = np.asarray([[[20, 20, 16, 12], [44, 40, 12, 20]]] * B, np.float32)
    classes = np.asarray([[1, 3]] * B, np.int32)
    valid = np.ones((B, 2), bool)
    _, step = _step("yolov3", num_classes=5)
    first, last = _overfit(step, images, boxes, classes, valid, 24, 12)
    assert np.isfinite(last["total"])
    assert last["total"] < first / 3, (first, last)


@pytest.mark.slow
def test_overfit_rotated_batch():
    """The RAPiD loss trains: the periodic angle loss and the rotated
    targets learn."""
    rng = np.random.RandomState(1)
    images = rng.randint(0, 255, (B, S, S, 3), np.uint8)
    boxes = np.asarray([[[24, 24, 18, 34, 0.6], [44, 40, 14, 30, -1.1]]] * B,
                       np.float32)
    classes = np.zeros((B, 2), np.int32)
    valid = np.ones((B, 2), bool)
    _, step = _step("rapid")
    first, last = _overfit(step, images, boxes, classes, valid, 24, 12)
    assert np.isfinite(last["total"])
    assert last["total"] < first / 3, (first, last)
    assert last["angle"] < 0.5, last


@pytest.mark.slow
def test_train_to_detection_end_to_end():
    """Train on a 4-image set, then the port's public detect path
    (letterbox, forward, NMS, inverse map) must recover the GT boxes at
    IoU > 0.5: at least 6 of the 8."""
    rng = np.random.RandomState(0)
    n_img = 4
    images = rng.randint(0, 255, (n_img, S, S, 3), np.uint8)
    boxes = np.asarray([[[16 + 6 * i, 20, 14, 10], [44, 44, 12, 16]]
                        for i in range(n_img)], np.float32)
    classes = np.asarray([[0, 2]] * n_img, np.int32)
    valid = np.ones((n_img, 2), bool)
    model, step = _step("yolov3", num_classes=4)
    _, last = _overfit(step, images, boxes, classes, valid, 160, 20)
    assert np.isfinite(last["total"])

    det = Detector("yolov3", input_size=S, num_classes=4,
                   compute_dtype=torch.float32, device="cpu",
                   params=to_jax_params(model.state_dict()))
    hits = 0
    for i in range(n_img):
        d = det.detect_one(np_img=images[i], conf_thres=0.3)
        for cx, cy, w, h in boxes[i]:
            gx1, gy1, gx2, gy2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
            best = 0.0
            for x1, y1, x2, y2 in d.boxes_xyxy:
                ix = max(0.0, min(x2, gx2) - max(x1, gx1))
                iy = max(0.0, min(y2, gy2) - max(y1, gy1))
                inter = ix * iy
                union = (x2 - x1) * (y2 - y1) + w * h - inter
                best = max(best, inter / union if union > 0 else 0.0)
            hits += best > 0.5
    assert hits >= 6, f"only {hits}/8 GT boxes recovered"

