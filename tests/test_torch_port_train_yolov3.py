"""Port parity of YOLOv3 training against the JAX package on the CPU in
float32: the target assignment, the loss and its gradients, and one
whole `make_train_step` step.

The loss tests take seeded numpy raw head maps at 64² (P5 2², P4 4²,
P3 8², 4 classes) and padded GT, some of it copied from decoded
predictions so the ignore mask is live, and one case where three valid
GT and a padded one share a cell and an anchor. The targets are held
bit for bit against the JAX loss's own expressions
(`_torch_train_step.jax_level_targets`; log(wh / anchor) within one
float32 ulp, where the two libraries' logf differ), the terms within
1e-5 relative, the gradients with respect to the raw maps within 1e-4
max-scaled.

The step (`_torch_train_step`) starts both packages from the JAX
`init(PRNGKey(0))` tree on `chip_smoke.train_batch` at 64², batch 2,
under chip_smoke's TRAIN_* gates. Its floor, measured by
perturbing the port's weights by one part in 1e7 (two seeds) and
comparing the port with itself: loss terms 3.0e-6 relative, the output
convs' gradients 1.2e-4 max-scaled, every gradient and update cosine
≥ 0.99926, 2.9% relative L2, BN statistics 3.9e-5. Against JAX: 2.2e-6,
8.7e-5, ≥ 0.99981, 1.1%, 4.1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train_step import (  # noqa: E402,F401
    assert_targets_equal,
    jax_level_targets,
    jax_step_run,
    port_model,
    port_step_run,
    step_batch,
    test_step_bn_running_stats_match_jax,
    test_step_gradients_align_with_jax,
    test_step_head_output_gradients_match_jax,
    test_step_loss_terms_match_jax,
    test_step_velocity_and_params_match_jax,
)
from chip_smoke import PARITY_LR, max_scaled  # noqa: E402
from mydetection_tpu.models import yolov3 as jyolo  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.models import yolov3 as tyolo  # noqa: E402

SIZE, BATCH, CLASSES = 64, 2, 4
SHAPES = [(SIZE // s, SIZE // s) for s in tyolo.STRIDES]


def _raw_maps(seed: int) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, h, w, 3 * (5 + CLASSES)) * 1.5).astype(np.float32)
            for h, w in SHAPES]


def _gt_case(case: str, raw: list[np.ndarray]):
    """Padded GT (B, 12): random boxes, and boxes copied from decoded
    predictions (jittered by under a pixel) so that some predictions
    overlap a GT by IoU > 0.6; "collide" puts three valid GT of one
    best anchor (P3's 10x13) in one cell of image 0, then a padded copy
    of the last."""
    rng = np.random.RandomState(7)
    m = 12
    boxes = np.zeros((BATCH, m, 4), np.float32)
    classes = rng.randint(0, CLASSES, (BATCH, m)).astype(np.int32)
    valid = np.zeros((BATCH, m), bool)
    dec = tyolo.decode([torch.from_numpy(r) for r in raw], CLASSES)["boxes"]
    dec = dec.numpy()
    for i in range(BATCH):
        k = 8
        boxes[i, :4, :2] = rng.uniform(0, SIZE, (4, 2))
        boxes[i, :4, 2:] = rng.uniform(2, 32, (4, 2))
        picks = rng.choice(np.flatnonzero((dec[i, :, 2:] < 48).all(-1)), 4,
                           replace=False)
        boxes[i, 4:8] = dec[i, picks] + rng.uniform(-0.5, 0.5, (4, 4))
        valid[i, :k] = True
    if case == "collide":
        boxes[0, 8:12] = [[20.3, 20.7, 12, 14], [21.9, 22.1, 11, 15],
                          [23.5, 17.2, 9, 12], [23.5, 17.2, 9, 12]]
        valid[0, 8:11] = True
    return boxes, classes, valid


def _jax_targets(gt_boxes, gt_classes, gt_valid, li, h, w):
    onehot = jax.nn.one_hot(jnp.asarray(gt_classes), CLASSES)
    return jax_level_targets(gt_boxes, gt_valid, onehot, li, h, w,
                             jyolo.ANCHORS, jyolo.STRIDES, SIZE)


def _port_targets(gt_boxes, gt_classes, gt_valid, li, h, w):
    boxes, classes, valid = map(torch.from_numpy, (gt_boxes, gt_classes,
                                                   gt_valid))
    onehot = (classes[..., None] == torch.arange(CLASSES)).float()
    best = tyolo.best_anchors(boxes[..., 2:4], tyolo.ANCHORS)
    return tyolo.level_targets(boxes, valid, onehot, best, li, h, w,
                               tyolo.ANCHORS, SIZE).numpy()


@pytest.mark.parametrize("case", ["random", "collide"])
def test_targets_bit_equal_to_jax(case):
    """Every level's assigned mask and packed targets (xy, box weight,
    class bit for bit, log wh within one ulp) equal the JAX loss's."""
    gt = _gt_case(case, _raw_maps(1))
    assigned = 0
    for li, (h, w) in enumerate(SHAPES):
        got = _port_targets(*gt, li, h, w)
        assert_targets_equal(got, _jax_targets(*gt, li, h, w))
        assigned += int((got[..., 0] > 0).sum())
    assert assigned >= 8


def test_collision_keeps_the_last_valid_gt():
    """Three valid GT on one cell and anchor: the last of them (GT 10)
    supplies every channel of that prediction's targets; the padded copy
    after it (GT 11) takes no part."""
    boxes, classes, valid = _gt_case("collide", _raw_maps(1))
    classes[0, 8:12] = [0, 1, 2, 3]
    got = _port_targets(boxes, classes, valid, 2, 8, 8)
    cx, cy = boxes[0, 10, :2] / 8
    row = got[0, (int(cy) * 8 + int(cx)) * 3 + 0]
    np.testing.assert_array_equal(row[:3], [1, cx - np.floor(cx),
                                            cy - np.floor(cy)])
    np.testing.assert_array_equal(row[6:], [0, 0, 1, 0])
    assert_targets_equal(got, _jax_targets(boxes, classes, valid, 2, 8, 8))


@pytest.mark.parametrize("case", ["random", "collide"])
def test_loss_terms_and_gradients_match_jax(case):
    """From the same raw maps and GT: obj, box, cls and total within
    1e-5 relative, the gradients with respect to the three raw maps
    within 1e-4 max-scaled; the ignore mask drops some negatives."""
    raw = _raw_maps(1)
    gt = _gt_case(case, raw)

    def jloss(*maps):
        return jyolo.loss(None, list(maps), *map(jnp.asarray, gt),
                          input_size=SIZE, num_classes=CLASSES)

    ref = jax.jit(jloss)(*map(jnp.asarray, raw))
    jg = jax.jit(jax.grad(lambda *a: jloss(*a)["total"],
                          argnums=(0, 1, 2)))(*map(jnp.asarray, raw))
    traw = [torch.from_numpy(r).requires_grad_(True) for r in raw]
    got = tyolo.loss(traw, *map(torch.from_numpy, gt), input_size=SIZE,
                     num_classes=CLASSES)
    assert set(got) == {"obj", "box", "cls", "total"}
    for k in got:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5), k
    got["total"].backward()
    for li, (t, r) in enumerate(zip(traw, jg)):
        assert max_scaled(t.grad.numpy(), np.asarray(r)) <= 1e-4, li
    # the ignore mask is live: some unassigned predictions get no
    # objectness gradient
    obj_grad = np.concatenate([t.grad.numpy().reshape(BATCH, -1, 5 + CLASSES)
                               [..., 4] for t in traw], 1)
    assert (obj_grad == 0).sum() >= 4


@pytest.fixture(scope="module")
def family():
    return "yolov3"


@pytest.fixture(scope="module")
def batch():
    return step_batch("yolov3")


@pytest.fixture(scope="module")
def jax_run(batch):
    return jax_step_run("yolov3", batch)


@pytest.fixture(scope="module")
def port_run(jax_run, batch):
    return port_step_run("yolov3", jax_run["flat"], batch)


def test_loss_falls_over_four_steps(jax_run, batch):
    """Four port steps at PARITY_LR on one fixed batch: the total loss
    falls at every step."""
    step = ttraining.make_train_step(port_model("yolov3", jax_run["flat"]),
                                     input_size=SIZE, device="cpu")
    totals = [float(step(*batch, PARITY_LR)["total"]) for _ in range(4)]
    assert all(np.isfinite(totals))
    assert all(b < a for a, b in zip(totals, totals[1:])), totals


def test_box_weight_takes_the_steps_input_size(jax_run, batch):
    """A model registered at 416 trained in a 64² bucket weights its box
    term by 2 − w·h/64², as the JAX step does (`input_size` of
    make_train_step), not by the config's 416."""
    model = registry.get_model("yolov3", num_classes=CLASSES,
                               compute_dtype=torch.float32)
    model.load_state_dict(port_model("yolov3", jax_run["flat"]).state_dict())
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    args = step.batch(*batch)
    with torch.no_grad():
        terms = step.forward(*args)
        at_64 = registry.loss(model, *args, input_size=SIZE)
        at_416 = registry.loss(model, *args)
    assert float(terms["box"]) == float(at_64["box"])
    assert float(terms["box"]) != float(at_416["box"])
    assert float(terms["box"]) == pytest.approx(jax_run["metrics"]["box"],
                                                rel=1e-3)
