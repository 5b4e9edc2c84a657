"""Port parity of RAPiD training against the JAX package on the CPU in
float32: the rotated boxes' hull, the target assignment, the loss and
its gradients, and one whole `make_train_step` step.

The loss tests take seeded numpy raw head maps at 64² (P5 2², P4 4²,
P3 8², six channels an anchor) and padded cxcywhθ GT, some of it
copied from decoded predictions so the ignore mask is live, and one
case where three valid GT and a padded one share a cell and an anchor.
The targets (the angle among them) are held bit for bit against the
JAX loss's own expressions (`_torch_train_step.jax_level_targets`;
log(wh / anchor) within one float32 ulp, where the two libraries' logf
differ), the terms within 1e-5 relative, the gradients with respect to
the raw maps within 1e-4 max-scaled.

The step (`_torch_train_step`) starts both packages from the JAX
`init(PRNGKey(0))` tree on `chip_smoke.train_batch(rotated=True)` at
64², batch 2, under chip_smoke's TRAIN_* gates. Its floor, measured by
perturbing the port's weights by one part in 1e7 (two seeds) and
comparing the port with itself: loss terms 1.3e-5 relative, the output
convs' gradients 1.5e-4 max-scaled, every gradient and update cosine
≥ 0.99965, 1.6% relative L2, BN statistics 3.9e-5. Against JAX: 2.0e-5,
9.4e-5, ≥ 0.99983, 0.9%, 4.1e-5.
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
from mydetection_tpu.models import rapid as jrapid  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.models import rapid as trapid  # noqa: E402
from mydetection_tpu_torch.models import yolov3 as tyolo  # noqa: E402

SIZE, BATCH = 64, 2
SHAPES = [(SIZE // s, SIZE // s) for s in trapid.STRIDES]
CH = trapid.CHANNELS_PER_ANCHOR


def _raw_maps(seed: int) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.randn(BATCH, h, w, 3 * CH) * 1.5).astype(np.float32)
            for h, w in SHAPES]


def _gt_case(case: str, raw: list[np.ndarray]):
    """Padded cxcywhθ GT (B, 12): random boxes at random angles, and
    boxes copied from decoded predictions (jittered by under a pixel and
    0.01 rad); "collide" puts three valid GT of one best anchor (P3's
    47x94) in one cell of image 0, then a padded copy of the last."""
    rng = np.random.RandomState(8)
    m = 12
    boxes = np.zeros((BATCH, m, 5), np.float32)
    valid = np.zeros((BATCH, m), bool)
    dec = trapid.decode([torch.from_numpy(r) for r in raw])["boxes5"].numpy()
    for i in range(BATCH):
        boxes[i, :4, :2] = rng.uniform(0, SIZE, (4, 2))
        boxes[i, :4, 2:4] = rng.uniform(4, 48, (4, 2))
        boxes[i, :4, 4] = rng.uniform(-np.pi / 2, np.pi / 2, 4)
        picks = rng.choice(np.flatnonzero((dec[i, :, 2:4] < 80).all(-1)), 4,
                           replace=False)
        jitter = np.concatenate([rng.uniform(-0.5, 0.5, (4, 4)),
                                 rng.uniform(-0.01, 0.01, (4, 1))], 1)
        boxes[i, 4:8] = dec[i, picks] + jitter
        valid[i, :8] = True
    if case == "collide":
        boxes[0, 8:12] = [[20.3, 20.7, 30, 60, 0.3], [21.9, 22.1, 28, 64, -0.7],
                          [23.5, 17.2, 25, 55, 1.2], [23.5, 17.2, 25, 55, 1.2]]
        valid[0, 8:11] = True
    return boxes, valid


def _jax_targets(gt_boxes5, gt_valid, li, h, w):
    return jax_level_targets(gt_boxes5, gt_valid, gt_boxes5[..., 4:5], li, h,
                             w, jrapid.ANCHORS, jrapid.STRIDES, SIZE)


def _port_targets(gt_boxes5, gt_valid, li, h, w):
    boxes, valid = torch.from_numpy(gt_boxes5), torch.from_numpy(gt_valid)
    best = tyolo.best_anchors(boxes[..., 2:4], trapid.ANCHORS)
    return tyolo.level_targets(boxes, valid, boxes[..., 4:5], best, li, h, w,
                               trapid.ANCHORS, SIZE).numpy()


def test_enclose_matches_jax():
    """The axis-aligned hull of rotated boxes (the ignore mask's boxes)
    within 1e-6 max-scaled (cos and sin may differ by an ulp)."""
    boxes, _ = _gt_case("random", _raw_maps(1))
    ref = np.asarray(_jax_enclose(jnp.asarray(boxes)))
    got = trapid.enclose(torch.from_numpy(boxes)).numpy()
    assert max_scaled(got, ref) <= 1e-6


def _jax_enclose(b5):
    """`enclose` of `mydetection_tpu/models/rapid.py::loss` (a closure
    there)."""
    cos = jnp.abs(jnp.cos(b5[..., 4]))
    sin = jnp.abs(jnp.sin(b5[..., 4]))
    w = b5[..., 2] * cos + b5[..., 3] * sin
    h = b5[..., 2] * sin + b5[..., 3] * cos
    return jnp.stack([b5[..., 0] - w / 2, b5[..., 1] - h / 2,
                      b5[..., 0] + w / 2, b5[..., 1] + h / 2], -1)


@pytest.mark.parametrize("case", ["random", "collide"])
def test_targets_bit_equal_to_jax(case):
    """Every level's assigned mask and packed targets (xy, box weight
    and θ bit for bit, log wh within one ulp) equal the JAX loss's; in
    the collision the last valid GT supplies every channel."""
    boxes, valid = _gt_case(case, _raw_maps(1))
    assigned = 0
    for li, (h, w) in enumerate(SHAPES):
        got = _port_targets(boxes, valid, li, h, w)
        assert_targets_equal(got, _jax_targets(boxes, valid, li, h, w))
        assigned += int((got[..., 0] > 0).sum())
    assert assigned >= 8
    if case == "collide":
        got = _port_targets(boxes, valid, 2, 8, 8)
        cx, cy = boxes[0, 10, :2] / 8
        row = got[0, (int(cy) * 8 + int(cx)) * 3]
        assert row[0] == 1 and row[6] == boxes[0, 10, 4]


@pytest.mark.parametrize("case", ["random", "collide"])
def test_loss_terms_and_gradients_match_jax(case):
    """From the same raw maps and GT: conf, box, angle and total within
    1e-5 relative, the gradients with respect to the three raw maps
    within 1e-4 max-scaled; the ignore mask drops some negatives."""
    raw = _raw_maps(1)
    boxes, valid = _gt_case(case, raw)

    def jloss(*maps):
        return jrapid.loss(list(maps), jnp.asarray(boxes), jnp.asarray(valid),
                           input_size=SIZE)

    ref = jax.jit(jloss)(*map(jnp.asarray, raw))
    jg = jax.jit(jax.grad(lambda *a: jloss(*a)["total"],
                          argnums=(0, 1, 2)))(*map(jnp.asarray, raw))
    traw = [torch.from_numpy(r).requires_grad_(True) for r in raw]
    got = trapid.loss(traw, torch.from_numpy(boxes), torch.from_numpy(valid),
                      input_size=SIZE)
    assert set(got) == {"conf", "box", "angle", "total"}
    for k in got:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5), k
    got["total"].backward()
    for li, (t, r) in enumerate(zip(traw, jg)):
        assert max_scaled(t.grad.numpy(), np.asarray(r)) <= 1e-4, li
    conf_grad = np.concatenate([t.grad.numpy().reshape(BATCH, -1, CH)[..., 5]
                                for t in traw], 1)
    assert (conf_grad == 0).sum() >= 4


@pytest.fixture(scope="module")
def family():
    return "rapid"


@pytest.fixture(scope="module")
def batch():
    return step_batch("rapid")


@pytest.fixture(scope="module")
def jax_run(batch):
    return jax_step_run("rapid", batch)


@pytest.fixture(scope="module")
def port_run(jax_run, batch):
    return port_step_run("rapid", jax_run["flat"], batch)


def test_loss_falls_over_four_steps(jax_run, batch):
    step = ttraining.make_train_step(port_model("rapid", jax_run["flat"]),
                                     input_size=SIZE, device="cpu")
    totals = [float(step(*batch, PARITY_LR)["total"]) for _ in range(4)]
    assert all(np.isfinite(totals))
    assert all(b < a for a, b in zip(totals, totals[1:])), totals


def test_step_takes_rotated_boxes_only(jax_run, batch):
    """The rapid step takes (B, M, 5) cxcywhθ GT and refuses (B, M, 4);
    the fcos-style axis-aligned batch is an error, not a silent
    misread."""
    images, boxes, classes, valid = batch
    model = registry.get_model("rapid", compute_dtype=torch.float32,
                               input_size=SIZE)
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, M, 5\)"):
        step.batch(images, boxes[..., :4], classes, valid)
    assert step.batch(*batch)[1].shape[-1] == 5
