"""Port parity of RetinaNet training against the JAX package on the CPU
in float32: the anchor assignment, the loss and its gradients, one whole
`make_train_step` step, and the towers under autograd.

The loss tests take seeded numpy head outputs at 64² (774 anchors over
P3–P7, 4 classes) and padded GT: random boxes, boxes copied from
anchors (positives at IoU ≥ 0.5), and a case where two valid GT share
one best anchor beside padded GT (which vote −1 and argmax to anchor
0). The assignment (positive, negative, matched GT) is held bit for bit
against the JAX loss's own expressions (`_jax_assign`), the terms
within 1e-5 relative, the gradients with respect to the class logits
and the box deltas within 1e-4 max-scaled.

The step (`_torch_train_step`) starts both packages from the JAX
`init(PRNGKey(0))` tree on `chip_smoke.train_batch` at 64², batch 2,
under chip_smoke's TRAIN_* gates. Its floor, measured by perturbing the
port's weights by one part in 1e7 (two seeds) and comparing the port
with itself: loss terms 1.3e-6 relative, the output convs' gradients
4.5e-5 max-scaled, every gradient and update cosine ≥ 0.99923, 1.4%
relative L2, BN statistics 1.0e-4. Against JAX: 3.2e-7, 4.4e-5,
≥ 0.99951, 1.6%, 1.5e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train_step import (  # noqa: E402,F401
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
from chip_smoke import PARITY_LR, max_scaled, train_batch  # noqa: E402
from mydetection_tpu.models import retinanet as jretina  # noqa: E402
from mydetection_tpu.ops.boxes import cxcywh_to_xyxy, pairwise_iou  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.kernels import tower  # noqa: E402
from mydetection_tpu_torch.models import retinanet as tretina  # noqa: E402

SIZE, BATCH, CLASSES = 64, 2, 4
FORCED = 9 * (3 * 8 + 3) + 4   # P3, cell (3, 3), the 1:1 anchor of scale 1


def _anchors() -> np.ndarray:
    return tretina.generate_anchors(SIZE).numpy()


def _gt_case(case: str):
    """Padded GT (B, 10): 4 random boxes and 3 copied from anchors with
    a jitter (positives by IoU) an image; "force" adds, to image 0, two
    valid GT that share one best anchor (GT 7 and 8, the second
    winning it); the rest is padding."""
    rng = np.random.RandomState(3)
    anchors = _anchors()
    m = 10
    boxes = np.zeros((BATCH, m, 4), np.float32)
    classes = rng.randint(0, CLASSES, (BATCH, m)).astype(np.int32)
    valid = np.zeros((BATCH, m), bool)
    for i in range(BATCH):
        boxes[i, :4, :2] = rng.uniform(0, SIZE, (4, 2))
        boxes[i, :4, 2:] = rng.uniform(4, 40, (4, 2))
        picks = rng.choice(len(anchors), 3, replace=False)
        boxes[i, 4:7] = anchors[picks] * rng.uniform(0.9, 1.1, (3, 4))
        valid[i, :7] = True
    if case == "force":
        boxes[0, 7:9] = anchors[FORCED] + [[0.5, 0.5, 0, 0], [-0.5, -0.5, 0, 0]]
        valid[0, 7:9] = True
    return boxes, classes, valid


def _jax_assign(anchors, gt_boxes, gt_valid):
    """(positive, negative, matched) by the JAX loss's expressions
    (`mydetection_tpu/models/retinanet.py::loss`)."""
    anchors, gt_boxes, gt_valid = map(jnp.asarray, (anchors, gt_boxes,
                                                    gt_valid))
    iou = pairwise_iou(cxcywh_to_xyxy(anchors)[None], cxcywh_to_xyxy(gt_boxes))
    iou = jnp.where(gt_valid[:, None, :], iou, -1.0)
    best_gt_iou = jnp.max(iou, axis=-1)
    best_gt = jnp.argmax(iou, axis=-1)
    best_anchor = jnp.argmax(iou, axis=1)
    b, n, m = iou.shape
    bidx = jnp.arange(b)[:, None].repeat(m, 1)
    gt_idx = jnp.arange(m)[None, :].repeat(b, 0)
    force_votes = jnp.full((b, n), -1, jnp.int32).at[bidx, best_anchor].max(
        jnp.where(gt_valid, gt_idx, -1))
    force = force_votes >= 0
    positive = (best_gt_iou >= jretina.POS_IOU) | force
    negative = (best_gt_iou < jretina.NEG_IOU) & ~force
    matched = jnp.where(force, jnp.maximum(force_votes, 0), best_gt)
    return [np.asarray(a) for a in (positive, negative, matched)]


@pytest.mark.parametrize("case", ["random", "force"])
def test_assign_bit_equal_to_jax(case):
    boxes, _, valid = _gt_case(case)
    ref = _jax_assign(_anchors(), boxes, valid)
    got = [a.numpy() for a in tretina.assign(
        torch.from_numpy(_anchors()), torch.from_numpy(boxes),
        torch.from_numpy(valid))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    positive, negative, matched = got
    assert positive.sum() >= 6 and negative.any()
    assert not (positive & negative).any()
    if case == "force":
        # GT 7 and 8 (half a pixel either side of anchor FORCED) share it
        # as their best anchor: the later GT holds it
        ious = tretina.pairwise_iou(
            tretina.cxcywh_to_xyxy(torch.from_numpy(_anchors())),
            tretina.cxcywh_to_xyxy(torch.from_numpy(boxes[0, 7:9])))
        assert (torch.argmax(ious, 0) == FORCED).all()
        assert positive[0, FORCED] and matched[0, FORCED] == 8


@pytest.mark.parametrize("case", ["random", "force"])
def test_loss_terms_and_gradients_match_jax(case):
    """From the same head outputs: cls, box and total within 1e-5
    relative, the gradients with respect to the class logits and the box
    deltas within 1e-4 max-scaled."""
    boxes, classes, valid = _gt_case(case)
    anchors = _anchors()
    rng = np.random.RandomState(4)
    cls = (rng.randn(BATCH, len(anchors), CLASSES) * 2 - 3).astype(np.float32)
    deltas = (rng.randn(BATCH, len(anchors), 4) * 0.3).astype(np.float32)

    def jloss(c, d):
        return jretina.loss(c, d, jnp.asarray(anchors), jnp.asarray(boxes),
                            jnp.asarray(classes), jnp.asarray(valid),
                            num_classes=CLASSES)

    ref = jax.jit(jloss)(jnp.asarray(cls), jnp.asarray(deltas))
    jg = jax.jit(jax.grad(lambda c, d: jloss(c, d)["total"], argnums=(0, 1)))(
        jnp.asarray(cls), jnp.asarray(deltas))
    heads = [torch.from_numpy(a).requires_grad_(True) for a in (cls, deltas)]
    got = tretina.loss(*heads, torch.from_numpy(anchors),
                       torch.from_numpy(boxes), torch.from_numpy(classes),
                       torch.from_numpy(valid), num_classes=CLASSES)
    assert set(got) == {"cls", "box", "total"}
    for k in got:
        assert float(got[k].detach()) == pytest.approx(float(ref[k]),
                                                       rel=1e-5), k
    got["total"].backward()
    for name, h, r in zip(("cls", "deltas"), heads, jg):
        assert max_scaled(h.grad.numpy(), np.asarray(r)) <= 1e-4, name


@pytest.fixture(scope="module")
def family():
    return "retinanet"


@pytest.fixture(scope="module")
def batch():
    return step_batch("retinanet")


@pytest.fixture(scope="module")
def jax_run(batch):
    return jax_step_run("retinanet", batch)


@pytest.fixture(scope="module")
def port_run(jax_run, batch):
    return port_step_run("retinanet", jax_run["flat"], batch)


def test_loss_falls_over_four_steps(jax_run, batch):
    step = ttraining.make_train_step(port_model("retinanet", jax_run["flat"]),
                                     input_size=SIZE, device="cpu")
    totals = [float(step(*batch, PARITY_LR)["total"]) for _ in range(4)]
    assert all(np.isfinite(totals))
    assert all(b < a for a, b in zip(totals, totals[1:])), totals


def test_train_head_runs_without_the_gate(jax_run, batch):
    """The train-mode head returns (cls, deltas), no max-over-classes
    gate, even on a multi-label config, as the JAX `forward_raw(train=
    True)` does; the detect head keeps it."""
    model = port_model("retinanet", jax_run["flat"])
    images = torch.from_numpy(batch[0])
    with torch.no_grad():
        assert len(model(images, with_gate=False)) == 2
        assert len(model(images)) == 3


def test_towers_train_through_the_plain_chain(jax_run):
    """Under autograd a subnet's tower is `conv3x3_chain_plain`: its
    output and the gradients of the tower's weights equal an explicit
    loop of conv + bias + ReLU over the same modules."""
    model = port_model("retinanet", jax_run["flat"])
    sub = model.head.cls
    x = torch.from_numpy(np.random.RandomState(5).randn(
        2, 256, 4, 4).astype(np.float32))
    y = sub(x, *sub.packed(torch.float32))
    ref = x
    for i in range(tretina.TOWER_LAYERS):
        conv = getattr(sub, f"conv{i}")
        ref = torch.relu(torch.nn.functional.conv2d(ref, conv.weight,
                                                    padding=1)
                         + conv.bias[:, None, None])
    ref = torch.nn.functional.conv2d(ref, sub.out.weight, padding=1) \
        + sub.out.bias[:, None, None]
    got = torch.autograd.grad(y.square().sum(), [sub.conv0.weight,
                                                 sub.conv3.bias])
    want = torch.autograd.grad(ref.square().sum(), [sub.conv0.weight,
                                                    sub.conv3.bias])
    assert max_scaled(y.detach().numpy(), ref.detach().numpy()) <= 1e-6
    for g, w in zip(got, want):
        assert max_scaled(g.numpy(), w.numpy()) <= 1e-5
    assert tower.conv3x3_chain.launches == 0


def test_r101_loss_runs():
    """`registry.loss` of retinanet_r101 at 64²: finite terms and a
    gradient for every parameter that takes part."""
    model = registry.get_model("retinanet_r101", num_classes=CLASSES,
                               compute_dtype=torch.float32, input_size=SIZE)
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    data = train_batch(1, 1, SIZE, CLASSES, max_gt=8, max_boxes=4)
    terms = step.forward(*step.batch(*data))
    assert set(terms) == {"cls", "box", "total"}
    assert all(np.isfinite(float(v.detach())) for v in terms.values())
    grads = step.backward(terms)
    assert grads["backbone.stage2.block22.conv3.conv.weight"].abs().sum() > 0
