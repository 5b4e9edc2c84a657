"""One small train step of a family in both packages, and the tests that
hold the port's step to the JAX one.

`jax_step_run` and `port_step_run` start from the JAX
`get_model(name, ...).init(PRNGKey(0))` tree (loaded into the port with
`from_jax_params`) on one `chip_smoke.train_batch` at PARITY_SIZE²,
batch PARITY_BATCH, float32. A family's test file builds the module
fixtures `family`, `jax_run` and `port_run` from them and imports the
`test_step_*` functions below, so each family's step runs in its own
file (and its own worker). The gates are chip_smoke's TRAIN_*
constants, which its card-against-CPU phase uses too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import (  # noqa: E402
    PARITY_BATCH,
    PARITY_CLASSES,
    PARITY_LR,
    PARITY_SIZE,
    TRAIN_BN_GATE,
    TRAIN_COSINE_GATE,
    TRAIN_HEAD_OUT,
    TRAIN_HEAD_OUT_GATE,
    TRAIN_L2_GATE,
    TRAIN_LOSS_RTOL,
    cosine,
    max_scaled,
    rel_l2,
    train_batch,
)
from mydetection_tpu import training as jtraining  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402

def classes_of(name: str) -> int:
    return 1 if name == "rapid" else PARITY_CLASSES


def step_batch(name: str, seed: int = 0):
    return train_batch(seed, PARITY_BATCH, PARITY_SIZE, classes_of(name),
                       max_gt=100, max_boxes=20, rotated=name == "rapid")


def jax_model(name: str):
    return jget_model(name, num_classes=classes_of(name),
                      compute_dtype=jnp.float32, input_size=PARITY_SIZE)


def port_model(name: str, flat: dict):
    """The port's model of `name` at the parity size, loaded from a flat
    JAX tree."""
    model = registry.get_model(name, num_classes=classes_of(name),
                               compute_dtype=torch.float32,
                               input_size=PARITY_SIZE)
    model.load_state_dict(from_jax_params(flat), strict=True)
    return model


def port_keys(tree) -> dict:
    """A JAX tree as the port's state_dict names, float64 numpy."""
    return {k: t.double().numpy() for k, t in from_jax_params(
        {k: np.asarray(v) for k, v in flatten_tree(tree).items()}).items()}


def jax_step_run(name: str, batch) -> dict:
    """The JAX step from the seeded init: the flat tree before, port-named
    float64 params before and after, the velocity after, the metrics,
    and the gradients of the same loss by `jax.grad`. (Gradients taken
    back out of the velocity, v − wd·p, lose those far below wd·p's
    float32 ulp: at 64² the FPN's P6 and P7 convs get about 1e-11.)"""
    jm = jax_model(name)
    params = jm.init(jax.random.PRNGKey(0))
    step = jtraining.make_train_step(jm, input_size=PARITY_SIZE)
    jbatch = tuple(map(jnp.asarray, batch))
    p1, v1, metrics = step(params, jtraining.sgd_init(params), *jbatch,
                           PARITY_LR)
    grads = jax.jit(jax.grad(lambda p: jm.loss(
        p, *jbatch, input_size=PARITY_SIZE)["total"]))(params)
    return {"flat": {k: np.asarray(v) for k, v in flatten_tree(params).items()},
            "p0": port_keys(params), "p1": port_keys(p1),
            "v1": port_keys(v1),
            "grads": {k: g for k, g in port_keys(grads).items()
                      if not k.endswith((".mean", ".var"))},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def port_step_run(name: str, flat: dict, batch) -> dict:
    """The port's step from the same weights, phase by phase, keeping the
    gradients."""
    model = port_model(name, flat)
    step = ttraining.make_train_step(model, input_size=PARITY_SIZE,
                                     device="cpu")
    terms = step.forward(*step.batch(*batch))
    grads = step.backward(terms)
    p0 = {k: p.detach().clone() for k, p in step.params.items()}
    step.update(grads, PARITY_LR)
    return {"terms": {k: float(v.detach()) for k, v in terms.items()},
            "grads": {k: g.detach().numpy() for k, g in grads.items()},
            "p0": p0, "step": step, "model": model}


def assert_targets_equal(got: np.ndarray, ref: np.ndarray) -> None:
    """Bit for bit, except the log(wh / anchor) columns 3:5: float32
    logf of XLA:CPU and of torch differ by up to one ulp on some
    inputs (the ratio they take is the same bits).
    Both in the port's channel order: assigned, xy, wh, box weight,
    then the family's own columns."""
    keep = np.ones(got.shape[-1], bool)
    keep[3:5] = False
    np.testing.assert_array_equal(got[..., keep], ref[..., keep])
    wh_got, wh_ref = got[..., 3:5], ref[..., 3:5]
    assert (np.abs(wh_got - wh_ref) <= np.spacing(np.abs(wh_ref))).all()


def jax_level_targets(gt_boxes, gt_valid, extra, li: int, h: int, w: int,
                      anchors, strides, size: int) -> np.ndarray:
    """Level li's packed darknet targets by the JAX losses' expressions
    (`mydetection_tpu/models/yolov3.py::loss`, `rapid.py::loss`: the
    best wh-IoU anchor, the cell, the offsets, log(wh / anchor), the box
    weight, one `.at[].set` of every column) in the port's channel
    order: assigned, xy, wh, box weight, then `extra` (B, M, E) — the
    one-hot class for yolov3, θ for rapid."""
    gt_boxes, gt_valid, extra = map(jnp.asarray, (gt_boxes, gt_valid, extra))
    all_anchors = jnp.asarray([a for lvl in anchors for a in lvl], jnp.float32)
    bb, m = gt_valid.shape
    gw, gh = gt_boxes[..., 2], gt_boxes[..., 3]
    aw, ah = all_anchors[:, 0], all_anchors[:, 1]
    inter = jnp.minimum(gw[..., None], aw) * jnp.minimum(gh[..., None], ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best_a = jnp.argmax(inter / jnp.maximum(union, 1e-9), axis=-1)
    best_level, best_sub = best_a // 3, best_a % 3
    na, stride, n = 3, strides[li], h * w * 3
    sel = gt_valid & (best_level == li)
    cx, cy = gt_boxes[..., 0] / stride, gt_boxes[..., 1] / stride
    ci = jnp.clip(cx.astype(jnp.int32), 0, w - 1)
    cj = jnp.clip(cy.astype(jnp.int32), 0, h - 1)
    flat_idx = jnp.where(sel, (cj * w + ci) * na + best_sub, n)
    anc = jnp.asarray(anchors[li], jnp.float32)
    t_xy = jnp.stack([cx - jnp.floor(cx), cy - jnp.floor(cy)], -1)
    t_wh = jnp.log(jnp.maximum(gt_boxes[..., 2:4] / anc[best_sub], 1e-9))
    w_box = 2.0 - (gt_boxes[..., 2] * gt_boxes[..., 3]) / float(size) ** 2
    packed = jnp.concatenate([jnp.ones((bb, m, 1), jnp.float32), t_xy, t_wh,
                              w_box[..., None], extra], -1)
    out = jnp.zeros((bb, n + 1, packed.shape[-1]), jnp.float32)
    bidx = jnp.arange(bb)[:, None].repeat(m, 1)
    return np.asarray(out.at[bidx, flat_idx].set(packed)[:, :n])


def test_step_loss_terms_match_jax(family, jax_run, port_run):
    assert set(port_run["terms"]) == set(jax_run["metrics"])
    for k, v in jax_run["metrics"].items():
        assert port_run["terms"][k] == pytest.approx(v, rel=TRAIN_LOSS_RTOL), k


def test_step_head_output_gradients_match_jax(family, jax_run, port_run):
    ref = jax_run["grads"]
    near = [k for k in ref if k.startswith(TRAIN_HEAD_OUT[family])]
    assert all(any(k.startswith(p) for k in near)
               for p in TRAIN_HEAD_OUT[family])
    for k in near:
        assert max_scaled(port_run["grads"][k], ref[k]) \
            <= TRAIN_HEAD_OUT_GATE, k


def test_step_gradients_align_with_jax(family, jax_run, port_run):
    """Every parameter's gradient points the JAX way (cosine) and all of
    them together lie within the relative-L2 gate."""
    ref = jax_run["grads"]
    assert set(ref) == set(port_run["grads"])
    worst = min((cosine(port_run["grads"][k], ref[k]), k) for k in ref)
    assert worst[0] >= TRAIN_COSINE_GATE, worst
    assert rel_l2(port_run["grads"], ref) <= TRAIN_L2_GATE


def test_step_velocity_and_params_match_jax(family, jax_run, port_run):
    """velocity = g + wd·p and p1 = p0 − lr·v in place, so the update
    carries the gradient's gates; the port's p1 is p0 − lr·v to one
    float32 ulp."""
    step, p0 = port_run["step"], port_run["p0"]
    vel = {k: v.numpy() for k, v in step.velocity.items()}
    ref_v = {k: jax_run["v1"][k] for k in vel}
    assert rel_l2(vel, ref_v) <= TRAIN_L2_GATE
    assert min(cosine(vel[k], ref_v[k]) for k in vel) >= TRAIN_COSINE_GATE
    delta = {k: (p - p0[k]).detach().numpy() for k, p in step.params.items()}
    ref_d = {k: jax_run["p1"][k] - jax_run["p0"][k] for k in delta}
    assert rel_l2(delta, ref_d) <= TRAIN_L2_GATE
    assert min(cosine(delta[k], ref_d[k]) for k in delta) >= TRAIN_COSINE_GATE
    for k, p in step.params.items():
        want = p0[k].numpy() - np.float32(PARITY_LR) * vel[k]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=float(np.spacing(np.abs(want).max())))


def test_step_bn_running_stats_match_jax(family, jax_run, port_run):
    """Every BN running statistic moved (backbone and head), as the JAX
    step's `bn_updates` tree moves them, within the BN gate."""
    bufs = {k: b.numpy() for k, b in port_run["model"].named_buffers()}
    assert bufs and all(k.endswith((".mean", ".var")) for k in bufs)
    for k, b in bufs.items():
        assert not np.array_equal(b, jax_run["p0"][k]), k
        assert max_scaled(b, jax_run["p1"][k]) <= TRAIN_BN_GATE, k
