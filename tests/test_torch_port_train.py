"""Port parity of the FCOS training slice against the JAX package on the
CPU in float32: the matched IoU/GIoU box ops, the losses, the FCOS
target assignment and loss, train-mode BatchNorm, SGD and the burn-in
schedule, and one whole `make_train_step` step.

Seeded numpy inputs go through both. The whole step starts both
packages from the JAX `get_model("fcos", num_classes=4).init(
PRNGKey(0))` tree, on `chip_smoke.train_batch(0, 2, 64, 4)`. Its gates
(chip_smoke's TRAIN_*, which its CUDA-against-CPU phase uses too) are
set by what the comparison can see: a random-init ResNet-50 with
batch-statistics BatchNorm and the GN towers is so sensitive that
perturbing the port's own weights by one part in 1e7 (two seeds) moves
its loss terms by up to 3.2e-6 relative, the gradients of the head's
output convs by up to 5.6e-5 max-scaled, and deeper gradients by up to
27% max-scaled (every gradient's cosine ≥ 0.9988, 3.6% relative L2
over all parameters). The JAX step, which also takes the GroupNorm
variance in two passes where the port takes E[x²] − E[x]², is held to
a few times that floor. Measured against JAX (its gradients by
`jax.grad` of the same loss, `_torch_train_step`): loss terms 2.2e-6
relative, the head's output convs 5.8e-5, every gradient's and
update's cosine ≥ 0.99898, 3.5% relative L2, BN running statistics
1.5e-4 max-scaled.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train_step import (  # noqa: E402,F401
    jax_step_run,
    port_step_run,
    step_batch,
    test_step_bn_running_stats_match_jax,
    test_step_gradients_align_with_jax,
    test_step_head_output_gradients_match_jax,
    test_step_loss_terms_match_jax,
    test_step_velocity_and_params_match_jax,
)
from chip_smoke import (  # noqa: E402
    PARITY_BATCH,
    PARITY_CLASSES,
    PARITY_LR,
    PARITY_SIZE,
    max_scaled,
    train_batch,
)
from mydetection_tpu import losses as jlosses  # noqa: E402
from mydetection_tpu import training as jtraining  # noqa: E402
from mydetection_tpu.models import fcos as jfcos  # noqa: E402
from mydetection_tpu.models import layers as JL  # noqa: E402
from mydetection_tpu.ops import boxes as jboxes  # noqa: E402
from mydetection_tpu_torch import losses as tlosses  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training as ttraining  # noqa: E402
from mydetection_tpu_torch.models import fcos as tfcos  # noqa: E402
from mydetection_tpu_torch.models import layers as TL  # noqa: E402
from mydetection_tpu_torch.ops import boxes as tboxes  # noqa: E402

SIZE, BATCH, CLASSES, LR = PARITY_SIZE, PARITY_BATCH, PARITY_CLASSES, PARITY_LR
_max_scaled = max_scaled


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# box ops and losses
# ---------------------------------------------------------------------------

def _box_pairs(seed=0, n=400):
    """Matched xyxy pairs: random boxes, plus degenerate ones (zero and
    negative width or height, identical pairs, disjoint pairs, a box
    inside the other)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (n, 2, 2))
    wh = rng.uniform(-5, 60, (n, 2, 2))
    a = np.concatenate([xy[:, 0], xy[:, 0] + wh[:, 0]], -1)
    b = np.concatenate([xy[:, 1], xy[:, 1] + wh[:, 1]], -1)
    a[:10, 2] = a[:10, 0]                      # zero width
    b[10:20] = a[10:20]                        # identical
    b[20:30] = a[20:30] + 500                  # disjoint
    b[30:40, :2] = a[30:40, :2] + 1            # inside (when wide enough)
    b[30:40, 2:] = a[30:40, 2:] - 1
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("name", ["box_area", "xyxy_to_cxcywh",
                                  "elementwise_iou", "elementwise_giou"])
def test_box_ops_match_jax(name):
    """The same expressions in the same order: equal to 1e-7 max-scaled
    (they round alike op for op)."""
    a, b = _box_pairs()
    args = (a,) if name in ("box_area", "xyxy_to_cxcywh") else (a, b)
    ref = np.asarray(getattr(jboxes, name)(*map(jnp.asarray, args)))
    got = _np(getattr(tboxes, name)(*map(torch.from_numpy, args)))
    assert got.shape == ref.shape
    assert _max_scaled(got, ref) <= 1e-7


def _loss_inputs(name, seed=1):
    rng = np.random.RandomState(seed)
    if name in ("iou_loss", "giou_loss"):
        return _box_pairs(seed)
    x = (rng.randn(500) * 4).astype(np.float32)
    x[:5] = [0.0, -0.0, 30.0, -30.0, 1e-3]
    if name in ("bce_with_logits", "focal_loss"):
        t = (rng.uniform(size=500) < 0.3).astype(np.float32)
        if name == "bce_with_logits":
            t[250:] = rng.uniform(size=250)    # soft targets (centerness)
        return x, t
    if name in ("period_l1", "period_l2"):
        return ((rng.uniform(-4, 4, 500)).astype(np.float32),
                (rng.uniform(-4, 4, 500)).astype(np.float32))
    return x, (x + rng.randn(500) * 0.2).astype(np.float32)


@pytest.mark.parametrize("name", ["bce_with_logits", "focal_loss",
                                  "smooth_l1", "iou_loss", "giou_loss",
                                  "period_l1", "period_l2"])
def test_losses_match_jax(name):
    """Elementwise values within 1e-6 max-scaled (exp, log1p and log may
    differ by an ulp between the two libraries), gradients within 1e-5."""
    args = _loss_inputs(name)
    ref = np.asarray(getattr(jlosses, name)(*map(jnp.asarray, args)))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = getattr(tlosses, name)(*targs)
    assert _max_scaled(_np(got), ref) <= 1e-6
    jgrad = jax.grad(lambda *a: jnp.sum(getattr(jlosses, name)(*a)))(
        *map(jnp.asarray, args))
    got.sum().backward()
    assert _max_scaled(targs[0].grad.numpy(), np.asarray(jgrad)) <= 1e-5


def test_take_along_dim_equals_onehot_gather():
    """The gather that replaces the TPU one-hot contraction, bit for bit
    on float boxes and integer classes."""
    rng = np.random.RandomState(2)
    boxes = rng.uniform(-100, 700, (3, 9, 4)).astype(np.float32)
    classes = rng.randint(0, 80, (3, 9)).astype(np.int32)
    idx = rng.randint(0, 9, (3, 50))
    for table in (boxes, classes):
        ref = np.asarray(jlosses.onehot_gather(jnp.asarray(table),
                                               jnp.asarray(idx)))
        got = _np(tlosses.take_along_dim(torch.from_numpy(table),
                                         torch.from_numpy(idx)))
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# FCOS assignment and loss
# ---------------------------------------------------------------------------

def _assign_case():
    """GT for a 64² canvas (86 locations): two equal-area boxes over the
    same locations (ties), a valid box next to a padded one at the same
    place, boxes reaching outside the canvas, and a box too small for
    any location (its locations have no candidate)."""
    xyxy = np.array([
        [[4, 4, 36, 36], [6, 2, 38, 34], [0, 0, 60, 60], [-20, -10, 30, 30],
         [50, 50, 90, 120], [40, 40, 40.5, 40.5], [0, 0, 0, 0]],
        [[10, 10, 30, 30], [10, 10, 30, 30], [-30, -30, 70, 70],
         [20, 0, 60, 20], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]],
    ], np.float32)
    valid = np.array([[1, 1, 1, 1, 1, 1, 0], [1, 1, 0, 1, 0, 0, 0]], bool)
    return xyxy, valid


def test_assign_bit_equal_to_jax():
    """positive, matched, target ltrb and centerness equal bit for bit,
    with first-index ties and the 1e18 sentinel's index 0."""
    xyxy, valid = _assign_case()
    jloc, jstr = jfcos.generate_locations(SIZE)
    ref = [np.asarray(r) for r in jfcos._assign(jloc, jstr, jnp.asarray(xyxy),
                                                jnp.asarray(valid))]
    loc, strides = tfcos.generate_locations(SIZE)
    got = [_np(g) for g in tfcos.assign(loc, strides, torch.from_numpy(xyxy),
                                        torch.from_numpy(valid))]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    pos, matched = got[0], got[1]
    # image 1's boxes 0 and 1 are the same box: every location they
    # share goes to box 0; the padded box 2 covers all and takes none
    assert pos[1].any() and not (matched[1][pos[1]] == 1).any()
    assert not (matched[1][pos[1]] == 2).any()
    assert (matched[pos == 0] == 0).all() and (~pos).any()


def test_fcos_loss_terms_and_gradients_match_jax():
    """From the same head outputs (random logits, positive ltrb, GT of
    `train_batch`): the four terms within 1e-6 relative, the gradients
    with respect to the three head outputs within 1e-5 max-scaled."""
    images, boxes, classes, valid = train_batch(3, BATCH, SIZE, CLASSES,
                                                max_gt=12, max_boxes=8)
    del images
    rng = np.random.RandomState(4)
    jloc, jstr = jfcos.generate_locations(SIZE)
    n = jloc.shape[0]
    cls = (rng.randn(BATCH, n, CLASSES) - 2).astype(np.float32)
    ltrb = np.exp(rng.randn(BATCH, n, 4)).astype(np.float32) * 8
    ctr = rng.randn(BATCH, n).astype(np.float32)

    def jloss(cls, ltrb, ctr):
        return jfcos.loss(cls, ltrb, ctr, jloc, jstr, jnp.asarray(boxes),
                          jnp.asarray(classes), jnp.asarray(valid),
                          num_classes=CLASSES)

    ref = jloss(cls, ltrb, ctr)
    jg = jax.grad(lambda *a: jloss(*a)["total"], argnums=(0, 1, 2))(
        jnp.asarray(cls), jnp.asarray(ltrb), jnp.asarray(ctr))
    heads = [torch.from_numpy(a).requires_grad_(True) for a in (cls, ltrb, ctr)]
    loc, strides = tfcos.generate_locations(SIZE)
    got = tfcos.loss(*heads, loc, strides, torch.from_numpy(boxes),
                     torch.from_numpy(classes), torch.from_numpy(valid),
                     num_classes=CLASSES)
    assert set(got) == {"cls", "box", "ctr", "total"}
    for k in got:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6), k
    got["total"].backward()
    for name, h, r in zip(("cls", "ltrb", "ctr"), heads, jg):
        assert _max_scaled(h.grad.numpy(), np.asarray(r)) <= 1e-5, name


# ---------------------------------------------------------------------------
# train-mode BatchNorm, SGD, burn-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_matches_jax(dtype):
    """Output (f32 within 1e-6 max-scaled; bf16 within one bf16 ulp),
    the running statistics after the update (1e-6 max-scaled) and, in
    float32, the gradients through the batch statistics (1e-5)."""
    rng = np.random.RandomState(5)
    x = (rng.randn(3, 5, 6, 16) * 2 + 1).astype(np.float32)
    bn = {"scale": (1 + rng.randn(16) * 0.2).astype(np.float32),
          "bias": (rng.randn(16) * 0.3).astype(np.float32),
          "mean": (rng.randn(16) * 0.1).astype(np.float32),
          "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    ct = rng.randn(3, 5, 6, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)

    def jloss(x, scale, bias):
        y, stats = JL.batch_norm(x, {**{k: jnp.asarray(v) for k, v in bn.items()},
                                     "scale": scale, "bias": bias}, train=True)
        return jnp.sum(y.astype(jnp.float32) * ct), (y, stats)

    (_, (jy, jstats)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                               has_aux=True)(
        jx, jnp.asarray(bn["scale"]), jnp.asarray(bn["bias"]))
    mod = TL.BatchNorm(16)
    with torch.no_grad():
        for k, v in bn.items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    mod.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt).requires_grad_(True)
    y = mod(tx)
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    got = y.detach().float().permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jy.astype(jnp.float32))
    if dtype == "float32":
        assert _max_scaled(got, ref) <= 1e-6
        for g, r in zip((tx.grad.permute(0, 2, 3, 1), mod.scale.grad,
                         mod.bias.grad), jg):
            assert _max_scaled(g.numpy(), np.asarray(r)) <= 1e-5
    else:
        big = np.maximum(np.abs(got), np.abs(ref))
        ulp = (big.view(np.int32) & 0x7F800000).view(np.float32) * 2.0 ** -7
        assert (np.abs(got - ref) <= ulp + 1e-6).all()
        assert tx.grad.dtype == torch.bfloat16
        assert mod.scale.grad.dtype == torch.float32
    for k in ("mean", "var"):
        assert _max_scaled(_np(getattr(mod, k)), np.asarray(jstats[k])) <= 1e-6


def test_eval_batch_norm_leaves_running_stats():
    mod = TL.BatchNorm(4).eval()
    mod(torch.randn(2, 4, 3, 3))
    assert torch.equal(mod.mean, torch.zeros(4))
    assert torch.equal(mod.var, torch.ones(4))


def test_sgd_update_matches_jax():
    """v ← m·v + g + wd·p left to right, then p ← p − lr·v: within one
    float32 ulp of the JAX update run op by op."""
    rng = np.random.RandomState(6)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 3, 5)}
    p, g, v = ({k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
               for _ in range(3))
    jp, jv = jtraining.sgd_update(
        {k: jnp.asarray(a) for k, a in p.items()},
        {k: jnp.asarray(a) for k, a in g.items()},
        {k: jnp.asarray(a) for k, a in v.items()}, lr=0.05, momentum=0.9,
        weight_decay=5e-4)
    tp = {k: torch.from_numpy(a.copy()) for k, a in p.items()}
    tv = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    ttraining.sgd_update(tp, {k: torch.from_numpy(a) for k, a in g.items()}, tv,
                         lr=0.05, momentum=0.9, weight_decay=5e-4)
    for k in shapes:
        for got, ref in ((tp[k], jp[k]), (tv[k], jv[k])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=float(np.spacing(np.abs(ref).max())))
    zeros = ttraining.sgd_init(tp)
    assert all(torch.equal(z, torch.zeros_like(tp[k])) for k, z in zeros.items())


def test_burn_in_lr_matches_jax():
    for step in (0, 1, 10, 999, 1000, 1001, 4000, 8000, 12000):
        kw = dict(base_lr=0.01, burn_in=1000, milestones=(4000, 8000))
        assert ttraining.burn_in_lr(step, **kw) == jtraining.burn_in_lr(step, **kw)


# ---------------------------------------------------------------------------
# one whole train step against JAX make_train_step (`_torch_train_step`)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family():
    return "fcos"


@pytest.fixture(scope="module")
def batch():
    return step_batch("fcos")


@pytest.fixture(scope="module")
def jax_run(batch):
    return jax_step_run("fcos", batch)


@pytest.fixture(scope="module")
def port_run(jax_run, batch):
    return port_step_run("fcos", jax_run["flat"], batch)


def test_loss_falls_over_four_steps():
    """Four port steps at PARITY_LR on one fixed batch from the seeded
    init: the total loss falls at every step."""
    model = registry.get_model("fcos", num_classes=CLASSES,
                               compute_dtype=torch.float32, input_size=SIZE)
    TL.init_weights(model, 0)
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    data = train_batch(0, BATCH, SIZE, CLASSES)
    totals = [float(step(*data, LR)["total"]) for _ in range(4)]
    assert all(np.isfinite(totals))
    assert all(b < a for a, b in zip(totals, totals[1:])), totals


def test_make_train_step_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = registry.get_model("fcos", num_classes=CLASSES, input_size=SIZE)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttraining.make_train_step(model, input_size=SIZE)


def test_step_rejects_a_batch_of_another_size():
    model = registry.get_model("fcos", num_classes=CLASSES,
                               compute_dtype=torch.float32, input_size=SIZE)
    step = ttraining.make_train_step(model, input_size=SIZE, device="cpu")
    images, *gt = train_batch(2, 1, 32, CLASSES)
    with pytest.raises(ValueError, match="uint8"):
        step(images, *gt, 1e-3)
