"""Port parity of the FCOS slice: ResNet-50, the FPN, the FCOS head and
decode, the multi-label postprocess, and the whole detect path, against
the JAX package on the CPU in float32.

One JAX `get_model("fcos").init(PRNGKey(0))` tree serves the file,
loaded into the port with `from_jax_params` and `strict=True`. Module
gates are norm-relative (`_rel_close`: error over the reference's max
|value|), never rtol-only near 0. The port's towers run the GN kernel's
plain version (one-pass variance); the JAX package on the CPU runs its
unfused `group_norm` (two-pass), so head outputs carry that difference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import golden_image  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.models import fcos as jfcos  # noqa: E402
from mydetection_tpu.models import fpn as jfpn  # noqa: E402
from mydetection_tpu.models import layers as JL  # noqa: E402
from mydetection_tpu.models import resnet as jresnet  # noqa: E402
from mydetection_tpu.ops import nms as jnms  # noqa: E402
from mydetection_tpu.registry import dense_from_raw  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch.api import make_post  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.models import fcos as tfcos  # noqa: E402
from mydetection_tpu_torch.models import layers as TL  # noqa: E402
from mydetection_tpu_torch.models import resnet as tresnet  # noqa: E402
from mydetection_tpu_torch.ops import nms as tnms  # noqa: E402
from mydetection_tpu_torch.registry import forward_dense, get_model  # noqa: E402

SIZE = 128
CONF = 0.005  # at init scores sit near 0.01 × 0.5


def _rel_close(a, b, tol):
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=tol)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_tree():
    return jget_model("fcos").init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_flat(jax_tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}


@pytest.fixture(scope="module")
def port_model(jax_flat):
    model = get_model("fcos", compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(jax_flat), strict=True)
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def u8():
    return np.random.RandomState(7).randint(
        0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def small_run(jax_tree, port_model, u8):
    """Both frameworks on one 128² uint8 batch, op by op on the JAX
    side: {jax, port} × (C3-5, P3-7, raw heads (cls, ltrb, ctr, gate)),
    all NHWC / flat numpy."""
    f32 = jnp.float32
    x, fold = jresnet.prepare_input(jnp.asarray(u8), compute_dtype=f32)
    assert not fold
    jfeats, _ = jresnet.apply(jax_tree["backbone"], x, depth=50,
                              compute_dtype=f32, scan_blocks=False)
    jpyr = jfpn.apply(jax_tree["fpn"], jfeats, compute_dtype=f32)
    jraw = jfcos.apply(jax_tree["head"], jpyr, num_classes=80,
                       compute_dtype=f32, with_gate=True, fused_gn=False)
    with torch.no_grad():
        images = torch.from_numpy(u8)
        tfeats = port_model.backbone(tresnet.prepare_input(
            images.permute(0, 3, 1, 2), torch.float32))
        tpyr = port_model.fpn(tfeats)
        traw = port_model.head(tpyr, with_gate=True)
    return {"jax": ([np.asarray(f) for f in jfeats],
                    [np.asarray(p) for p in jpyr],
                    [np.asarray(r) for r in jraw]),
            "port": ([_nhwc(f) for f in tfeats], [_nhwc(p) for p in tpyr],
                     [r.numpy() for r in traw]),
            "pyramid": (jpyr, tpyr)}


# ---------------------------------------------------------------------------
# layers, backbone, FPN, head
# ---------------------------------------------------------------------------

def test_max_pool_matches_jax():
    """Even and odd sizes, with negative inputs at the border: the −inf
    pad must never win."""
    for h, w in ((8, 8), (7, 9)):
        x = np.random.RandomState(h).randn(2, h, w, 3).astype(np.float32) - 5
        ref = np.asarray(JL.max_pool(jnp.asarray(x), 3, 2))
        got = _nhwc(TL.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_input_matches_jax(dtype):
    u8 = np.arange(256 * 3, dtype=np.int64).reshape(1, 16, 16, 3) % 256
    u8 = u8.astype(np.uint8)
    ref, _ = jresnet.prepare_input(jnp.asarray(u8),
                                   compute_dtype=getattr(jnp, dtype))
    got = tresnet.prepare_input(torch.from_numpy(u8).permute(0, 3, 1, 2),
                                getattr(torch, dtype))
    np.testing.assert_array_equal(_nhwc(got.float()),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_resnet50_features_match_jax(small_run, level):
    j, t = small_run["jax"][0][level], small_run["port"][0][level]
    assert t.shape == j.shape
    _rel_close(t, j, 1e-5)


@pytest.mark.parametrize("level", range(5))
def test_fpn_levels_match_jax(small_run, level):
    j, t = small_run["jax"][1][level], small_run["port"][1][level]
    assert t.shape == j.shape
    _rel_close(t, j, 1e-5)


@pytest.mark.parametrize("i,name", enumerate(["cls", "ltrb", "ctr", "gate"]))
def test_fcos_raw_heads_match_jax(small_run, i, name):
    """Flat (B, N, ...) in the JAX concat order. The GN variance forms
    differ (module docstring): gate 1e-5 of the largest value."""
    j, t = small_run["jax"][2][i], small_run["port"][2][i]
    assert t.shape == j.shape and t.dtype == j.dtype
    _rel_close(t, j, 1e-5)


def test_linear_ltrb_decode_matches_jax(jax_tree, port_model, small_run):
    jpyr, tpyr = small_run["pyramid"]
    _, jltrb, _ = jfcos.apply(jax_tree["head"], jpyr, compute_dtype=jnp.float32,
                              ltrb_decode="linear")
    with torch.no_grad():
        _, tltrb, _ = port_model.head(tpyr, ltrb_decode="linear")
    _rel_close(tltrb.numpy(), np.asarray(jltrb), 1e-5)
    with pytest.raises(ValueError, match="ltrb_decode"):
        port_model.head(tpyr, ltrb_decode="sqrt")


@pytest.mark.parametrize("size", [160, 608])
def test_locations_match_jax(size):
    jl, js = jfcos.generate_locations(size)
    tl, ts = tfcos.generate_locations(size)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tfcos.level_shapes(size) == jfcos.level_shapes(size)


def test_decode_matches_jax():
    rng = np.random.RandomState(8)
    n = sum(h * w for h, w in tfcos.level_shapes(64))
    cls = rng.randn(2, n, 5).astype(np.float32) * 3
    ltrb = np.exp(rng.randn(2, n, 4)).astype(np.float32) * 8
    ctr = rng.randn(2, n).astype(np.float32)
    jl, _ = jfcos.generate_locations(64)
    ref = jfcos.decode(jnp.asarray(cls), jnp.asarray(ltrb), jnp.asarray(ctr), jl)
    got = tfcos.decode(torch.from_numpy(cls), torch.from_numpy(ltrb),
                       torch.from_numpy(ctr), tfcos.generate_locations(64)[0])
    np.testing.assert_array_equal(got["boxes"].numpy(), np.asarray(ref["boxes"]))
    _rel_close(got["scores"].numpy(), np.asarray(ref["scores"]), 1e-6)


def test_head_flattens_levels_then_rows(monkeypatch):
    """One hot class logit at level 1 (P4, stride 16), cell (y=2, x=3),
    class 4, and distinct l/t/r/b raw values there: after the permute
    and the flatten it must sit at that level's offset + 2·W + 3, and
    decode to that location's box."""
    head = tfcos.FCOSHead(num_classes=6, channels=32)
    shapes = tfcos.level_shapes(64)                    # 8, 4, 2, 1, 1
    pyramid = [torch.zeros(1, 32, h, w) for h, w in shapes]

    def fake_conv_bias(conv, x, *, stride=1):
        y = torch.zeros(x.shape[0], conv.out_channels, *x.shape[2:])
        if x.shape[2] == 4:                            # level 1
            if conv is head.cls_out:
                y[0, 4, 2, 3] = 20.0
            elif conv is head.box_out:
                y[0, :, 2, 3] = torch.tensor([0.1, 0.2, 0.3, 0.4])
        return y

    monkeypatch.setattr(tfcos, "conv_bias", fake_conv_bias)
    with torch.no_grad():
        cls, ltrb, ctr, gate = head(pyramid, with_gate=True)
    i = shapes[0][0] * shapes[0][1] + 2 * 4 + 3
    assert int(cls[0].amax(dim=1).argmax()) == i
    assert int(cls[0, i].argmax()) == 4 and float(gate[0, i]) == 20.0
    raw = torch.tensor([0.1, 0.2, 0.3, 0.4])
    np.testing.assert_allclose(ltrb[0, i].numpy(), (torch.exp(raw) * 16).numpy())
    box = tfcos.decode_boxes(ltrb, tfcos.generate_locations(64)[0])[0, i]
    x, y = 3 * 16, 2 * 16
    l, t, r, b = (torch.exp(raw) * 16).tolist()
    np.testing.assert_allclose(box.numpy(), [x - l, y - t, x + r, y + b],
                               rtol=1e-6)


def test_fcos_init_distributions():
    """`init_weights` on fcos: He-normal backbone and FPN, N(0, 0.01)
    head convs, the focal prior on cls_out, identity GN, unit scales."""
    model = get_model("fcos").requires_grad_(False)
    TL.init_weights(model, 0)
    head = model.head
    assert abs(float(head.cls_tower.conv2.weight.std()) - 0.01) < 1e-3
    assert abs(float(head.ctr_out.weight.std()) - 0.01) < 1e-3
    stem = model.backbone.stem.conv.weight
    assert abs(float(stem.std()) - (2.0 / (3 * 49)) ** 0.5) < 0.01
    np.testing.assert_allclose(head.cls_out.bias.numpy(), -np.log(99),
                               rtol=1e-6)
    assert not head.box_out.bias.any() and not model.fpn.p6.bias.any()
    assert (head.box_tower.gn3.scale == 1).all()
    assert not head.box_tower.gn3.bias.any()
    assert (head.scales == 1).all()


# ---------------------------------------------------------------------------
# the score_logits postprocess, against postprocess_impl
# ---------------------------------------------------------------------------

def _post_case(kind, b=3, n=300, c=6):
    rng = np.random.RandomState({"random": 0, "ties": 1}[kind])
    cxy = rng.uniform(0, 128, (b, n, 2))
    wh = rng.uniform(4, 40, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    if kind == "ties":  # few distinct logits: ties in both top-k stages
        logits = rng.randint(-3, 2, (b, n, c)).astype(np.float32)
        mul = np.full((b, n), 0.5, np.float32)
    else:
        logits = (rng.randn(b, n, c) * 2).astype(np.float32)
        mul = rng.uniform(0.2, 1.0, (b, n)).astype(np.float32)
    return boxes, logits, mul


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("multi_label", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_score_logits_postprocess_matches_jax(kind, multi_label, gate):
    """pre_nms 64 of 300 boxes × 6 classes, max_dets 20, per-image conf."""
    boxes, logits, mul = _post_case(kind)
    confs = np.array([0.05, 0.2, 0.35], np.float32)
    gl = logits.max(-1) if gate else None
    got = tnms.postprocess(
        torch.from_numpy(boxes), score_logits=torch.from_numpy(logits),
        score_mul=torch.from_numpy(mul),
        gate_logits=None if gl is None else torch.from_numpy(gl),
        conf_thres=torch.from_numpy(confs), iou_thres=0.45, pre_nms=64,
        max_dets=20, multi_label=multi_label)
    for i in range(len(boxes)):
        ref = jnms.postprocess_impl(
            jnp.asarray(boxes[i]), score_logits=jnp.asarray(logits[i]),
            score_mul=jnp.asarray(mul[i]),
            gate_logits=None if gl is None else jnp.asarray(gl[i]),
            conf_thres=float(confs[i]), iou_thres=0.45, pre_nms=64,
            max_dets=20, multi_label=multi_label)
        assert int(got["valid"][i].sum()) > 0
        for key in ("valid", "classes"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
        _rel_close(got["scores"][i].numpy(), np.asarray(ref["scores"]), 1e-6)
        np.testing.assert_array_equal(got["boxes"][i].numpy(),
                                      np.asarray(ref["boxes"]))


def test_postprocess_rejects_dense_scores_and_both_inputs():
    """Dense (B, N, C) scores, which the RetinaNet slice brought, are
    taken: the sigmoid of fcos logits times the centerness, single-label,
    bit-equal to `postprocess_impl(multi_label=False)` image by image.
    Passing both scores and score_logits still raises."""
    boxes, logits, mul = _post_case("random", b=2)
    scores = (1 / (1 + np.exp(-logits)) * mul[..., None]).astype(np.float32)
    got = tnms.postprocess(torch.from_numpy(boxes), torch.from_numpy(scores),
                           conf_thres=0.1, iou_thres=0.45, pre_nms=64,
                           max_dets=20, multi_label=False)
    for i in range(len(boxes)):
        ref = jnms.postprocess_impl(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), conf_thres=0.1,
            iou_thres=0.45, pre_nms=64, max_dets=20, multi_label=False)
        assert int(np.asarray(ref["valid"]).sum()) > 0
        for key in ("boxes", "scores", "classes", "valid"):
            np.testing.assert_array_equal(got[key][i].numpy(),
                                          np.asarray(ref[key]), err_msg=key)
    with pytest.raises(ValueError, match="not both"):
        tnms.postprocess(torch.from_numpy(boxes),
                         torch.from_numpy(logits[..., 0]),
                         score_logits=torch.from_numpy(logits),
                         conf_thres=0.1, iou_thres=0.45)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_label", [True, False])
def test_detect_path_matches_jax(jax_tree, jax_flat, small_run, u8,
                                 multi_label):
    """The port's whole device path (model → forward_dense → postprocess)
    against the JAX raw heads of the same batch through `dense_from_raw`
    and `postprocess_impl`, for the registered multi-label config and
    `get_model("fcos", multi_label=False)`."""
    jcfg = jget_model("fcos", multi_label=multi_label,
                      compute_dtype=jnp.float32).config
    jraw = [jnp.asarray(r) for r in small_run["jax"][2]]
    if not multi_label:
        jraw = jraw[:3]
    dense = dense_from_raw(tuple(jraw), jcfg, input_size=SIZE)
    model = get_model("fcos", multi_label=multi_label,
                      compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(jax_flat), strict=True)
    model.eval().requires_grad_(False)
    with torch.no_grad():
        tdense = forward_dense(model, torch.from_numpy(u8))
        got = make_post(model.config)(tdense, torch.full((2,), CONF), 0.45)
    assert ("score_gate" in tdense) == multi_label
    for i in range(len(u8)):
        ref = jnms.postprocess_impl(
            dense["boxes"][i], score_logits=dense["score_logits"][i],
            score_mul=dense["score_mul"][i],
            gate_logits=(dense["score_gate"][i] if multi_label else None),
            conf_thres=CONF, iou_thres=0.45, pre_nms=1024, max_dets=100,
            multi_label=multi_label)
        valid = np.asarray(ref["valid"])
        assert valid.sum() > 0
        np.testing.assert_array_equal(got["valid"][i].numpy(), valid)
        np.testing.assert_array_equal(got["classes"][i].numpy(),
                                      np.asarray(ref["classes"]))
        np.testing.assert_allclose(got["scores"][i].numpy(),
                                   np.asarray(ref["scores"]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["boxes"][i].numpy(),
                                   np.asarray(ref["boxes"]), rtol=0,
                                   atol=1e-2)


def test_golden_fcos_160(jax_flat):
    """The port's CPU Detector on the JAX PRNGKey(0) weights reproduces
    tests/golden/fcos_e2e.npz under the golden's own gates (counts and
    classes equal, scores rtol 1e-5 / atol 1e-6, boxes rtol 1e-4 / atol
    1e-2 px). Measured on the CPU: max relative score error 4.6e-6, max
    box error 1.4e-4 px over the 100 detections."""
    det = Detector("fcos", input_size=160, compute_dtype=torch.float32,
                   device="cpu", params=jax_flat)
    d = det.detect_one(np_img=golden_image(), conf_thres=0.005, nms_iou=0.45)
    ref = np.load("tests/golden/fcos_e2e.npz")
    assert len(d) == len(ref["scores"]) == 100
    np.testing.assert_array_equal(d.classes, ref["classes"])
    np.testing.assert_allclose(d.scores, ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.boxes_xyxy, ref["boxes"], rtol=1e-4,
                               atol=1e-2)


def test_seeded_fcos_detector_runs_on_cpu():
    """The port's own seeded init at bf16 (the smoke run's recipe, small):
    the prior keeps scores near 0.01 × 0.5, far from the 0.5 a default
    init would give, and every image yields detections at conf 0.005."""
    det = Detector("fcos", input_size=64, device="cpu", rng_seed=0)
    img = golden_image()[:60, :60]
    dets = det.detect_batch([img, img[:, ::-1]], conf_thres=CONF)
    assert [len(d) for d in dets] == [100, 100]
    for d in dets:
        assert d.scores.max() < 0.05 and (np.diff(d.scores) <= 0).all()
        assert np.isfinite(d.boxes_xyxy).all()
