"""Port parity of the RAPiD slice: the 18-channel head, the angle-aware
decode, the rotated API branch and the whole detect path, against the
JAX package on the CPU in float32.

One JAX `get_model("rapid").init(PRNGKey(0))` tree serves the file,
loaded into the port with `from_jax_params` and `strict=True`. Module
gates are norm-relative (`_rel_close`: error over the reference's max
|value|). The saturated golden (`tests/golden/rapid_e2e.npz`: every
score 1.0, every θ ±π/2, widths up to 3.5e6 px) is reproduced under
`tests/test_golden_e2e.py`'s own gates.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from chip_smoke import golden_image, person_boxes  # noqa: E402
from mydetection_tpu.api import strip_detections as jstrip  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.models import darknet as jdarknet  # noqa: E402
from mydetection_tpu.models import layers as JL  # noqa: E402
from mydetection_tpu.models import rapid as jrapid  # noqa: E402
from mydetection_tpu.models import yolov3 as jyolo  # noqa: E402
from mydetection_tpu.ops.rotated import rotated_postprocess_impl  # noqa: E402
from mydetection_tpu.registry import dense_from_raw  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu.utils import image_ops as jimg  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch.api import make_post, strip_detections  # noqa: E402
from mydetection_tpu_torch.convert import from_jax_params  # noqa: E402
from mydetection_tpu_torch.models import rapid as trapid  # noqa: E402
from mydetection_tpu_torch.models import yolov3 as tyolo  # noqa: E402
from mydetection_tpu_torch.registry import forward_dense, get_model  # noqa: E402
from mydetection_tpu_torch.utils import image_ops as timg  # noqa: E402

GOLDEN = "tests/golden/rapid_e2e.npz"
SIZE = 64


def _rel_close(a, b, tol):
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(np.asarray(a) / scale, np.asarray(b) / scale,
                               atol=tol)


@pytest.fixture(scope="module")
def jax_tree():
    return jget_model("rapid").init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_flat(jax_tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}


@pytest.fixture(scope="module")
def port_model(jax_flat):
    model = get_model("rapid", compute_dtype=torch.float32)
    model.load_state_dict(from_jax_params(jax_flat), strict=True)
    return model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def u8():
    return np.random.RandomState(7).randint(
        0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def small_run(jax_tree, port_model, u8):
    """Both frameworks on one 64² uint8 batch, op by op on the JAX side:
    {jax, port} raw heads [P5, P4, P3], NHWC numpy."""
    x = JL.normalize_input(jnp.asarray(u8), jnp.float32)
    feats, _ = jdarknet.apply(jax_tree["backbone"], x,
                              compute_dtype=jnp.float32, s2d_stem=False,
                              scan_blocks=False)
    jraw, _ = jyolo.apply(jax_tree["head"], feats, compute_dtype=jnp.float32)
    with torch.no_grad():
        traw = port_model(torch.from_numpy(u8))
    return {"jax": [np.asarray(r) for r in jraw],
            "port": [r.numpy() for r in traw]}


def test_rapid_config_matches_jax():
    cfg = get_model("rapid").config
    ref = jget_model("rapid").config
    for field in ("family", "num_classes", "input_size", "rotated",
                  "conf_thres", "nms_iou", "pre_nms", "max_dets",
                  "class_names"):
        assert getattr(cfg, field) == getattr(ref, field), field
    assert cfg.input_size == 1024 and cfg.pre_nms == 512


def test_bridge_loads_rapid_tree_strictly(jax_flat, port_model):
    """Every JAX leaf maps to one port parameter of the same size, and
    the three output convs are 3 anchors × 6 channels."""
    sd = port_model.state_dict()
    assert sorted(from_jax_params(jax_flat)) == sorted(sd)
    for head in ("head5", "head4", "head3"):
        assert sd[f"head.{head}.out.weight"].shape[0] == 18
        np.testing.assert_array_equal(sd[f"head.{head}.out.bias"].numpy(),
                                      jax_flat[f"head/{head}/out/b"])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_rapid_raw_heads_match_jax(small_run, level):
    j, t = small_run["jax"][level], small_run["port"][level]
    assert t.shape == j.shape and t.shape[-1] == 18
    _rel_close(t, j, 1e-5)


def _raws(seed, scale=4.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, s, s, 18) * scale).astype(np.float32)
            for s in (2, 4, 8)]


@pytest.mark.parametrize("level", [0, 1, 2])
def test_decode_level_matches_jax(level):
    """Unsaturated logits, some twh past the ±8 clamp: boxes and conf
    within 1e-6 of the largest value (exp and sigmoid round alike to an
    ulp), θ in (−π/2, π/2)."""
    raw = _raws(level)[level]
    ref = jrapid.decode_level(jnp.asarray(raw), jrapid.ANCHORS[level],
                              jrapid.STRIDES[level])
    got = trapid.decode_level(torch.from_numpy(raw), trapid.ANCHORS[level],
                              trapid.STRIDES[level])
    for key in ("boxes5", "conf"):
        assert got[key].dtype == torch.float32
        _rel_close(got[key].numpy(), np.asarray(ref[key]), 1e-6)
    np.testing.assert_allclose(got["boxes5"][..., 4].numpy(),
                               np.asarray(ref["boxes5"][..., 4]), rtol=0,
                               atol=1e-6)
    assert (got["boxes5"][..., 4].abs() < np.pi / 2).all()


def test_decode_with_anchor_override_matches_dense_from_raw():
    """forward_dense's rapid branch honours the config's anchor table,
    as `dense_from_raw` does."""
    anchors = ((10, 20), (30, 40), (50, 60)), ((5, 6), (7, 8), (9, 10)), \
        ((1, 2), (3, 4), (5, 6))
    raws = _raws(3)

    class Stub(torch.nn.Module):
        config = get_model("rapid", anchors=anchors).config

        def forward(self, images):
            return [torch.from_numpy(r) for r in raws]

    got = forward_dense(Stub(), torch.zeros(2, SIZE, SIZE, 3,
                                            dtype=torch.uint8))
    ref = dense_from_raw([jnp.asarray(r) for r in raws],
                         jget_model("rapid", anchors=anchors).config)
    assert sorted(got) == sorted(ref) == ["boxes", "scores"]
    _rel_close(got["boxes"].numpy(), np.asarray(ref["boxes"]), 1e-6)
    _rel_close(got["scores"].numpy(), np.asarray(ref["scores"]), 1e-6)


def test_hot_theta_logit_lands_in_its_cell_and_anchor(monkeypatch):
    """One hot θ and conf logit at P4 (stride 16), cell (y=2, x=3),
    anchor 1, put there by the output conv in NCHW: after the head's
    NHWC permute and the decode's flatten it sits at P5's 12 rows + (2·4
    + 3)·3 + 1 and decodes to that cell's centre, anchor and angle."""
    head = tyolo.YOLOv3Head(1, channels_per_anchor=6).requires_grad_(False)
    for branch in (head.head5, head.head4, head.head3):
        branch.out.bias.zero_()
    feats = [torch.zeros(1, c, s, s) for c, s in ((256, 8), (512, 4),
                                                  (1024, 2))]
    real_conv2d = tyolo.conv2d

    def fake_conv2d(x, w, **kw):
        if w.shape[0] != 18:
            return real_conv2d(x, w, **kw)
        y = torch.zeros(x.shape[0], 18, *x.shape[2:])
        if x.shape[2] == 4:                            # P4
            y[0, 1 * 6 + 4, 2, 3] = 3.0                # θ logit, anchor 1
            y[0, 1 * 6 + 5, 2, 3] = 20.0               # conf
        return y

    monkeypatch.setattr(tyolo, "conv2d", fake_conv2d)
    with torch.no_grad():
        out = trapid.decode(head(feats))
    i = 2 * 2 * 3 + (2 * 4 + 3) * 3 + 1
    assert int(out["conf"][0].argmax()) == i
    theta = (torch.sigmoid(torch.tensor(3.0)) - 0.5) * np.pi
    assert int(out["boxes5"][0, :, 4].abs().argmax()) == i
    np.testing.assert_allclose(out["boxes5"][0, i].numpy(),
                               [3.5 * 16, 2.5 * 16, 130, 155, float(theta)],
                               rtol=1e-6)


def test_detect_path_matches_jax(small_run):
    """The port's forward_dense + postprocess on its raw heads against
    the JAX raw heads of the same batch through `dense_from_raw` and
    `rotated_postprocess_impl`, per-image conf: counts equal, scores
    within 1e-4 (the raw heads agree to 1e-5 of their largest value,
    ahead of the sigmoid), boxes within 1e-2 px + 1e-4 relative (widths
    reach 1e6 px at init)."""
    jcfg = jget_model("rapid", compute_dtype=jnp.float32).config
    dense = dense_from_raw([jnp.asarray(r) for r in small_run["jax"]], jcfg)
    cfg = get_model("rapid").config
    tdense = trapid.decode([torch.from_numpy(r) for r in small_run["port"]])
    confs = np.array([0.25, 0.5], np.float32)
    got = make_post(cfg)({"boxes": tdense["boxes5"],
                          "scores": tdense["conf"]},
                         torch.from_numpy(confs), 0.45)
    for i in range(2):
        ref = rotated_postprocess_impl(
            dense["boxes"][i], dense["scores"][i], conf_thres=float(confs[i]),
            iou_thres=0.45, pre_nms=512, max_dets=100, approx_topk=False)
        valid = np.asarray(ref["valid"])
        assert valid.sum() > 0
        np.testing.assert_array_equal(got["valid"][i].numpy(), valid)
        np.testing.assert_array_equal(got["classes"][i].numpy(),
                                      np.asarray(ref["classes"]))
        np.testing.assert_allclose(got["scores"][i].numpy(),
                                   np.asarray(ref["scores"]), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["boxes"][i].numpy(),
                                   np.asarray(ref["boxes"]), rtol=1e-4,
                                   atol=1e-2)


# ---------------------------------------------------------------------------
# the API's rotated branch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def det128(jax_flat):
    return Detector("rapid", input_size=128, compute_dtype=torch.float32,
                    device="cpu", params=jax_flat)


def test_golden_rapid_128(det128):
    """The JAX PRNGKey(0) weights through the port reproduce the JAX
    pipeline's golden under its own gates (counts and classes equal,
    scores rtol 1e-5 / atol 1e-6, xyxy and boxes_rot rtol 1e-4 / atol
    1e-2). Measured on the CPU: scores equal, boxes_rot within 2.5e-3 px
    on widths of 3.5e6 px, the envelopes within 3.1e-5 px."""
    d = det128.detect_one(np_img=golden_image(), conf_thres=0.25,
                          nms_iou=0.45)
    ref = np.load(GOLDEN)
    assert len(d) == len(ref["scores"]) == 100
    np.testing.assert_array_equal(d.classes, ref["classes"])
    np.testing.assert_allclose(d.scores, ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d.boxes_xyxy, ref["boxes"], rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(d.boxes_rot, ref["boxes_rot"], rtol=1e-4,
                               atol=1e-2)


def test_as_array_reports_degrees(det128):
    d = det128.detect_one(np_img=golden_image()[:200], conf_thres=0.25)
    rows = d.as_array()
    assert rows.shape == (len(d), 6) and len(d) > 0
    np.testing.assert_array_equal(rows[:, :4], d.boxes_rot[:, :4])
    np.testing.assert_allclose(rows[:, 4], np.degrees(d.boxes_rot[:, 4]),
                               rtol=1e-6)
    assert np.abs(rows[:, 4]).max() <= 90.0 + 1e-4
    np.testing.assert_array_equal(rows[:, 5], d.scores)


def _padded_out(rng, n_valid, k=10):
    boxes = np.zeros((1, k, 5), np.float32)
    boxes[0, :n_valid] = person_boxes(rng, n_valid, canvas=128.0)
    boxes[0, 0] = [120, 5, 90, 30, 0.6]        # reaches past the corner
    valid = np.zeros((1, k), bool)
    valid[0, :n_valid] = True
    return {"boxes": boxes, "valid": valid,
            "scores": np.where(valid, np.float32(0.9), np.float32(0)),
            "classes": np.where(valid, 0, -1).astype(np.int32)}


@pytest.mark.parametrize("n_valid", [0, 1, 7])
def test_strip_rotated_matches_jax(n_valid):
    """The host strip against the JAX package's on one padded output:
    boxes_rot equal (the same float32 inverse letterbox), the envelope
    within 1e-3 px (cos/sin ulps) and NOT clipped to the image."""
    out = _padded_out(np.random.RandomState(n_valid), n_valid)
    info = timg.LetterboxInfo(ori_w=200, ori_h=100, ratio=0.64, pad_x=0.0,
                              pad_y=32.0, input_size=128)
    jinfo = jimg.LetterboxInfo(ori_w=200, ori_h=100, ratio=0.64, pad_x=0.0,
                               pad_y=32.0, input_size=128)
    got = strip_detections(out, 0, info, rotated=True)
    ref = jstrip(out, 0, jinfo, rotated=True)
    assert len(got) == n_valid and got.boxes_rot.shape == (n_valid, 5)
    assert got.boxes_xyxy.shape == (n_valid, 4)
    np.testing.assert_array_equal(got.boxes_rot, ref.boxes_rot)
    np.testing.assert_allclose(got.boxes_xyxy, ref.boxes_xyxy, rtol=0,
                               atol=1e-3)
    if n_valid:
        assert got.boxes_xyxy[0, 2] > info.ori_w   # unclipped envelope
    np.testing.assert_array_equal(
        timg.detections_to_original(out["boxes"][0], info),
        jimg.detections_to_original(out["boxes"][0], jinfo))


@pytest.fixture(scope="module")
def det64(jax_flat):
    return Detector("rapid", input_size=SIZE, compute_dtype=torch.float32,
                    device="cpu", params=jax_flat)


def test_detect_batch_equals_detect_prepared(det64, tmp_path):
    """Same batch through every surface: detect_batch, detect_prepared
    and detect_imgSeq agree bit for bit, and detect_one with
    detect_prepared of that one image (a batch of 1 may take other conv
    algorithms). At 64² N = 252 < pre_nms, so the postprocess pads."""
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((50, 80), (64, 64), (90, 40))]
    batch = det64.detect_batch(imgs, conf_thres=0.3)
    canvases, infos = zip(*(timg.letterbox_np(i, SIZE) for i in imgs))
    prepared = det64.detect_prepared(np.stack(canvases), list(infos),
                                     conf_thres=0.3)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(paths[-1])
    seq = det64.detect_imgSeq(paths, conf_thres=0.3)
    assert sum(len(d) for d in batch) > 0
    for a, b, c in zip(batch, prepared, seq):
        for other in (b, c):
            np.testing.assert_array_equal(a.boxes_rot, other.boxes_rot)
            np.testing.assert_array_equal(a.boxes_xyxy, other.boxes_xyxy)
            np.testing.assert_array_equal(a.scores, other.scores)
        assert (a.classes == 0).all() and (np.diff(a.scores) <= 0).all()
    one = det64.detect_one(np_img=imgs[0], conf_thres=0.3)
    alone = det64.detect_prepared(np.stack(canvases[:1]), list(infos[:1]),
                                  conf_thres=0.3)[0]
    np.testing.assert_array_equal(one.boxes_rot, alone.boxes_rot)
    np.testing.assert_array_equal(one.boxes_xyxy, alone.boxes_xyxy)


def test_seeded_rapid_detector_runs_on_cpu():
    """The port's own seeded init at bf16, the smoke run's recipe at
    64²: finite, descending, θ in [−π/2, π/2], w and h positive."""
    det = Detector("rapid", input_size=SIZE, device="cpu", rng_seed=0)
    img = golden_image()[:60, :60]
    dets = det.detect_batch([img, img[:, ::-1]])
    for d in dets:
        assert len(d) > 0 and (np.diff(d.scores) <= 0).all()
        assert np.isfinite(d.boxes_rot).all() and (d.boxes_rot[:, 2:4] > 0).all()
        assert (np.abs(d.boxes_rot[:, 4]) <= np.float32(np.pi / 2)).all()
