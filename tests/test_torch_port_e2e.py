"""The port's slice end to end: the YOLOv3-416 golden, the Detector
surface, the copied letterbox geometry, and the port's independence
from JAX (no import of `jax` or of `mydetection_tpu`).
"""

import os
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from chip_smoke import golden_image, padded_canvas  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu.utils import image_ops as jimg  # noqa: E402
from mydetection_tpu_torch import Detector, list_models  # noqa: E402
from mydetection_tpu_torch.utils import image_ops as timg  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "yolov3_e2e.npz"


@pytest.fixture(scope="module")
def jax_flat():
    params = jget_model("yolov3").init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in flatten_tree(params).items()}


@pytest.fixture(scope="module")
def det416(jax_flat):
    return Detector("yolov3", input_size=416, compute_dtype=torch.float32,
                    device="cpu", params=jax_flat)


def test_golden_yolov3_416(det416):
    """The JAX PRNGKey(0) weights through the port reproduce the JAX
    pipeline's golden: counts and classes equal, scores within 1e-4,
    boxes within 1e-2 px. Measured on the CPU: max |d score| 0.0,
    max |d box| 0.0 px (all 100 detections bit-equal)."""
    d = det416.detect_one(np_img=golden_image(), conf_thres=0.25, nms_iou=0.45)
    ref = np.load(GOLDEN)
    assert len(d) == len(ref["scores"])
    np.testing.assert_array_equal(d.classes, ref["classes"])
    np.testing.assert_allclose(d.scores, ref["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.boxes_xyxy, ref["boxes"], rtol=0, atol=1e-2)


@pytest.fixture(scope="module")
def det64(jax_flat):
    return Detector("yolov3", input_size=64, compute_dtype=torch.float32,
                    device="cpu", params=jax_flat)


def _images():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in ((50, 80), (64, 64), (90, 40))]


def _same(a, b):
    np.testing.assert_array_equal(a.boxes_xyxy, b.boxes_xyxy)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.classes, b.classes)


def _prepared(imgs, size=64):
    canvases, infos = zip(*(timg.letterbox_np(i, size) for i in imgs))
    return np.stack(canvases), list(infos)


def test_detect_batch_equals_detect_prepared(det64):
    """Same batch, same convs: the surfaces agree bit for bit."""
    imgs = _images()
    batch = det64.detect_batch(imgs, conf_thres=0.3)
    assert len(batch) == 3 and sum(len(d) for d in batch) > 0
    for d, p in zip(batch, det64.detect_prepared(*_prepared(imgs),
                                                 conf_thres=0.3)):
        _same(d, p)
        assert (np.diff(d.scores) <= 0).all()
        assert d.as_array().shape == (len(d), 6)
    img = imgs[0]
    _same(det64.detect_one(np_img=img, conf_thres=0.3),
          det64.detect_prepared(*_prepared([img]), conf_thres=0.3)[0])


def test_detect_prepared_per_image_conf(det64):
    """A per-image conf vector gives each row what that row's scalar
    conf gives it on the same batch."""
    canvases, infos = _prepared(_images())
    confs = [0.2, 0.5, 0.9]
    mixed = det64.detect_prepared(canvases, infos, conf_thres=confs)
    for i, c in enumerate(confs):
        _same(mixed[i], det64.detect_prepared(canvases, infos,
                                              conf_thres=c)[i])
        assert len(mixed[i]) and (mixed[i].scores >= np.float32(c)).all()
    with pytest.raises(ValueError, match="entries"):
        det64.detect_prepared(canvases, infos, conf_thres=[0.1, 0.2])


def test_detect_imgseq_reads_paths(det64, tmp_path):
    imgs = _images()
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(paths[-1])
    for a, b in zip(det64.detect_imgSeq(paths, conf_thres=0.3),
                    det64.detect_batch(imgs, conf_thres=0.3)):
        _same(a, b)


def test_detector_rejects_bad_inputs(det64):
    with pytest.raises(ValueError, match="provide one of"):
        det64.detect_one()
    with pytest.raises(ValueError, match="multiple of 32"):
        det64.detect_one(np_img=_images()[0], input_size=50)
    with pytest.raises(ValueError, match="uint8"):
        det64.detect_prepared(np.zeros((1, 64, 64, 3), np.float32),
                              [timg.letterbox_np(_images()[0], 64)[1]])
    with pytest.raises(KeyError, match="available"):
        Detector("ssd300", device="cpu")
    assert det64.detect_batch([]) == []


def test_detector_loads_npz_checkpoint(jax_flat, det64, tmp_path):
    from mydetection_tpu.checkpoint import save_checkpoint, unflatten_tree

    path = str(tmp_path / "w.npz")
    save_checkpoint(path, unflatten_tree(jax_flat))
    det = Detector("yolov3", weights_path=path, input_size=64,
                   compute_dtype=torch.float32, device="cpu")
    img = _images()[0]
    _same(det.detect_one(np_img=img, conf_thres=0.3),
          det64.detect_one(np_img=img, conf_thres=0.3))


def test_seeded_init_is_deterministic():
    """`init_weights`: He-normal conv weights from the seed, zero conv
    biases, identity BatchNorms."""
    from mydetection_tpu_torch.models.layers import ConvBNLeaky, init_weights
    from mydetection_tpu_torch.models.yolov3 import Branch

    def make(seed):
        m = torch.nn.Sequential(ConvBNLeaky(3, 32, 3), Branch(32, 64, 255))
        init_weights(m, seed)
        return m.state_dict()

    a, b, c = make(3), make(3), make(4)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.conv.weight"], c["0.conv.weight"])
    w = a["1.conv.conv.weight"]
    assert abs(float(w.std()) - (2.0 / (32 * 9)) ** 0.5) < 0.01
    assert not a["1.out.bias"].any()
    assert (a["0.bn.scale"] == 1).all() and (a["0.bn.var"] == 1).all()
    assert list_models() == ["fcos", "rapid", "retinanet", "retinanet_r101",
                             "yolov3", "yolov3_608"]


def test_detector_defaults_to_cuda():
    if torch.cuda.is_available():
        assert Detector("yolov3").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Detector("yolov3")


# ---------------------------------------------------------------------------
# letterbox: the copy equals the JAX module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,size", [(300, 500, 416), (100, 200, 416),
                                      (480, 640, 416), (64, 64, 416),
                                      (1, 300, 64), (333, 77, 608)])
def test_letterbox_matches_jax(h, w, size):
    img = np.random.RandomState(h + w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    canvas, info = timg.letterbox_np(img, size)
    ref_canvas, ref_info = jimg.letterbox_np(img, size)
    np.testing.assert_array_equal(canvas, ref_canvas)
    assert dataclass_tuple(info) == dataclass_tuple(ref_info)
    boxes = np.array([[-50, -50, 1e4, 1e4], [10, 20, 60, 70]], np.float32)
    np.testing.assert_array_equal(timg.boxes_xyxy_to_original(boxes, info),
                                  jimg.boxes_xyxy_to_original(boxes, ref_info))


def dataclass_tuple(info):
    return (info.ori_w, info.ori_h, info.ratio, info.pad_x, info.pad_y,
            info.input_size)


def test_letterbox_grayscale_pil_and_empty():
    img = Image.new("L", (120, 80), 7)
    canvas, info = timg.letterbox_pil(img, 64)
    ref_canvas, ref_info = jimg.letterbox_pil(img, 64)
    np.testing.assert_array_equal(canvas, ref_canvas)
    assert dataclass_tuple(info) == dataclass_tuple(ref_info)
    with pytest.raises(ValueError, match="empty image"):
        timg.letterbox_np(np.zeros((0, 0, 3), np.uint8), 64)


def test_padded_canvas_is_a_letterbox_without_resize():
    canvas, info = padded_canvas(golden_image(), 416, 8, 58)
    assert canvas.shape == (416, 416, 3)
    back = timg.boxes_xyxy_to_original(
        np.array([[8, 58, 408, 358]], np.float32), info)
    np.testing.assert_array_equal(back, [[0, 0, 400, 300]])


# ---------------------------------------------------------------------------
# independence from JAX
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mydetection_tpu\b(?!_torch)"
    r"|from\s+mydetection_tpu\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix()
     for p in (REPO / "mydetection_tpu_torch").rglob("*.py")]
    + [p.name for p in REPO.glob("chip_*.py")]))
def test_port_never_imports_jax(path):
    src = (REPO / path).read_text()
    assert not _FORBIDDEN.search(src), path


def test_port_imports_alone():
    """A fresh interpreter imports the port without loading jax."""
    import subprocess
    import sys

    code = ("import sys, mydetection_tpu_torch, chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mydetection_tpu.')) or "
            "m == 'mydetection_tpu']; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
