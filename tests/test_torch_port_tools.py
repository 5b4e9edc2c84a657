"""The port's tools on the CPU: visualization, `detect_one(visualize=,
save_path=)`, profiling, FLOP counting, `summary`, data-parallel
detect, the demo CLI, the Detector options, and the int8 export round
trip.

  * `utils.visualization.draw_detections` pixel-equal to the JAX
    module's on the same detections (both draw with cv2 here);
  * `trace` writes a Chrome trace holding an `annotate` range (its
    spans: `test_torch_port_spans.py`);
  * `compiled_flops` of one 3x3 conv is 2·Cin·Cout·k²·H·W exactly, and
    the FLOP formulas of the fused conv kernels (`mydet::conv3x3_chain`,
    `mydet::fused_bottleneck`) equal the count of the convolutions
    they fuse; `device_peak_flops` knows the H100's published peaks and
    gives None for anything else;
  * `summary`'s parameter counts equal the JAX init's per top-level key
    of its tree (BN statistics included, as the JAX trees carry them),
    for every family, and yolov3@416 counts 65.86 GFLOPs an image, the
    public darknet figure (within 0.1%);
  * `Detector(data_parallel=True)` with the device list patched to two
    CPUs gives the single-device detections at the same chunk shapes,
    float and int8; `evaluate --data-parallel` the same rows;
  * the demo CLI on two images and a 4-frame video, and its readable
    exit on video without cv2;
  * `Detector(pack_input=True)` refused, `use_pallas=False` accepted;
  * an int8 yolov3 Detector exported and loaded answers bit for bit;
  * each `mydet::` op's fake implementation, on meta tensors, gives the
    plain version's output shape and dtype.
"""

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from mydetection_tpu import api as japi  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu.utils import visualization as jvis  # noqa: E402
from test_scripts import coco_dir  # noqa: E402,F401  (the module fixture)
from test_torch_port_export import scaled_weights  # noqa: E402

from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import demo as pdemo  # noqa: E402
from mydetection_tpu_torch import evaluate as p_evaluate  # noqa: E402
from mydetection_tpu_torch import native as pnative  # noqa: E402
from mydetection_tpu_torch.api import Detections  # noqa: E402
from mydetection_tpu_torch.export import export_detector, load_exported  # noqa: E402
from mydetection_tpu_torch.kernels import bottleneck as kb  # noqa: E402
from mydetection_tpu_torch.kernels import gather as kernels_gather  # noqa: E402
from mydetection_tpu_torch.kernels import gn as kernels_gn  # noqa: E402
from mydetection_tpu_torch.kernels import nms as kernels_nms  # noqa: E402
from mydetection_tpu_torch.kernels import rotated_nms as kernels_rot  # noqa: E402
from mydetection_tpu_torch.kernels import tower as kt  # noqa: E402
from mydetection_tpu_torch.models.resnet import Bottleneck  # noqa: E402
from mydetection_tpu_torch.parallel import mesh  # noqa: E402
from mydetection_tpu_torch.summary import main as summary_main  # noqa: E402
from mydetection_tpu_torch.summary import summarize  # noqa: E402
from mydetection_tpu_torch.utils import flops as pflops  # noqa: E402
from mydetection_tpu_torch.utils import profiling  # noqa: E402
from mydetection_tpu_torch.utils import visualization as pvis  # noqa: E402

SIZE = 64
CONF = 0.3
RNG = np.random.RandomState(5)
IMG = RNG.randint(0, 255, (60, 90, 3)).astype(np.uint8)
DARKNET_YOLOV3_416_GFLOPS = 65.86   # the darknet cfg's 65.86 BFLOPs
CONFIG = dict(input_size=SIZE, num_classes=2, pre_nms=64,
              compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: in the Tier-1 run six workers share the
    host's cores, and torch's per-op thread pools spin against each
    other otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(pnative, "available", lambda: False)


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory() as root:
        yield Path(root)


@pytest.fixture(scope="module")
def weights(work):
    return scaled_weights(work / "w.npz", "yolov3", input_size=SIZE,
                          num_classes=2)


@pytest.fixture(scope="module")
def det(weights):
    return Detector("yolov3", weights_path=weights, **CONFIG)


@pytest.fixture(scope="module")
def qdet(weights):
    """The int8 yolov3 (noise calibration), built once for the
    data-parallel and the export cases."""
    return Detector("yolov3", weights_path=weights, quantized=True, **CONFIG)


def two_cpus(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices",
                        lambda: [torch.device("cpu"), torch.device("cpu")])


def assert_same(a, b):
    np.testing.assert_array_equal(a.boxes_xyxy, b.boxes_xyxy)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.classes, b.classes)


# -- visualization -------------------------------------------------------


def test_draw_detections_equals_jax():
    """Axis-aligned and rotated rows, with and without class names:
    the port's render is the JAX module's, pixel for pixel."""
    assert pvis.has_cv2() and jvis._HAS_CV2
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (120, 160, 3)).astype(np.uint8)
    xy = np.array([[10, 20, 80, 90], [50, 5, 150, 60], [0, 0, 30, 30]],
                  np.float32)
    scores = np.array([0.9, 0.5, 0.31], np.float32)
    classes = np.array([0, 3, 1], np.int32)
    rot = np.array([[60, 60, 40, 20, 0.3], [100, 40, 30, 50, -1.0],
                    [20, 90, 10, 10, 1.2]], np.float32)
    for boxes_rot in (None, rot):
        for names in (None, ("a", "b")):
            args = dict(boxes_xyxy=xy, scores=scores, classes=classes,
                        boxes_rot=boxes_rot)
            got = pvis.draw_detections(img, Detections(**args),
                                       class_names=names)
            want = jvis.draw_detections(img, japi.Detections(**args),
                                        class_names=names)
            assert (got != img).any()
            np.testing.assert_array_equal(got, want)


def test_draw_without_cv2_copies(monkeypatch):
    monkeypatch.setattr(pvis, "_HAS_CV2", False)
    d = Detections(boxes_xyxy=np.array([[1, 1, 5, 5]], np.float32),
                   scores=np.array([0.9], np.float32),
                   classes=np.array([0], np.int32))
    out = pvis.draw_detections(IMG, d)
    assert out is not IMG
    np.testing.assert_array_equal(out, IMG)


def test_detect_one_visualize_and_save(det, tmp_path):
    path = str(tmp_path / "vis.png")
    d = det.detect_one(np_img=IMG, conf_thres=CONF, visualize=True,
                       save_path=path)
    assert len(d) > 0
    want = pvis.draw_detections(IMG, d, class_names=det.cfg.class_names)
    np.testing.assert_array_equal(d.visualized, want)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    plain = det.detect_one(np_img=IMG, conf_thres=CONF)
    assert plain.visualized is None
    assert_same(plain, d)


# -- profiling -----------------------------------------------------------


def test_trace_writes_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("port_stage"):
            (x @ x).sum()
    path = tmp_path / profiling.TRACE_FILE
    events = json.load(open(path))["traceEvents"]
    assert any(e.get("name") == "port_stage" for e in events)
    assert any(e.key == "port_stage" for e in prof.key_averages())


# -- FLOPs -----------------------------------------------------------------


def test_compiled_flops_of_one_conv():
    cin, cout, k, h, w = 16, 32, 3, 20, 24
    x = torch.zeros(1, cin, h, w)
    wt = torch.zeros(cout, cin, k, k)
    got = pflops.compiled_flops(torch.nn.functional.conv2d, x, wt,
                                padding=1)
    assert got == 2 * cin * cout * k * k * h * w
    assert pflops.compiled_flops(torch.add, x, x) is None


def count(fn, *args):
    with torch.no_grad(), FlopCounterMode(display=False) as c:
        fn(*args)
    return c.get_total_flops()


@pytest.mark.parametrize("c_in, downsample", [(64, True), (256, False)])
def test_fused_kernel_flop_formulas_equal_the_convs(c_in, downsample):
    """The registered formulas of #6 and #7 (what FlopCounterMode adds
    for the custom ops on the card) equal the count of the plain convs
    the kernels fuse, on the same shapes."""
    from torch.utils.flop_counter import flop_registry

    x = torch.randn(2, 64, 9, 13)
    packed = kt.pack_weights(torch.randn(4, 64, 64, 3, 3), torch.float32)
    biases = torch.zeros(4, 64)
    chain = flop_registry[torch.ops.mydet.conv3x3_chain]
    assert chain(x, packed, biases) == count(kt.conv3x3_chain_plain, x,
                                             packed, biases)
    x = torch.randn(2, c_in, 9, 13)
    block = Bottleneck(c_in, 256, 1, downsample).eval()
    f = kb.fold_bottleneck(block, torch.float32)
    fused = flop_registry[torch.ops.mydet.fused_bottleneck]
    assert fused(x, *f) == count(block.unfused, x) > 0
    assert fused(x, *f) == count(kb.fused_bottleneck_plain, x, *f)


def test_device_peak_flops(monkeypatch):
    assert pflops.device_peak_flops("bfloat16") is None  # no card here
    assert pflops.mfu(1e9, 100.0) is None and pflops.mfu(None, 1.0) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, dtype, peak in (("NVIDIA H100 80GB HBM3", "bfloat16", 989.4e12),
                              ("NVIDIA H100 80GB HBM3", torch.int8, 1978.9e12),
                              ("NVIDIA H100 80GB HBM3", "float32", 66.9e12),
                              ("NVIDIA H100 PCIe", "bfloat16", 756.5e12),
                              ("NVIDIA A100-SXM4-80GB", "bfloat16", None)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, n=name: n)
        assert pflops.device_peak_flops(dtype) == peak, (name, dtype)
    monkeypatch.setattr(pflops, "device_peak_flops", lambda dtype: 200e12)
    assert pflops.mfu(10e9, 2000.0) == pytest.approx(0.1)


# -- summary -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolov3", "rapid", "fcos", "retinanet"])
def test_summary_params_equal_jax_init(name):
    """Per top-level key of the JAX tree and in total; the JAX side by
    `jax.eval_shape`, which builds the tree's shapes without computing
    it."""
    tree = jax.eval_shape(
        lambda: jget_model(name, input_size=SIZE).init(jax.random.PRNGKey(0)))
    want = {k: int(sum(np.prod(leaf.shape)
                       for leaf in jax.tree_util.tree_leaves(v)))
            for k, v in tree.items()}
    info = summarize(name, input_size=SIZE, device="cpu")
    assert info["params_by_module"] == want
    assert info["params"] == sum(want.values())
    assert info["gflops_per_image"] > 0.5


def test_summary_yolov3_416_flops_and_cli(capsys):
    """65.86 GFLOPs an image at 416 (the darknet figure) and 62.0 M
    parameters with the BN statistics; the CLI prints them."""
    info = summary_main(["yolov3", "--input-size", "416", "--device", "cpu"])
    assert abs(info["gflops_per_image"] / DARKNET_YOLOV3_416_GFLOPS - 1) \
        < 1e-3, info["gflops_per_image"]
    assert abs(info["params"] / 1e6 - 62.0) < 0.01
    out = capsys.readouterr().out
    assert "65.86 GFLOPs/image" in out and "62.00 M params" in out
    with pytest.raises(RuntimeError, match="no GPU"):
        summarize("yolov3", input_size=SIZE)   # cuda by default


# -- Detector options and data parallel ------------------------------------


def test_detector_options(weights):
    with pytest.raises(ValueError, match="space-to-depth"):
        Detector("yolov3", pack_input=True, **CONFIG)
    plain = Detector("yolov3", weights_path=weights, use_pallas=False,
                     **CONFIG)
    assert plain.use_pallas is False and plain.supports_conf_vector
    assert Detector.supports_conf_vector is True


def test_data_parallel_equals_single_device(det, weights, monkeypatch):
    """Four images split 2 + 2 over two (CPU) replicas: the plain
    Detector's answers on the same 2-image batches, bit for bit, with at
    least one detection; one device is the single-device path."""
    assert Detector("yolov3", weights_path=weights, data_parallel=True,
                    **CONFIG)._replicas is None   # no CUDA device here
    two_cpus(monkeypatch)
    dp = Detector("yolov3", weights_path=weights, data_parallel=True,
                  **CONFIG)
    assert [d for d, _ in dp._replicas] == [torch.device("cpu")] * 2
    # the first device runs the Detector's own model; only the second
    # holds a copy
    assert dp._replicas[0][1] is dp._forward_dense
    imgs = [IMG, IMG[::-1].copy(), IMG[:, ::-1].copy(), np.roll(IMG, 9, 0)]
    got = dp.detect_batch(imgs, conf_thres=CONF)
    want = (det.detect_batch(imgs[:2], conf_thres=CONF)
            + det.detect_batch(imgs[2:], conf_thres=CONF))
    assert len(got) == 4 and sum(len(d) for d in got) > 0
    for w, g in zip(want, got):
        assert_same(w, g)
    # three images: chunks of 2 and 1, per-image conf kept in order
    got = dp.detect_batch(imgs[:3], conf_thres=[0.3, 0.9, 0.3])
    want = (det.detect_batch(imgs[:2], conf_thres=[0.3, 0.9])
            + det.detect_batch(imgs[2:3], conf_thres=0.3))
    for w, g in zip(want, got):
        assert_same(w, g)


def test_data_parallel_int8(weights, qdet, monkeypatch):
    q = qdet
    two_cpus(monkeypatch)
    dp = Detector("yolov3", weights_path=weights, quantized=True,
                  data_parallel=True, **CONFIG)
    assert len(dp._replicas) == 2
    imgs = [IMG, IMG[::-1].copy()]
    got = dp.detect_batch(imgs, conf_thres=0.05)
    want = [q.detect_one(np_img=i, conf_thres=0.05) for i in imgs]
    assert sum(len(d) for d in got) > 0
    for w, g in zip(want, got):
        assert_same(w, g)


def test_evaluate_data_parallel_cli(coco_dir, tmp_path, monkeypatch):
    """`evaluate --data-parallel` over two (CPU) replicas at batch 2
    writes the rows of a single-device run at batch 1 (the same
    per-replica batch shapes)."""
    two_cpus(monkeypatch)
    common = ["--model", "yolov3", "--input-size", str(SIZE), "--ann",
              str(coco_dir / "ann.json"), "--img-dir", str(coco_dir),
              "--float32", "--device", "cpu", "--num-threads", "1"]
    rows = {}
    for key, extra in (("dp", ["--data-parallel", "--batch-size", "2"]),
                       ("single", ["--batch-size", "1"])):
        rows[key] = str(tmp_path / f"{key}.json")
        p_evaluate.main(common + extra + ["--out", rows[key]])
    got, want = json.load(open(rows["dp"])), json.load(open(rows["single"]))
    assert len(got) == len(want) > 0 and got == want


# -- demo ----------------------------------------------------------------


def write_video(path: str, frames: int = 4) -> None:
    import cv2

    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0,
                             (80, 48))
    for i in range(frames):
        writer.write(np.roll(IMG[:48, :80], 5 * i, axis=1)[:, :, ::-1].copy())
    writer.release()


def test_demo_cli(tmp_path, capsys):
    """Two images and a 4-frame video in one directory: two renders and
    an annotated video of 4 frames."""
    import cv2

    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray(IMG).save(src / "a.png")
    Image.fromarray(IMG[::-1].copy()).save(src / "b.jpg", quality=95)
    write_video(str(src / "clip.avi"))
    out = tmp_path / "out"
    written = pdemo.main(["--model", "yolov3",
                          "--input", str(src), "--out-dir", str(out),
                          "--input-size", str(SIZE), "--float32",
                          "--device", "cpu"])
    assert sorted(os.path.basename(p) for p in written) == [
        "a_det.png", "b_det.png", "clip_det.avi"]
    text = capsys.readouterr().out
    assert "drawing: cv2" in text and "4 frames" in text
    assert Image.open(out / "a_det.png").size == (IMG.shape[1], IMG.shape[0])
    cap = cv2.VideoCapture(str(out / "clip_det.avi"))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4


def test_demo_video_without_cv2(tmp_path, monkeypatch):
    src = tmp_path / "clip.mp4"
    src.write_bytes(b"")
    monkeypatch.setattr(pvis, "_HAS_CV2", False)
    with pytest.raises(SystemExit, match="needs cv2"):
        pdemo.main(["--input", str(src), "--device", "cpu"])


# -- int8 export ---------------------------------------------------------


def test_int8_export_roundtrip(qdet, work):
    """An int8 yolov3 (noise calibration) exported and loaded: the
    quantized tree's leaves are program inputs (int8 among them), and
    the answers are the live Detector's, bit for bit."""
    path = str(work / "int8.npz")
    export_detector(qdet, path, batch_size=1)
    served = load_exported(path)
    assert served.meta["quantized"] is True
    assert "torch.int8" in served.meta["param_dtypes"]
    for seed in (0, 1):
        c = np.random.RandomState(seed).randint(0, 256, (1, SIZE, SIZE, 3),
                                                np.uint8)
        want = qdet._run_batch(c, 0.05, qdet.cfg.nms_iou, 1)
        got = served._run(c, 0.05)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert want["valid"].any()


# -- the custom ops' fake implementations ----------------------------------


def op_inputs(device):
    """Inputs of each `mydet::` op on `device`: name → args."""
    gen = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.float32, cl=False):
        x = torch.randn(*shape, generator=gen).to(dtype)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
        return x.to(device)

    block = Bottleneck(64, 256, 1, True).eval()
    f = kb.fold_bottleneck(block, torch.bfloat16)
    return {
        "nms_keep": (t(2, 50, 4), t(2, 50) > 0, 0.45),
        "nms_from_iou_keep": (t(2, 50, 50).abs(), t(2, 50) > 0, 0.45),
        "bias_gn_relu": (t(2, 64, 5, 7, dtype=torch.bfloat16, cl=True),
                         t(64), t(64), t(64), 32),
        "conv3x3_chain": (t(2, 64, 5, 7, dtype=torch.bfloat16, cl=True),
                          kt.pack_weights(t(4, 64, 64, 3, 3), torch.bfloat16)
                          .to(device), t(4, 64)),
        "fused_bottleneck": (t(2, 64, 5, 7, dtype=torch.bfloat16, cl=True),
                             *(v.to(device) for v in f)),
        "gather_rows": (t(2, 30, 8), torch.randint(0, 30, (2, 6)).to(device)),
    }


PLAIN = {
    "nms_keep": lambda b, v, thr: kernels_nms.nms_keep_plain(b, v, thr),
    "nms_from_iou_keep": lambda i, v, thr:
        kernels_rot.nms_from_iou_keep_plain(i, v, thr),
    "bias_gn_relu": lambda x, b, s, sh, g: kernels_gn.bias_gn_relu_plain(
        x, b, s, sh, groups=g),
    "conv3x3_chain": kt.conv3x3_chain_plain,
    "fused_bottleneck": kb.fused_bottleneck_plain,
    "gather_rows": kernels_gather.gather_rows_plain,
}


@pytest.mark.parametrize("name", sorted(PLAIN))
def test_custom_op_fake_shapes(name):
    """Each op's fake implementation, on meta tensors, gives the shape
    and dtype of the plain version's output on the CPU, and the
    kernel's channels_last layout for the 4-D outputs (the card's
    `opcheck` is in test_torch_port_cuda.py)."""
    from mydetection_tpu_torch.kernels import ops

    _, _, fake = ops._OPS[name]
    got = fake(*op_inputs("meta")[name])
    want = PLAIN[name](*op_inputs("cpu")[name])
    assert got.device.type == "meta"
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    if got.dim() == 4:
        assert got.is_contiguous(memory_format=torch.channels_last)
