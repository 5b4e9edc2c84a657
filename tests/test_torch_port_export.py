"""The port's export artifact (`mydetection_tpu_torch.export`) on the CPU.

`tests/test_export.py`'s cases with the port's own objects: a yolov3
Detector at 64², float32, exported at buckets (1, 2) and loaded with
`registry.get_model` patched to raise, answers bit for bit as the live
Detector does (detect_one, detect_batch through `_chunks`,
detect_prepared on a bucket and off it, per-image conf); conf_thres
stays an input; multi-size buckets through the CLI's JSON line;
`evaluate --exported`
writes the live evaluator's rows, and refuses a contradicting
`--rotated`; `load_exported` refuses a file that is not an artifact, a
JAX artifact, a newer version and a platform mismatch, each from a
synthesised `__meta__`.

The CPU programs trace each kernel's plain version; the plain greedy
NMS unrolls a few ops a row, so the Detectors here take pre_nms 64 (the
registered 1024 makes a yolov3 program of about 9,000 nodes, 30 s to
export and 15 s to load on this host). `tests/test_torch_port_serve.py`
reproduces the registered yolov3@416 golden from an artifact and serves
a rapid one; `tests/test_torch_port_tools.py` holds the int8 round
trip.
"""

import functools
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_scripts import coco_dir  # noqa: E402,F401  (the module fixture)

import mydetection_tpu_torch  # noqa: E402
from mydetection_tpu_torch import Detector, registry  # noqa: E402
from mydetection_tpu_torch import api as papi  # noqa: E402
from mydetection_tpu_torch import evaluate as p_evaluate  # noqa: E402
from mydetection_tpu_torch import export as pexport  # noqa: E402
from mydetection_tpu_torch import native as pnative  # noqa: E402
from mydetection_tpu_torch.checkpoint import save_checkpoint, unflatten_tree  # noqa: E402
from mydetection_tpu_torch.convert import to_jax_params  # noqa: E402
from mydetection_tpu_torch.eval.evaluator import evaluate_detector  # noqa: E402
from mydetection_tpu_torch.export import (  # noqa: E402
    ExportedDetector,
    export_detector,
    load_exported,
)
from mydetection_tpu_torch.utils.image_ops import letterbox_np  # noqa: E402

SIZE = 64
PRE_NMS = 64
CONF = 0.3
RNG = np.random.RandomState(11)
IMG = RNG.randint(0, 255, (50, 80, 3)).astype(np.uint8)
CONFIG = dict(num_classes=2, pre_nms=PRE_NMS, compute_dtype=torch.float32,
              device="cpu")


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


class NoModelCode:
    """`registry.get_model` (and api's name for it) replaced by a
    function that raises: serving an artifact must not build a model."""

    def __init__(self, mp):
        self.calls = 0

        def refuse(*args, **kwargs):
            self.calls += 1
            raise AssertionError("an artifact was served through get_model")

        mp.setattr(registry, "get_model", refuse)
        mp.setattr(papi, "get_model", refuse)


def scaled_weights(path, name, scale=0.7, **overrides) -> str:
    """The port's seeded init of `name` with every conv kernel scaled by
    `scale`, as an `.npz` both the API and the CLIs take: at 1.0 the
    seeded yolov3 heads saturate (every score 1.0, so no threshold
    between 0.05 and 0.9 tells two runs apart)."""
    model = Detector(name, device="cpu", **overrides).model
    flat = {k: v * scale if v.ndim == 4 else v
            for k, v in to_jax_params(model.state_dict()).items()}
    save_checkpoint(str(path), unflatten_tree(flat))
    return str(path)


@pytest.fixture(scope="module")
def work():
    """A directory removed after the module: the artifacts carry full
    yolov3 weights (250 MB each), which pytest would otherwise keep."""
    with tempfile.TemporaryDirectory() as root:
        yield Path(root)


@pytest.fixture(scope="module")
def weights(work):
    return scaled_weights(work / "w.npz", "yolov3", input_size=SIZE,
                          num_classes=2)


@pytest.fixture(scope="module")
def det(weights):
    return Detector("yolov3", weights_path=weights, input_size=SIZE, **CONFIG)


@pytest.fixture(scope="module")
def artifact(det, work):
    path = str(work / "yolov3.npz")
    export_detector(det, path, batch_size=(1, 2))
    return path


@pytest.fixture(scope="module")
def served(artifact):
    """The artifact loaded while get_model raises."""
    with pytest.MonkeyPatch.context() as mp:
        guard = NoModelCode(mp)
        out = load_exported(artifact)
        assert guard.calls == 0
    return out


def canvases(n, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, SIZE, SIZE, 3), np.uint8)


def assert_same(a, b):
    np.testing.assert_array_equal(a.boxes_xyxy, b.boxes_xyxy)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.classes, b.classes)
    if a.boxes_rot is not None or b.boxes_rot is not None:
        np.testing.assert_array_equal(a.boxes_rot, b.boxes_rot)


def test_roundtrip_programs_bit_equal(det, served):
    """Each bucket's program returns the live Detector's padded
    outputs bit for bit, at one conf and at one conf an image."""
    for b, conf in ((1, CONF), (2, CONF), (2, [0.05, 0.6])):
        c = canvases(b, seed=b)
        want = det._run_batch(c, conf, det.cfg.nms_iou, b)
        got = served._run(c, conf)
        assert set(got) == set(want) == {"boxes", "scores", "classes",
                                         "valid"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["valid"].any()


def test_roundtrip_surfaces(det, served, tmp_path):
    """detect_one (with a render) and detect_batch over 3 images (a
    bucket of 2, then one of 1): the live answers at the same batch
    shapes (a conv at another batch size may sum in another order)."""
    imgs = [IMG, RNG.randint(0, 255, (64, 64, 3)).astype(np.uint8),
            RNG.randint(0, 255, (90, 40, 3)).astype(np.uint8)]
    want = (det.detect_batch(imgs[:2], conf_thres=CONF)
            + det.detect_batch(imgs[2:], conf_thres=CONF))
    got = served.detect_batch(imgs, conf_thres=CONF)
    assert len(got) == 3 and sum(len(d) for d in got) > 0
    for w, g in zip(want, got):
        assert_same(w, g)
    path = str(tmp_path / "vis.png")
    one = served.detect_one(np_img=IMG, conf_thres=CONF, visualize=True,
                            save_path=path)
    assert_same(one, det.detect_one(np_img=IMG, conf_thres=CONF))
    assert one.visualized.shape == IMG.shape
    from PIL import Image
    assert Image.open(path).size == (IMG.shape[1], IMG.shape[0])


def test_conf_thres_stays_dynamic(det, served):
    """conf_thres is an input of the programs: each threshold gives the
    live count."""
    lo = served.detect_one(np_img=IMG, conf_thres=0.05)
    hi = served.detect_one(np_img=IMG, conf_thres=0.9)
    assert len(lo) == len(det.detect_one(np_img=IMG, conf_thres=0.05))
    assert len(hi) == len(det.detect_one(np_img=IMG, conf_thres=0.9))
    assert len(lo) > len(hi)


def test_chunk_plan_avoids_tiny_call_storms():
    """A (1, 32) artifact must serve 31 images as ONE padded batch-32
    call, not 31 batch-1 calls."""
    ed = ExportedDetector(meta={}, params=None,
                          _calls={(416, 1): None, (416, 32): None})
    assert ed._chunks(31) == [(31, 32)]
    assert ed._chunks(16) == [(16, 32)]
    assert ed._chunks(33) == [(32, 32), (1, 1)]
    assert ed._chunks(64) == [(32, 32), (32, 32)]
    assert ed._chunks(2) == [(1, 1), (1, 1)]  # tiny tails stay small
    only4 = ExportedDetector(meta={}, params=None, _calls={(416, 4): None})
    assert only4._chunks(3) == [(3, 4)]
    assert only4._chunks(9) == [(4, 4), (4, 4), (1, 4)]


def test_nms_iou_is_baked(served):
    served.detect_one(np_img=IMG, nms_iou=served.meta["nms_iou"])
    with pytest.raises(ValueError, match="nms_iou is static"):
        served.detect_one(np_img=IMG, nms_iou=0.6)
    with pytest.raises(ValueError, match="nms_iou is static"):
        served.detect_prepared(canvases(2), [None, None], nms_iou=0.6)


def test_detect_prepared_guards_and_paths(det, served):
    """On a bucket and off it (3 canvases: a bucket of 2 and one of 1)
    the live rows at the same batch shapes; packed, wrong-size and
    miscounted inputs refused."""
    imgs = [IMG, IMG[::-1].copy(), IMG[:, ::-1].copy()]
    c, infos = zip(*(letterbox_np(i, SIZE) for i in imgs))
    c, infos = np.stack(c), list(infos)
    want = (det.detect_prepared(c[:2], infos[:2], conf_thres=CONF)
            + det.detect_prepared(c[2:], infos[2:], conf_thres=CONF))
    for n in (2, 3):
        got = served.detect_prepared(torch.from_numpy(c[:n]), infos[:n],
                                     conf_thres=CONF)
        assert len(got) == n
        for w, g in zip(want, got):
            assert_same(w, g)
    with pytest.raises(ValueError, match="packed canvases"):
        served.detect_prepared(np.zeros((2, 32, 32, 12), np.uint8), infos[:2])
    with pytest.raises(ValueError, match="baked at input_size"):
        served.detect_prepared(np.zeros((2, 96, 96, 3), np.uint8), infos[:2])
    with pytest.raises(ValueError, match="per-image conf_thres"):
        served.detect_prepared(c[:2], infos[:2], conf_thres=[0.1, 0.2, 0.3])
    with pytest.raises(ValueError, match="not in this artifact"):
        served.detect_one(np_img=IMG, input_size=96)


def test_meta(served, det):
    m = served.meta
    assert (m["format"], m["version"]) == ("mydetection-torch-export", 1)
    assert m["model"] == "yolov3" and m["input_sizes"] == [SIZE]
    assert m["batch_sizes"] == [1, 2] and m["batch_size"] == 2
    assert m["platforms"] == ["cpu"] and m["custom_ops"] == []
    assert m["conf_vector"] is True and m["pack_input"] is False
    assert m["quantized"] is False and m["rotated"] is False
    assert m["torch_version"] == torch.__version__
    assert len(served.params) == len(det.model.state_dict())
    assert served.supports_conf_vector
    assert served.cfg.num_classes == 2 and served.device.type == "cpu"


def test_served_without_model_code(det, served, monkeypatch):
    """The fixture loaded the artifact with get_model raising; detecting
    needs it no more than loading did."""
    guard = NoModelCode(monkeypatch)
    got = served.detect_one(np_img=IMG, conf_thres=CONF)
    assert guard.calls == 0
    monkeypatch.undo()
    assert_same(got, det.detect_one(np_img=IMG, conf_thres=CONF))


@pytest.fixture(scope="module")
def cli_export(weights, work):
    """`python -m mydetection_tpu_torch.export` at two sizes with
    `--oracle-nms`: (the printed JSON line, the returned one, the
    artifact's path)."""
    import contextlib
    import io

    out = str(work / "cli.npz")
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(mydetection_tpu_torch, "Detector",
                   functools.partial(Detector, pre_nms=PRE_NMS))
        line = pexport.main(["--model", "yolov3", "--out", out, "--weights",
                             weights, "--input-size", f"{SIZE},96",
                             "--batch-size", "1", "--num-classes", "2",
                             "--float32", "--device", "cpu",
                             "--oracle-nms"])
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    return printed, line, out


def test_cli_export_multi_size(det, cli_export):
    """The CLI prints one JSON line; its two-size artifact serves either
    size as the live Detector does and refuses a third."""
    printed, line, out = cli_export
    assert printed == line
    assert line["input_sizes"] == [SIZE, 96] and line["batch_sizes"] == [1]
    assert line["platforms"] == ["cpu"] and line["custom_ops"] == []
    served = load_exported(out)
    assert served.meta["input_size"] == SIZE
    assert served.meta["use_pallas"] is False
    for s in (SIZE, 96):
        assert_same(served.detect_one(np_img=IMG, conf_thres=CONF,
                                      input_size=s),
                    det.detect_one(np_img=IMG, conf_thres=CONF,
                                   input_size=s))
    with pytest.raises(ValueError, match="not in this artifact"):
        served.detect_one(np_img=IMG, input_size=128)


def test_evaluate_exported_equals_live(det, artifact, served, coco_dir,
                                      tmp_path, monkeypatch):
    """`evaluate --exported` (batches of 2, the artifact's bucket)
    writes the rows and stats of the live Detector's evaluation. The
    CLI gets the fixture's loaded artifact (loading is tested above)."""
    devices = []

    def loaded(path, device=None):
        devices.append(device)
        return served

    monkeypatch.setattr(pexport, "load_exported", loaded)
    rows = str(tmp_path / "rows.json")
    stats = p_evaluate.main([
        "--exported", artifact, "--ann", str(coco_dir / "ann.json"),
        "--img-dir", str(coco_dir), "--batch-size", "2", "--out", rows,
        "--num-threads", "1", "--device", "cpu"])
    assert devices == ["cpu"]
    live_rows = str(tmp_path / "live.json")
    live = evaluate_detector(det, str(coco_dir / "ann.json"), str(coco_dir),
                             batch_size=2, nms_iou=det.cfg.nms_iou,
                             num_threads=1, results_path=live_rows,
                             verbose=False)
    got, want = json.load(open(rows)), json.load(open(live_rows))
    assert len(got) == len(want) > 0
    assert got == want
    assert stats == live


def test_evaluate_cli_rejects_rotated_mismatch(artifact, coco_dir):
    with pytest.raises(SystemExit, match="axis-aligned"):
        p_evaluate.main(["--exported", artifact, "--rotated", "--ann",
                         str(coco_dir / "ann.json"), "--img-dir",
                         str(coco_dir)])


def test_evaluate_exported_runs_on_device_flag(tmp_path, coco_dir):
    """`evaluate --exported` loads on `--device` (default cuda): with no
    GPU a CPU artifact is refused unless `--device cpu` is given."""
    path = write_meta(tmp_path / "a.npz", format="mydetection-torch-export",
                      version=1, platforms=["cpu"], custom_ops=[],
                      rotated=False, model="yolov3", nms_iou=0.45)
    with pytest.raises(ValueError, match="no GPU"):
        p_evaluate.main(["--exported", path, "--ann",
                         str(coco_dir / "ann.json"), "--img-dir",
                         str(coco_dir)])


def write_meta(path, **meta) -> str:
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8))
    return str(path)


@pytest.mark.parametrize("case", ["not_npz", "no_meta", "jax", "future",
                                  "cuda_on_cpu", "cpu_trace_moved"])
def test_load_rejects(case, tmp_path):
    """Each refusal with a readable message, synthesised from
    `__meta__` alone."""
    path = tmp_path / "a.npz"
    ours = {"format": "mydetection-torch-export", "version": 1}
    if case == "not_npz":
        path.write_bytes(b"\xff\xd8 a jpeg, not an artifact")
        match = "is not a mydetection-torch-export artifact"
    elif case == "no_meta":
        np.savez(path, x=np.zeros(3))
        match = "is not a mydetection-torch-export artifact"
    elif case == "jax":
        write_meta(path, format="mydetection-tpu-export", version=3,
                   platforms=["tpu"])
        match = "StableHLO"
    elif case == "future":
        write_meta(path, **{**ours, "version": 2})
        match = "newer than this library supports"
    elif case == "cpu_trace_moved":
        # no custom op, and no `use_pallas` key: the kernels' route
        write_meta(path, **ours, platforms=["cpu"], custom_ops=[])
        with pytest.raises(ValueError, match="without use_pallas=False"):
            load_exported(str(path), device="meta")
        return
    else:
        write_meta(path, **ours, platforms=["cuda"],
                   custom_ops=["mydet::nms_keep"])
        with pytest.raises(ValueError, match="calls the card's kernels"):
            load_exported(str(path), device="cpu")
        match = "no GPU"
    with pytest.raises(ValueError, match=match):
        load_exported(str(path))


def test_plain_artifact_moves_device(cli_export):
    """An artifact exported with use_pallas=False (`--oracle-nms`) may be
    loaded on another device: its weights, constants and the devices
    written into its program (`move_to_device_pass`, then the graph's
    code regenerated) all follow. The meta device stands in for the
    card here (the card's test compares values:
    test_torch_port_cuda.py)."""
    artifact = cli_export[2]
    served = load_exported(artifact, device="meta")
    assert served.device.type == "meta"
    assert all(p.device.type == "meta" for p in served.params)
    out = served._calls[(96, 1)](
        served.params, torch.zeros((1, 96, 96, 3), dtype=torch.uint8,
                                   device="meta"),
        torch.zeros(1, device="meta"))
    rows = min(PRE_NMS, 100)   # max_dets rows, at most pre_nms
    assert {k: (v.device.type, tuple(v.shape)) for k, v in out.items()} == {
        "boxes": ("meta", (1, rows, 4)), "scores": ("meta", (1, rows)),
        "classes": ("meta", (1, rows)), "valid": ("meta", (1, rows))}


def test_kernel_route_artifact_stays_put(artifact):
    """An artifact exported with the kernels' route (the default) holds
    the plain versions on the CPU only because CPU tensors take them:
    moved to another device it would serve without the hand-written
    kernels, so the load refuses."""
    with pytest.raises(ValueError, match="without use_pallas=False"):
        load_exported(artifact, device="meta")


def test_epilogue_route_exports_the_op(det, work, monkeypatch):
    """With the conv epilogue's route forced onto CPU tensors (the route
    the card takes: each conv's BN, activation and residual as one
    `mydet::conv_epilogue` call), an exported yolov3 program calls the op
    once a conv (72 conv-BN-leaky, 3 output biases), its metadata lists
    the op, and, with the op's plain version bound to the CPU for the
    test, it answers as the live Detector bit for bit."""
    from mydetection_tpu_torch.kernels import epilogue, route
    from mydetection_tpu_torch.kernels.route import kernels_enabled

    def forced(module, x):
        return not module.training and kernels_enabled()

    def op(x, scale, bias, mean=None, var=None, residual=None, act=0,
           residual_after=True):
        return torch.ops.mydet.conv_epilogue(x, scale, bias, mean, var,
                                             residual, act, residual_after)

    monkeypatch.setattr(route, "takes_kernel", forced)
    monkeypatch.setattr(epilogue, "conv_epilogue", op)
    path = str(work / "epilogue.npz")
    meta = export_detector(det, path, batch_size=2)
    assert "mydet::conv_epilogue" in meta["custom_ops"]
    cpu_impl = torch.library.Library("mydet", "IMPL")
    try:
        cpu_impl.impl("conv_epilogue", epilogue.conv_epilogue_plain, "CPU")
        served = load_exported(path)
        [program] = served._calls.values()
        target = torch.ops.mydet.conv_epilogue.default
        assert sum(n.target is target
                   for n in program.gm.graph.nodes) == 75
        c = canvases(2, seed=5)
        got = served._run(c, CONF)
        monkeypatch.undo()
        want = det._run_batch(c, CONF, det.cfg.nms_iou, 2)
    finally:
        cpu_impl._destroy()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["valid"].any()
