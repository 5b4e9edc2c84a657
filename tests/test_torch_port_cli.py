"""The port's `train` and `evaluate` CLIs against the JAX package's
top-level `train.py` and `evaluate.py`, in process, on the CPU
(`--device cpu`, float32), on `tests/test_scripts.py`'s synthetic COCO
set:

  * `evaluate` (axis-aligned and `--rotated`) writes the rows the JAX
    CLI writes from the same `.npz`, and the same stats;
  * `train` resumed from a JAX-written checkpoint logs every loss term
    within 5e-5 relative of JAX `train.py` resumed from the same file,
    with the same lr and size, two iterations at 64², batch 2, and
    writes a velocity within the train step's gates of JAX's;
  * a fresh run with validation plus a resume, whose checkpoint JAX's
    `checkpoint.load_checkpoint` reads and whose TensorBoard file JAX's
    `read_scalars` reads;
  * `evaluate --quantized --calib-images 4` writes JAX's rows within
    the int8 path's tolerance (one to one, tie-aware) and its stats
    within 1e-3, and leaves with SystemExit on a directory without
    images;
  * `--device` defaults to cuda (an error here), and the TPU-only
    `pack_s2d2` input layout is refused.

Both packages share one weights file: the port's `init_weights` draws
other values than JAX's init of the same seed. The JAX CLIs' native
decoder is patched off inside the tests (they never build it), and so
is the port's, so both decode with PIL.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import mydetection_tpu.native  # noqa: E402
from mydetection_tpu import checkpoint as jckpt  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu.utils.tb_writer import read_scalars as j_read_scalars  # noqa: E402
from test_scripts import coco_dir  # noqa: E402,F401  (the module fixture)
from test_torch_port_eval import match_rows, scaled_init  # noqa: E402

from chip_smoke import (  # noqa: E402
    TRAIN_COSINE_GATE,
    TRAIN_L2_GATE,
    TRAIN_LOSS_RTOL,
    cosine,
    rel_l2,
)
from mydetection_tpu.checkpoint import SEP  # noqa: E402

from mydetection_tpu_torch import evaluate as p_evaluate  # noqa: E402
from mydetection_tpu_torch import native as pnative  # noqa: E402
from mydetection_tpu_torch import train as p_train  # noqa: E402
from mydetection_tpu_torch.data.loader import StreamingPipeline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the resumed velocity's scale, about that of the step's gradients
VELOCITY_STD = 1e-2


@pytest.fixture(autouse=True)
def pil_decode(monkeypatch):
    monkeypatch.setattr(mydetection_tpu.native, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)


def run_jax(script, args, monkeypatch, capsys):
    """A top-level JAX CLI's main() in process (`tests/test_scripts.py`)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_cli_{script}", os.path.join(REPO, f"{script}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *args])
    mod.main()
    return capsys.readouterr().out


def run_port(main, args, capsys):
    result = main(args)
    return result, capsys.readouterr().out


def rotated_ann(coco_dir, tmp_path, deg=15.0):
    gt = json.load(open(coco_dir / "ann.json"))
    for a in gt["annotations"]:
        bb = a["bbox"]
        a["bbox"] = [bb[0] + bb[2] / 2, bb[1] + bb[3] / 2, bb[2], bb[3], deg]
    path = tmp_path / "rot_ann.json"
    json.dump(gt, open(path, "w"))
    return str(path)


@pytest.mark.parametrize("rotated", [False, True])
def test_evaluate_cli_equals_jax(coco_dir, tmp_path, monkeypatch, capsys,
                                 rotated):
    npz = str(tmp_path / "w.npz")
    if rotated:
        ann = rotated_ann(coco_dir, tmp_path)
        jckpt.save_checkpoint(npz, scaled_init("rapid"))
        model = ["--model", "rapid", "--rotated"]
    else:
        ann = str(coco_dir / "ann.json")
        jckpt.save_checkpoint(npz, scaled_init("yolov3", num_classes=2))
        model = ["--model", "yolov3"]
    args = [*model, "--weights", npz, "--ann", ann, "--img-dir", str(coco_dir),
            "--input-size", "64", "--batch-size", "4", "--conf-thres", "0.3",
            "--max-images", "5", "--float32", "--exact-topk"]
    p_out, j_out = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    p_stats, _ = run_port(p_evaluate.main,
                          args + ["--out", p_out, "--device", "cpu"], capsys)
    run_jax("evaluate", args + ["--out", j_out], monkeypatch, capsys)
    p_rows, j_rows = json.load(open(p_out)), json.load(open(j_out))
    match_rows(p_rows, j_rows)
    if rotated:
        from mydetection_tpu.eval.rotated_eval import evaluate_rotated
        gt = json.load(open(ann))
        ids = {im["id"] for im in gt["images"][:5]}
        j_stats = evaluate_rotated(
            j_rows, {"images": gt["images"][:5],
                     "annotations": [a for a in gt["annotations"]
                                     if a["image_id"] in ids]},
            verbose=False)
    else:
        from mydetection_tpu.eval.cocoeval import COCOEvaluator
        gt = json.load(open(ann))
        gt["images"] = gt["images"][:5]
        ids = {im["id"] for im in gt["images"]}
        gt["annotations"] = [a for a in gt["annotations"]
                             if a["image_id"] in ids]
        j_stats = COCOEvaluator(gt).evaluate(j_rows, verbose=False)
    assert list(p_stats) == list(j_stats)
    for k in p_stats:
        assert abs(p_stats[k] - j_stats[k]) <= 1e-6, (k, p_stats, j_stats)


def matched_rows(p_rows, j_rows, score_tol=0.02, box_atol=2.0):
    """How many rows match one to one: same image and category, score
    within score_tol, every box number within box_atol px."""
    jb = np.asarray([r["bbox"] for r in j_rows], np.float64)
    js = np.asarray([r["score"] for r in j_rows])
    jk = np.asarray([(r["image_id"], r["category_id"]) for r in j_rows])
    used = np.zeros(len(j_rows), bool)
    for r in p_rows:
        d = np.abs(jb - np.asarray(r["bbox"])[None]).max(axis=1)
        cand = (~used & (jk == (r["image_id"], r["category_id"])).all(1)
                & (d <= box_atol) & (np.abs(js - r["score"]) <= score_tol))
        if cand.any():
            used[int(np.argmin(np.where(cand, d, np.inf)))] = True
    return int(used.sum())


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the int8 runs (see
    `test_torch_port_quant.one_torch_thread`: six workers' torch thread
    pools spin against each other on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_evaluate_quantized_cli_equals_jax(coco_dir, tmp_path, monkeypatch,
                                           capsys, one_torch_thread):
    """`--quantized --calib-images 4`: both CLIs calibrate on the first
    four images of the directory (sorted), then evaluate the int8 path.
    Each calibrates by itself, and the int8 chain turns float32
    differences at rounding ties into one-step moves, so the rows match
    one to one within score 0.02 and 2 px (tie-aware) on at least 0.9
    of them: measured 45 of 45 with torch's default threads, 44 of 45
    (one row fewer above the cut) with one thread, whose convs sum in
    another order; within score 1e-3 and 0.05 px only 10 match. The
    stats within 1e-3."""
    npz = str(tmp_path / "w.npz")
    jckpt.save_checkpoint(npz, scaled_init("yolov3", num_classes=2))
    args = ["--model", "yolov3", "--weights", npz, "--ann",
            str(coco_dir / "ann.json"), "--img-dir", str(coco_dir),
            "--input-size", "64", "--batch-size", "4", "--conf-thres", "0.3",
            "--max-images", "5", "--float32", "--exact-topk", "--quantized",
            "--calib-images", "4"]
    assert p_evaluate.calibration_paths(str(coco_dir), 4) == [
        str(coco_dir / f"img{i}.jpg") for i in range(4)]
    p_out, j_out = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    p_stats, _ = run_port(p_evaluate.main,
                          args + ["--out", p_out, "--device", "cpu"], capsys)
    run_jax("evaluate", args + ["--out", j_out], monkeypatch, capsys)
    p_rows, j_rows = json.load(open(p_out)), json.load(open(j_out))
    from mydetection_tpu.eval.cocoeval import COCOEvaluator
    gt = json.load(open(coco_dir / "ann.json"))
    gt["images"] = gt["images"][:5]
    ids = {im["id"] for im in gt["images"]}
    gt["annotations"] = [a for a in gt["annotations"] if a["image_id"] in ids]
    j_stats = COCOEvaluator(gt).evaluate(j_rows, verbose=False)
    n = matched_rows(p_rows, j_rows)
    assert len(j_rows) > 20
    assert n >= 0.9 * max(len(p_rows), len(j_rows)), (n, len(p_rows),
                                                      len(j_rows))
    assert list(p_stats) == list(j_stats)
    for k in p_stats:
        assert abs(p_stats[k] - j_stats[k]) <= 1e-3, (k, p_stats, j_stats)


def test_evaluate_quantized_cli_needs_images(coco_dir, tmp_path,
                                             one_torch_thread):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("no images here")
    with pytest.raises(SystemExit, match="no images"):
        p_evaluate.main(["--ann", str(coco_dir / "ann.json"), "--img-dir",
                         str(empty), "--quantized", "--device", "cpu",
                         "--input-size", "64"])


def _tb_rows(tb_dir):
    [name] = [f for f in os.listdir(tb_dir) if f.startswith("events.out")]
    return j_read_scalars(os.path.join(tb_dir, name))


def test_train_resumed_from_jax_checkpoint_equals_jax(coco_dir, tmp_path,
                                                      monkeypatch, capsys):
    """Both CLIs resume at iteration 5 from one JAX-written checkpoint
    (params and a non-zero velocity) and take two steps inside the
    default burn-in (lr ~1e-12, so both steps see the resumed weights):
    every loss term of both within TRAIN_LOSS_RTOL (5e-5) relative, lr
    and size equal; the velocity each writes at iteration 7 (0.81 times
    the resumed one plus two steps' gradients and weight decay) within
    the step gates of `tests/test_torch_port_train_yolov3.py`: cosine
    >= TRAIN_COSINE_GATE for every parameter, relative L2 <=
    TRAIN_L2_GATE. Measured on the CPU: loss terms within 3.6e-5,
    cosine >= 0.99899, relative L2 0.038; with the resumed velocity
    taken out of the port's the cosine falls to 0.945. Past the burn-in
    the second step's terms leave 5e-5: at lr 1e-6 its box term moves
    17% differently in the two packages, the ill-conditioned gradients
    of ROADMAP Queue C."""
    params = scaled_init("yolov3", num_classes=2)
    rng = np.random.RandomState(0)
    velocity = jax.tree_util.tree_map(
        lambda p: (VELOCITY_STD * rng.standard_normal(p.shape)).astype(p.dtype),
        params)
    ckpt = str(tmp_path / "start.npz")
    jckpt.save_checkpoint(ckpt, params, step=5, opt_state=velocity)
    common = ["--model", "yolov3", "--ann", str(coco_dir / "ann.json"),
              "--img-dir", str(coco_dir), "--batch-size", "2", "--sizes", "64",
              "--max-gt", "8", "--log-every", "1", "--float32",
              "--iterations", "7", "--ckpt-every", "100", "--resume", ckpt]
    runs = {}
    for who in ("port", "jax"):
        d = tmp_path / who
        args = common + ["--ckpt-dir", str(d / "w"),
                         "--tensorboard-dir", str(d / "tb")]
        if who == "port":
            _, out = run_port(p_train.main, args + ["--device", "cpu"], capsys)
        else:
            out = run_jax("train", args, monkeypatch, capsys)
        assert "resumed" in out and "at iteration 5" in out, out[-2000:]
        rows = [json.loads(x) for x in
                open(d / "w" / "yolov3_metrics.jsonl").read().splitlines()]
        runs[who] = (rows, _tb_rows(str(d / "tb")),
                     jckpt.load_checkpoint(str(d / "w" / "yolov3_7.npz")))
    (p_rows, p_tb, p_ck), (j_rows, j_tb, j_ck) = runs["port"], runs["jax"]
    assert [r["iter"] for r in p_rows] == [r["iter"] for r in j_rows] == [6, 7]
    assert [(r["lr"], r["size"]) for r in p_rows] \
        == [(r["lr"], r["size"]) for r in j_rows]
    p_loss = {(s, t): v for s, t, v in p_tb if t.startswith(("loss/", "train/lr"))}
    j_loss = {(s, t): v for s, t, v in j_tb if t.startswith(("loss/", "train/lr"))}
    assert set(p_loss) == set(j_loss)
    assert {t for _, t in p_loss} == {"loss/obj", "loss/box", "loss/cls",
                                      "loss/total", "train/lr"}
    for key, jv in j_loss.items():
        assert abs(p_loss[key] - jv) <= TRAIN_LOSS_RTOL * abs(jv), \
            (key, p_loss[key], jv)
    assert p_ck["step"] == j_ck["step"] == 7
    p_v, j_v = (jckpt.flatten_tree(c["opt"]) for c in (p_ck, j_ck))
    assert set(p_v) == set(j_v)
    # the BN mean/var leaves of the JAX velocity are the SGD update the
    # JAX step discards (its tree_merge writes the batch statistics over
    # it); the port keeps no velocity for them
    stats = tuple(f"{SEP}{n}" for n in ("mean", "var"))
    keys = [k for k in j_v if not k.endswith(stats)]
    cos = min((cosine(p_v[k], j_v[k]), k) for k in keys)
    assert cos[0] >= TRAIN_COSINE_GATE, cos
    l2 = rel_l2({k: p_v[k] for k in keys}, {k: j_v[k] for k in keys})
    assert l2 <= TRAIN_L2_GATE, l2
    # the resumed velocity is in there: without it the cosine drops
    fresh = {k: p_v[k] - 0.81 * jckpt.flatten_tree(velocity)[k] for k in keys}
    assert min(cosine(fresh[k], j_v[k]) for k in keys) < cos[0]


def test_train_fresh_val_and_resume(coco_dir, tmp_path, capsys):
    ckpt_dir = str(tmp_path / "weights")
    tb_dir = str(tmp_path / "tb")
    base = ["--model", "yolov3", "--ann", str(coco_dir / "ann.json"),
            "--img-dir", str(coco_dir), "--batch-size", "2", "--sizes", "64",
            "--max-gt", "8", "--log-every", "2", "--ckpt-dir", ckpt_dir,
            "--float32", "--device", "cpu"]
    last, out = run_port(p_train.main, base + [
        "--iterations", "3", "--ckpt-every", "3", "--tensorboard-dir", tb_dir,
        "--val-every", "3", "--val-ann", str(coco_dir / "ann.json"),
        "--val-max-images", "2"], capsys)
    assert last == 3
    ckpt = os.path.join(ckpt_dir, "yolov3_3.npz")
    assert os.path.exists(ckpt), out[-2000:]
    rows = [json.loads(x) for x in
            open(os.path.join(ckpt_dir, "yolov3_metrics.jsonl")).read().splitlines()]
    assert rows[0]["iter"] == 2 and np.isfinite(rows[0]["total"])
    assert rows[-1]["iter"] == 3 and "val_AP50" in rows[-1]
    ck = jckpt.load_checkpoint(ckpt)   # the JAX reader
    assert ck["step"] == 3 and ck["opt"] is not None
    jckpt.check_params_compatible(
        jget_model("yolov3", num_classes=2).init(jax.random.PRNGKey(0)),
        ck["params"])
    tb = _tb_rows(tb_dir)
    assert any(t == "loss/total" and s == 2 and np.isfinite(v)
               for s, t, v in tb), tb
    assert any(t == "val/AP50" and s == 3 for s, t, v in tb)

    last, out = run_port(p_train.main, base + [
        "--iterations", "5", "--ckpt-every", "2", "--resume", ckpt], capsys)
    assert "resumed from" in out and "at iteration 3" in out and last == 5
    assert os.path.exists(os.path.join(ckpt_dir, "yolov3_4.npz"))
    assert os.path.exists(os.path.join(ckpt_dir, "yolov3_5.npz"))


def test_cli_device_defaults_to_cuda(coco_dir):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device works")
    common = ["--ann", str(coco_dir / "ann.json"), "--img-dir", str(coco_dir)]
    assert p_evaluate.build_parser().parse_args(common).device == "cuda"
    assert p_train.build_parser().parse_args(common).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_evaluate.main(common + ["--input-size", "64"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_train.main(common + ["--sizes", "64", "--iterations", "1"])


def test_streaming_pipeline_refuses_s2d2(coco_dir):
    with pytest.raises(ValueError, match="pack_s2d2"):
        StreamingPipeline([str(coco_dir / "img0.jpg")], input_size=64,
                          pack_s2d2=True, device="cpu", native=False)
