"""The port's evaluation layer against the JAX package's, on the CPU:
`COCOEvaluator` stats equal on every `tests/test_cocoeval.py` case and
a seeded random case (crowds, 3 categories, 100 detections an image);
`evaluate_rotated` within 1e-6 on `tests/test_rotated_eval.py`'s cases
and a seeded case (the port's IoU is op-by-op float32 torch, the JAX
one a jitted XLA:CPU graph that contracts into FMAs); the anchor
k-means, anchor table and CLI; TensorBoard records byte for byte; and
`evaluate_detector` with a port `Detector(device="cpu")` against the
JAX one on the same `.npz`.

The JAX evaluator builds its own `StreamingPipeline`; its native
library is patched off inside the test, so these tests never build or
load it.
"""

import json
import time

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mydetection_tpu.native  # noqa: E402
from mydetection_tpu import anchors as janchors  # noqa: E402
from mydetection_tpu.checkpoint import (  # noqa: E402
    flatten_tree,
    save_checkpoint,
    unflatten_tree,
)
from mydetection_tpu.eval import cocoeval as jcoco  # noqa: E402
from mydetection_tpu.eval import rotated_eval as jrot  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu.utils import tb_writer as jtb  # noqa: E402
from test_cocoeval import det, make_gt  # noqa: E402
from test_rotated_eval import gt_of  # noqa: E402

from mydetection_tpu_torch import anchors as panchors  # noqa: E402
from mydetection_tpu_torch import native as pnative  # noqa: E402
from mydetection_tpu_torch.eval import cocoeval as pcoco  # noqa: E402
from mydetection_tpu_torch.eval import rotated_eval as prot  # noqa: E402
from mydetection_tpu_torch.utils import tb_writer as ptb  # noqa: E402


def _crowd_case():
    gt = make_gt([{"image_id": 0, "category_id": 1, "bbox": [0, 0, 200, 200]}])
    gt["annotations"][0]["iscrowd"] = 1
    gt["annotations"].append(dict(id=99, image_id=0, category_id=1,
                                  bbox=[300, 300, 50, 50], area=2500,
                                  iscrowd=0))
    return gt, [det(0, 1, [50, 50, 20, 20], 0.95),
                det(0, 1, [300, 300, 50, 50], 0.9)]


def _two(cats=(1,)):
    return make_gt([
        {"image_id": 0, "category_id": 1, "bbox": [10, 10, 100, 100]},
        {"image_id": 0, "category_id": cats[-1], "bbox": [300, 50, 80, 120]},
    ], cats=cats)


def seeded_coco_case(seed=0, n_imgs=6, cats=(1, 4, 9)):
    """Random GT (some crowds, every size range) and 100 detections an
    image, jittered copies of GT and random boxes, in 3 categories."""
    rng = np.random.RandomState(seed)
    anns, res = [], []
    for img in range(n_imgs):
        for _ in range(rng.randint(3, 12)):
            w, h = rng.uniform(8, 200, 2)
            x, y = rng.uniform(0, 600 - w), rng.uniform(0, 440 - h)
            anns.append({"image_id": img, "category_id": int(rng.choice(cats)),
                         "bbox": [x, y, w, h],
                         "iscrowd": int(rng.rand() < 0.1)})
        for _ in range(100):
            if rng.rand() < 0.5 and anns:
                a = anns[rng.randint(len(anns))]
                bb = (np.asarray(a["bbox"]) * rng.uniform(0.85, 1.15, 4)).tolist()
                cat = a["category_id"] if rng.rand() < 0.8 else int(rng.choice(cats))
                img_id = a["image_id"]
            else:
                w, h = rng.uniform(8, 200, 2)
                bb = [rng.uniform(0, 600 - w), rng.uniform(0, 440 - h), w, h]
                cat, img_id = int(rng.choice(cats)), img
            res.append(det(img_id, cat, [float(v) for v in bb],
                           float(rng.choice([rng.rand(), 0.5]))))
    gt = make_gt([{k: v for k, v in a.items() if k != "iscrowd"} for a in anns],
                 n_imgs=n_imgs, cats=cats)
    for g, a in zip(gt["annotations"], anns):
        g["iscrowd"] = a["iscrowd"]
    return gt, res


COCO_CASES = {
    "perfect": lambda: (_two(), [det(0, 1, [10, 10, 100, 100], 0.9),
                                 det(0, 1, [300, 50, 80, 120], 0.8)]),
    "missed_gt": lambda: (_two(), [det(0, 1, [10, 10, 100, 100], 0.9)]),
    "fp_before_tp": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 100, 100]}]),
        [det(0, 1, [400, 400, 50, 50], 0.9), det(0, 1, [10, 10, 100, 100], 0.8)]),
    "iou_cuts": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [0, 0, 100, 100]}]),
        [det(0, 1, [0, 0, 100, 60], 0.9)]),
    "crowd": _crowd_case,
    "area_ranges": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 20, 20]},
                 {"image_id": 0, "category_id": 1, "bbox": [300, 50, 120, 120]}]),
        [det(0, 1, [10, 10, 20, 20], 0.9), det(0, 1, [300, 50, 120, 120], 0.8)]),
    "maxdets_1": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50]},
                 {"image_id": 0, "category_id": 1, "bbox": [300, 300, 50, 50]}]),
        [det(0, 1, [10, 10, 50, 50], 0.9), det(0, 1, [300, 300, 50, 50], 0.8)]),
    "multi_category": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 50, 50]},
                 {"image_id": 0, "category_id": 2, "bbox": [300, 300, 50, 50]}],
                cats=(1, 2)),
        [det(0, 1, [10, 10, 50, 50], 0.9)]),
    "duplicates": lambda: (
        make_gt([{"image_id": 0, "category_id": 1, "bbox": [10, 10, 100, 100]}]),
        [det(0, 1, [10, 10, 100, 100], 0.9), det(0, 1, [11, 11, 100, 100], 0.85)]),
    "seeded_random": seeded_coco_case,
}


@pytest.mark.parametrize("case", sorted(COCO_CASES))
def test_coco_evaluator_equals_jax(case):
    gt, res = COCO_CASES[case]()
    p = pcoco.COCOEvaluator(gt).evaluate(res, verbose=False)
    j = jcoco.COCOEvaluator(gt).evaluate(res, verbose=False)
    assert list(p) == list(j) == list(pcoco.STAT_NAMES)
    assert p == j
    if case == "seeded_random":  # a case that scores neither 0 nor 1
        assert 0.05 < p["AP50"] < 0.95


def test_box_iou_xywh_equals_jax():
    rng = np.random.RandomState(1)
    dets = rng.uniform(0, 100, (7, 4))
    gts = rng.uniform(0, 100, (5, 4))
    crowd = np.array([False, True, False, True, False])
    np.testing.assert_array_equal(pcoco.box_iou_xywh(dets, gts, crowd),
                                  jcoco.box_iou_xywh(dets, gts, crowd))


def seeded_rotated_case(seed=0, n_imgs=4):
    rng = np.random.RandomState(seed)
    anns, res = [], []
    for img in range(n_imgs):
        for _ in range(rng.randint(2, 9)):
            bb = [*rng.uniform(50, 950, 2), *rng.uniform(20, 120, 2),
                  rng.uniform(-90, 90)]
            # at most one crowd region an image: the JAX IoF cannot
            # broadcast (D, 1, 5) against (1, C, 5) for C > 1
            crowd = (rng.rand() < 0.15
                     and not any(a["iscrowd"] for a in anns
                                 if a["image_id"] == img))
            anns.append({"image_id": img, "bbox": [float(v) for v in bb],
                         "iscrowd": int(crowd)})
        for _ in range(40):
            if rng.rand() < 0.6:
                a = anns[rng.randint(len(anns))]
                bb = np.asarray(a["bbox"]) + rng.normal(0, [6, 6, 6, 6, 12])
                img_id = a["image_id"]
            else:
                bb = [*rng.uniform(50, 950, 2), *rng.uniform(20, 120, 2),
                      rng.uniform(-90, 90)]
                img_id = img
            res.append({"image_id": img_id, "bbox": [float(v) for v in bb],
                        "score": float(rng.rand())})
    gt = {"images": [{"id": i} for i in range(n_imgs)],
          "annotations": [dict(id=j, **a) for j, a in enumerate(anns)]}
    return gt, res


ROT_CASES = {
    "perfect": lambda: (
        gt_of([{"image_id": 0, "bbox": [100, 100, 40, 20, 30.0]},
               {"image_id": 0, "bbox": [300, 200, 60, 30, -45.0]}]),
        [{"image_id": 0, "bbox": [100, 100, 40, 20, 30.0], "score": 0.9},
         {"image_id": 0, "bbox": [300, 200, 60, 30, -45.0], "score": 0.8}]),
    "periodicity": lambda: (
        gt_of([{"image_id": 0, "bbox": [50, 50, 30, 10, 170.0]}]),
        [{"image_id": 0, "bbox": [50, 50, 30, 10, -10.0], "score": 0.9}]),
    "wrong_angle": lambda: (
        gt_of([{"image_id": 0, "bbox": [50, 50, 30, 10, 0.0]}]),
        [{"image_id": 0, "bbox": [50, 50, 30, 10, 90.0], "score": 0.9}]),
    "fp_before_tp": lambda: (
        gt_of([{"image_id": 0, "bbox": [50, 50, 30, 10, 10.0]}]),
        [{"image_id": 0, "bbox": [400, 400, 30, 10, 10.0], "score": 0.95},
         {"image_id": 0, "bbox": [50, 50, 30, 10, 10.0], "score": 0.9}]),
    "missed_gt": lambda: (
        gt_of([{"image_id": 0, "bbox": [50, 50, 30, 10, 10.0]},
               {"image_id": 1, "bbox": [70, 70, 30, 10, 20.0]}]),
        [{"image_id": 0, "bbox": [50, 50, 30, 10, 10.0], "score": 0.9}]),
    "crowd": lambda: (
        {"images": [{"id": 0}], "annotations": [
            {"id": 0, "image_id": 0, "iscrowd": 0, "bbox": [100, 100, 40, 20, 30.0]},
            {"id": 1, "image_id": 0, "iscrowd": 1, "bbox": [400, 400, 200, 200, 0.0]}]},
        [{"image_id": 0, "bbox": [100, 100, 40, 20, 30.0], "score": 0.9},
         {"image_id": 0, "bbox": [400, 400, 30, 30, 10.0], "score": 0.95}]),
    "seeded_random": seeded_rotated_case,
}


@pytest.mark.parametrize("case", sorted(ROT_CASES))
def test_evaluate_rotated_equals_jax(case):
    gt, res = ROT_CASES[case]()
    p = prot.evaluate_rotated(res, gt, verbose=False)
    j = jrot.evaluate_rotated(res, gt, verbose=False)
    assert list(p) == list(j) == ["AP50", "AP75", "AP"]
    for k in p:
        assert abs(p[k] - j[k]) <= 1e-6, (k, p, j)
    if case == "seeded_random":
        assert 0.05 < p["AP50"] < 0.95


def test_rotated_iou_and_iof_match_jax():
    """The matrices behind the matching: IoU and IoF within float32
    rounding of the jitted JAX ones, empty shapes alike. The port's IoF
    takes several crowd regions at once; the JAX one only one, so it is
    compared column by column."""
    gt, res = seeded_rotated_case(1, 1)
    d5 = np.asarray([r["bbox"] for r in res], np.float32)
    g5 = np.asarray([a["bbox"] for a in gt["annotations"]], np.float32)
    d5[:, 4] = np.radians(d5[:, 4])
    g5[:, 4] = np.radians(g5[:, 4])
    p, j = prot._rotated_iou_matrix(d5, g5), jrot._rotated_iou_matrix(d5, g5)
    assert p.shape == j.shape == (len(d5), len(g5)) and p.dtype == j.dtype
    np.testing.assert_allclose(p, j, rtol=0, atol=2e-6)
    p = prot._rotated_iof_matrix(d5, g5)
    j = np.concatenate([jrot._rotated_iof_matrix(d5, g5[c:c + 1])
                        for c in range(len(g5))], axis=1)
    assert p.shape == j.shape and p.dtype == j.dtype
    np.testing.assert_allclose(p, j, rtol=0, atol=2e-6)
    for fn in (prot._rotated_iou_matrix, prot._rotated_iof_matrix):
        assert fn(d5[:0], g5).shape == (0, len(g5))
        assert fn(d5, g5[:0]).shape == (len(d5), 0)


def test_anchors_equal_jax(tmp_path, capsys):
    rng = np.random.RandomState(0)
    wh = np.concatenate([rng.lognormal(np.log(s), 0.2, (60, 2))
                         for s in (12, 30, 60, 110, 220)])
    for k in (4, 9):
        np.testing.assert_array_equal(panchors.kmeans_anchors(wh, k),
                                      janchors.kmeans_anchors(wh, k))
    assert panchors.anchor_table(wh) == janchors.anchor_table(wh)
    cents = panchors.kmeans_anchors(wh, 9)
    assert panchors.mean_best_iou(wh, cents) == janchors.mean_best_iou(wh, cents)

    class Ds:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return {"boxes": wh[i * 10:(i + 1) * 10 * (i != 1)]}

    np.testing.assert_array_equal(panchors.collect_wh(Ds()),
                                  janchors.collect_wh(Ds()))
    ann = tmp_path / "ann.json"
    json.dump({"annotations": [{"bbox": [0, 0, float(w), float(h)],
                                "iscrowd": int(i % 17 == 0)}
                               for i, (w, h) in enumerate(wh)]}, open(ann, "w"))
    panchors.main(["--ann", str(ann)])
    p_out = capsys.readouterr().out
    janchors.main(["--ann", str(ann)])
    assert p_out == capsys.readouterr().out and "ANCHORS = (" in p_out


def test_tb_writer_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    paths = []
    for mod, d in ((ptb, "p"), (jtb, "j")):
        with mod.TBWriter(str(tmp_path / d)) as w:
            w.add_scalar("loss/total", 3.25, step=10)
            w.add_scalars({"lr": 0.001, "loss/obj": 1.5, "val/AP": 0.0},
                          step=20)
            w.add_scalar("neg", -2.5, step=-1)
        paths.append(w.path)
    assert paths[0].rsplit("/", 1)[1] == paths[1].rsplit("/", 1)[1]
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1]
    assert ptb.read_scalars(paths[0]) == jtb.read_scalars(paths[1])
    assert ptb.crc32c(b"123456789") == 0xE3069283


# -- evaluate_detector, the port's Detector against the JAX one ---------------

def write_eval_set(root, n=6, seed=0):
    """Small noise JPEGs with boxes in 3 non-contiguous categories."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n):
        w, h = int(rng.randint(60, 120)), int(rng.randint(50, 100))
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            root / f"img{i}.jpg")
        images.append({"id": 10 + i, "file_name": f"img{i}.jpg",
                       "width": w, "height": h})
        for _ in range(3):
            bw, bh = rng.uniform(8, 40, 2)
            annotations.append({
                "id": len(annotations), "image_id": 10 + i,
                "category_id": int(rng.choice([2, 5, 9])),
                "bbox": [float(rng.uniform(0, w - bw)),
                         float(rng.uniform(0, h - bh)), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0})
    gt = {"images": images, "annotations": annotations,
          "categories": [{"id": c} for c in (2, 5, 9)]}
    json.dump(gt, open(root / "ann.json", "w"))
    return gt


def scaled_init(name, scale=0.7, **overrides):
    """The JAX init from PRNGKey(0) with every conv kernel scaled by
    `scale`: at 0.7 the seeded heads are not saturated (yolov3 at 64²:
    67 detections above 0.3 on `write_eval_set`, scores 0.30–0.36; at
    1.0 every score is 1.0 and float32 moves boxes by 0.01 px)."""
    flat = flatten_tree(jget_model(name, **overrides).init(
        jax.random.PRNGKey(0)))
    return unflatten_tree({k: np.asarray(v) * scale if v.ndim == 4
                           else np.asarray(v) for k, v in flat.items()})


def match_rows(p_rows, j_rows, score_rtol=1e-5, box_atol=1e-3):
    """One-to-one match of result rows (axis-aligned or rotated): same
    image and category, score within score_rtol, every box number within
    box_atol; tied neighbours may come out in either order."""
    assert len(p_rows) == len(j_rows) > 0
    jb = np.asarray([r["bbox"] for r in j_rows], np.float64)
    js = np.asarray([r["score"] for r in j_rows])
    jk = np.asarray([(r["image_id"], r.get("category_id", 0)) for r in j_rows])
    used = np.zeros(len(j_rows), bool)
    for r in p_rows:
        d = np.abs(jb - np.asarray(r["bbox"])[None]).max(axis=1)
        cand = (~used & (jk == (r["image_id"], r.get("category_id", 0))).all(1)
                & (d <= box_atol) & (np.abs(js - r["score"]) <= score_rtol * js))
        assert cand.any(), r
        used[int(np.argmin(np.where(cand, d, np.inf)))] = True


def test_evaluate_detector_equals_jax(tmp_path, monkeypatch):
    from mydetection_tpu import Detector as JDetector
    from mydetection_tpu.eval.evaluator import evaluate_detector as j_eval

    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch.eval.evaluator import evaluate_detector

    monkeypatch.setattr(mydetection_tpu.native, "available", lambda: False)
    monkeypatch.setattr(pnative, "available", lambda: False)
    gt = write_eval_set(tmp_path)
    npz = str(tmp_path / "w.npz")
    save_checkpoint(npz, scaled_init("yolov3", num_classes=3))
    kw = dict(conf_thres=0.3, batch_size=4, input_size=64, verbose=False)
    p_det = Detector("yolov3", weights_path=npz, num_classes=3, input_size=64,
                     compute_dtype=torch.float32, device="cpu")
    j_det = JDetector("yolov3", weights_path=npz, num_classes=3, input_size=64,
                      compute_dtype=jnp.float32)
    p = evaluate_detector(p_det, gt, str(tmp_path),
                          results_path=str(tmp_path / "p.json"), **kw)
    j = j_eval(j_det, gt, str(tmp_path),
               results_path=str(tmp_path / "j.json"), **kw)
    p_rows = json.load(open(tmp_path / "p.json"))
    j_rows = json.load(open(tmp_path / "j.json"))
    assert len(p_rows) > 20
    assert {r["category_id"] for r in p_rows} <= {2, 5, 9}
    match_rows(p_rows, j_rows)
    assert list(p) == list(j)
    for k in p:
        assert abs(p[k] - j[k]) <= 1e-6, (k, p, j)
    # a subset (max_images) scores against the subset's GT, as JAX's does
    p4 = evaluate_detector(p_det, gt, str(tmp_path), max_images=4, **kw)
    j4 = j_eval(j_det, gt, str(tmp_path), max_images=4, **kw)
    for k in p4:
        assert abs(p4[k] - j4[k]) <= 1e-6, (k, p4, j4)
    with pytest.raises(ValueError, match="3 classes.*2 categories"):
        evaluate_detector(p_det, {"images": [], "annotations": [],
                                  "categories": [{"id": 1}, {"id": 2}]},
                          str(tmp_path), verbose=False)
