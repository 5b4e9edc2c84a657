"""A model family added as files: its entry points found by name under
families/, and the detect check's box geometry taken from it.

`darknet_rot` is a family written here into a copy of the benchmark: the
yolov3 reference, whose boxes it carries as (cx, cy, w, h, θ = 0) rows,
as a rotated family's would be. Its geometry takes and gives 5-column
rows only; with θ = 0 it works on the corners, which hold the same
float32 values as yolov3's rows, so its numbers equal yolov3's bit for
bit."""

import json
from unittest import mock

import numpy as np
import pytest
import torch

from portbench import calibrate, cells, harness, judge

from test_portbench_harness import SEED, run

DARKNET_ROT = '''"""The yolov3 reference with its boxes as (cx, cy, w, h, theta) rows."""
from pathlib import Path

import numpy as np

from portbench import cells, judge
from portbench.reference import postprocess as ref_post

_base = cells.family("yolov3", Path(__file__).resolve().parents[1])
build, dense, class_scores, loss = (_base.build, _base.dense,
                                    _base.class_scores, _base.loss)
postprocess = _base.postprocess


def _rows(xyxy):
    b = np.asarray(xyxy, np.float64)
    return np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                     b[:, 2] - b[:, 0], b[:, 3] - b[:, 1],
                     np.zeros(len(b))], axis=1)


def _corners(rows):
    if rows.shape[1] != 5 or rows[:, 4].any():
        raise ValueError("rows of (cx, cy, w, h, 0) only")
    half = rows[:, 2:4] / 2
    return np.concatenate([rows[:, :2] - half, rows[:, :2] + half],
                          axis=1).astype(np.float32)


class Rotated:
    @staticmethod
    def rows(detections):
        return _rows(detections.boxes_xyxy)

    @staticmethod
    def to_original(boxes, info):
        return _rows(ref_post.to_original(boxes, info))

    @staticmethod
    def iou(a, b):
        u = judge.AxisAligned.iou(_corners(a), _corners(b))
        return IOU

    @staticmethod
    def grow(rows):
        return rows + np.array([0.0, 0.0, 1.0, 1.0, 0.0])

    @staticmethod
    def inside(rows, size):
        w, h = size
        half = rows[:, 2:4] / 2
        lo, hi = rows[:, :2] - half, rows[:, :2] + half
        return ((lo > judge.EDGE).all(axis=1) & (hi[:, 0] < w - judge.EDGE)
                & (hi[:, 1] < h - judge.EDGE))

    @staticmethod
    def on_canvas(rows, classes, letterbox):
        return _rows(judge.AxisAligned.on_canvas(_corners(rows), classes,
                                                  letterbox))


GEOMETRY = Rotated
'''
RIGHT_IOU = "u"
# every intersection counted at half its area: I/2 / (A + B − I/2), which
# is u / (2 + u) for u = I / (A + B − I)
HALVED_IOU = "u / (2 + u)"


def add_family(root, iou: str = RIGHT_IOU) -> str:
    """darknet_rot's family, configuration, mix and cell, written into
    `root` beside yolov3's; the cell's name."""
    (root / "families" / "darknet_rot.py").write_text(
        DARKNET_ROT.replace("return IOU", f"return {iou}"))
    config = json.loads((root / "configs" / "yolov3.json").read_text())
    config["family"] = "darknet_rot"
    (root / "configs" / "darknet_rot.json").write_text(json.dumps(config))
    (root / "traffic" / "detect_rot_b32.json").write_bytes(
        (root / "traffic" / "detect_coco_b32.json").read_bytes())
    cell = json.loads((root / "workloads" / "yolov3_detect_b32.json")
                      .read_text())
    cell.update(config="darknet_rot", traffic="detect_rot_b32")
    (root / "workloads" / "darknet_rot_detect_b32.json").write_text(
        json.dumps(cell))
    return "darknet_rot_detect_b32"


def judged(root, cell: str) -> tuple[dict, dict]:
    """(the result line, what `judge.detect_numbers` was handed and gave)
    of one dry run of `cell`."""
    got = {}
    real = judge.detect_numbers

    def detect_numbers(program, reference, dense, **kw):
        got.update(program=program, dense=dense)
        got["numbers"] = real(program, reference, dense, **kw)
        return got["numbers"]

    with mock.patch.object(judge, "detect_numbers", detect_numbers):
        line, _, _ = run(root, cell)
    return line, got


def test_a_family_added_as_files_runs(tiny_root):
    before = {p: p.read_bytes() for p in tiny_root.rglob("*") if p.is_file()}
    cell = add_family(tiny_root)
    line, got = judged(tiny_root, cell)
    assert line["correct"] is True, line["checks"]
    assert all(rows.shape[1] == 5 for rows, _, _ in got["program"])
    assert all(d["boxes"].shape[1] == 5 for d in got["dense"])
    _, want = judged(tiny_root, "yolov3_detect_b32")
    assert got["numbers"] == want["numbers"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_the_judge_takes_the_family_s_geometry(tiny_root):
    line, _ = judged(tiny_root, add_family(tiny_root, HALVED_IOU))
    assert line["correct"] is False, line["checks"]


def test_the_added_family_s_control_is_not_correct(tiny_root):
    loaded = cells.load_cell(add_family(tiny_root), tiny_root)
    got = calibrate.detect_readings(loaded, SEED, torch.device("cpu"))
    assert not judge.verdict(got["fp8"], loaded["cell"]["limits"])[0], \
        got["fp8"]


def test_unknown_family_names_what_there_is(tiny_root):
    with pytest.raises(SystemExit, match=r"'fcos', 'yolov3'"):
        cells.family("no_such_family")
    config = json.loads((tiny_root / "configs" / "fcos.json").read_text())
    config["family"] = "no_such_family"
    (tiny_root / "configs" / "fcos.json").write_text(json.dumps(config))
    with pytest.raises(SystemExit, match="no family named 'no_such_family'"):
        cells.load_cell("fcos_detect_b32", tiny_root)


def test_the_families_give_every_entry_point():
    for name in ("yolov3", "fcos"):
        family = cells.family(name)
        for part in ("build", "dense", "class_scores", "loss", "postprocess"):
            assert callable(getattr(family, part)), (name, part)
        assert family.GEOMETRY is judge.AxisAligned
        boxes = np.array([[0, 0, 10, 10], [5, 0, 15, 10]], np.float32)
        assert family.GEOMETRY.iou(boxes, boxes)[0, 1] == \
            pytest.approx(50 / 150)
