"""The yardstick's arithmetic against values worked out by hand at small
shapes, and the reduction of a trace."""

import types

import numpy as np
import pytest
import torch

from portbench import cells, judge, yardstick


def test_least_time_takes_the_slower_of_bytes_and_operations():
    assert yardstick.least_ms(3.35e9, 0, 1e12) == pytest.approx(1.0)
    assert yardstick.least_ms(0, 67e9, yardstick.FP32_FLOPS) == \
        pytest.approx(1.0)


def test_gn_bound_by_hand():
    # one (1, 32, 2, 2) map: 128 elements; bytes 2·128·2 + 3·32·4 = 896,
    # operations 9·128 = 1152 over 67 TFLOP/s
    by_bytes = 896 / 3.35e12 * 1e3
    by_ops = 1152 / 67e12 * 1e3
    assert yardstick.gn_bound_ms([(1, 32, 2, 2)]) == \
        pytest.approx(max(by_bytes, by_ops))
    # training: forward + 2·1·32·4 saved statistics, backward 4·128·2 +
    # 5·32·4 + 256 bytes and 16·128 operations
    fwd = max((896 + 256) / 3.35e12, 1152 / 67e12) * 1e3
    bwd = max((1024 + 640 + 256) / 3.35e12, 2048 / 67e12) * 1e3
    assert yardstick.gn_bound_ms([(1, 32, 2, 2)], train=True) == \
        pytest.approx(fwd + bwd)


def test_fcos_gn_shapes_are_the_towers_forty_calls():
    shapes = yardstick.fcos_gn_shapes(2, 608)
    assert len(shapes) == 40
    assert sorted({s[2] for s in shapes}) == [5, 10, 19, 38, 76]


def test_bottleneck_bound_by_hand():
    # (1, 4, 2, 2) → c_mid 2 → 8 with a projection: k = 4·2 + 9·4 + 2·8 +
    # 4·8 = 92; operations 2·4·92; bytes (4·(4 + 8) + 92)·2 + (2·2 + 8 +
    # 8)·4
    ops = 2 * 4 * 92
    nbytes = (4 * 12 + 92) * 2 + 20 * 4
    assert yardstick.bottleneck_bound_ms([(1, 4, 2, 2, 2, 8, True)]) == \
        pytest.approx(max(nbytes / 3.35e12, ops / 989.4e12) * 1e3)


def test_greedy_pairs_by_hand():
    # boxes 0 and 1 overlap (IoU 0.81 > 0.45), 2 is apart: greedy keeps
    # 0, drops 1 after one IoU (with 0), keeps 2 after one (with 0)
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 9, 9], [20, 20, 30, 30.]]])
    valid = torch.ones(1, 3, dtype=torch.bool)
    keep = torch.tensor([[True, False, True]])
    from portbench.reference.boxes import pairwise_iou
    assert yardstick.greedy_pairs(pairwise_iou(boxes, boxes), valid, keep,
                                  0.45) == 2
    ms = yardstick.nms_bound_ms(boxes, valid, keep, 0.45)
    assert ms == pytest.approx(max((48 + 6) / 3.35e12,
                                   (2 * 12 + 9) / 67e12) * 1e3)


def test_flops_an_image_match_the_published_counts():
    # YOLOv3-416: 65.86 GFLOPs an image (2 per multiply-add)
    yolov3 = cells.family("yolov3")
    assert yardstick.flops_per_image(yolov3, 80, 416, train=False) / 1e9 \
        == pytest.approx(65.864, abs=1e-3)
    # a train step: forward, then two backward products a conv
    train = yardstick.flops_per_image(yolov3, 80, 64, train=True)
    fwd = yardstick.flops_per_image(yolov3, 80, 64, train=False)
    assert 2.9 < train / fwd < 3.0


def _event(name, start, dur, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: dur,
                                 device_type=lambda: kind,
                                 is_user_annotation=lambda: False)


def test_reduce_trace_busy_idle_and_gaps():
    events = [_event("k1", 10, 20, True), _event("k2", 20, 20, True),
              _event("k1", 60, 10, True), _event("k3", 90, 10, True),
              _event("portbench.forward_dense", 0, 100, True),
              _event("outer", 0, 100, False),
              _event("aten::copy_", 40, 15, False)]
    t = yardstick.reduce_trace(events)
    # busy [10, 40), [60, 70), [90, 100); the annotation is not activity
    assert t["busy_s"] == pytest.approx(50e-9)
    assert t["window_s"] == pytest.approx(90e-9)
    assert t["kernels"]["k1"] == (pytest.approx(30e-9), 2)
    gaps = dict(t["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(20e-9)   # [40, 60)
    assert gaps["outer"] == pytest.approx(20e-9)         # [70, 90)
    assert yardstick.kernel_seconds(t, "k") == (pytest.approx(60e-9), 4)
    assert yardstick.reduce_trace([_event("outer", 0, 9, False)]) is None


def test_train_numbers_leave_out_round_off_leaves():
    ref = {"losses": [2.0, 2.0, 2.0], "grad": {"a": 1.0, "b": 2.0,
                                               "c": 1e-6},
           "update": {"a": 1.0, "b": 2.0, "c": 1e-9}}
    got = {"losses": [2.2, 2.0, 2.0], "grad": {"a": 1.5, "b": 2.0, "c": 1.0},
           "update": {"a": 1.0, "b": 1.0, "c": 5.0}}
    n = judge.train_numbers(got, ref)
    assert n["loss_gap"] == pytest.approx(0.1)
    assert n["grad_gap"] == pytest.approx(0.5 / 1.5)
    assert n["update_gap"] == pytest.approx(0.5)


def test_train_numbers_hold_the_kernel_leaves_apart():
    ref = {"losses": [1.0] * 3, "grad": {"tower.gn.scale": 1.0,
                                         "tower.gn.bias": 4.0, "stem": 2.0},
           "update": {"tower.gn.scale": 1.0, "tower.gn.bias": 4.0,
                      "stem": 2.0}}
    got = {"losses": [1.0] * 3, "grad": {"tower.gn.scale": 2.0,
                                         "tower.gn.bias": 4.0, "stem": 2.0},
           "update": dict(ref["update"])}
    n = judge.train_numbers(got, ref, ["tower.gn.*"])
    # the group's median is 2.5: the scale's gap of 1 over max(1, 2.5)
    assert n["grad_gap_kernels"] == pytest.approx(0.4)
    assert n["update_gap_kernels"] == 0.0
    assert "grad_gap_kernels" not in judge.train_numbers(got, ref)


def _image(rows, classes, scores, dense_boxes, dense_scores):
    program = (np.array(rows, np.float32), np.array(scores, np.float32),
               np.array(classes))
    dense = {"boxes": np.array(dense_boxes, np.float32),
             "scores": np.array(dense_scores, np.float32),
             "size": (100, 100), "letterbox": (1.0, 0.0, 0.0)}
    return program, dense


def test_detect_numbers_by_hand():
    boxes = [[10, 10, 30, 30], [12, 10, 32, 30], [60, 60, 80, 80]]
    scores = [[0.9, 0.0], [0.8, 0.0], [0.0, 0.7]]
    ref = {"scores": np.array([0.9, 0.7], np.float32)}
    kw = dict(geometry=judge.AxisAligned, nms_iou=0.45, conf_thres=0.05,
              max_dets=2, multi_label=True)
    # NMS kept the first box and its class-1 neighbour: every number clean
    good, dense = _image([boxes[0], boxes[2]], [0, 1], [0.9, 0.7],
                         boxes, scores)
    n = judge.detect_numbers([good], [ref], [dense], **kw)
    assert n["wrong_rows"] == 0 and n["uncovered"] == 0
    assert n["nms_overlap"] == 0
    # no suppression: the two overlapping class-0 boxes both come back
    kept, _ = _image(boxes[:2], [0, 0], [0.9, 0.8], boxes, scores)
    n = judge.detect_numbers([kept], [ref], [dense], **kw)
    assert n["nms_overlap"] == pytest.approx(360 / 440)
    # the class rows gathered for the wrong boxes: rows and candidates off
    swapped, _ = _image([boxes[2], boxes[0]], [0, 1], [0.9, 0.7],
                        boxes, scores)
    n = judge.detect_numbers([swapped], [ref], [dense], **kw)
    assert n["wrong_rows"] == 1.0 and n["uncovered"] == 1.0
