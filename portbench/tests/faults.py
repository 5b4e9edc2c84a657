"""Faults planted in the timed path, which `correct` must catch: each
takes the program's object (a `Detector`, or a `TrainStep` with the
run's step function) and returns it broken, leaving the tree as it is."""

import numpy as np
import torch

# -- detect: each takes the Detector and returns it -------------------------


def half_batch(det):
    """The Detector answers only the first half of each batch."""
    real = det.detect_prepared

    def detect_prepared(canvases, infos, **kw):
        out = real(canvases, infos, **kw)
        half = len(out) // 2
        empty = type(out[0])(np.zeros((0, 4), np.float32),
                             np.zeros(0, np.float32), np.zeros(0, np.int32))
        return out[:half] + [empty] * (len(out) - half)

    det.detect_prepared = detect_prepared
    return det


def altered_answer(det):
    """One image's answer altered where it is produced: every box of the
    batch's first image moved by a quarter of its canvas."""
    real = det.detect_prepared

    def detect_prepared(canvases, infos, **kw):
        out = real(canvases, infos, **kw)
        out[0].boxes_xyxy = out[0].boxes_xyxy + np.float32(
            infos[0].ori_w / 4)
        return out

    det.detect_prepared = detect_prepared
    return det


def altered_scores(det):
    """Every score of the batch's first image scaled by 0.7."""
    real = det.detect_prepared

    def detect_prepared(canvases, infos, **kw):
        out = real(canvases, infos, **kw)
        out[0].scores = out[0].scores * np.float32(0.7)
        return out

    det.detect_prepared = detect_prepared
    return det


def no_suppression(det):
    """NMS suppresses nothing: the postprocess runs with an IoU threshold
    that no pair of boxes exceeds."""
    real = det._post

    def post(dense, conf, iou):
        return real(dense, conf, 2.0)

    det._post = post
    return det


def permuted_gather(det):
    """Each image's gathered candidate rows rolled by one: the class rows
    of the top boxes (gather kernel #8) on multi-label families, the
    boxes of the top candidates on single-label ones."""
    from mydetection_tpu_torch.ops import nms

    def rolled(fn):
        def gather(*args, **kw):
            return torch.roll(fn(*args, **kw), 1, dims=1)
        return gather

    real = det.detect_prepared

    def detect_prepared(canvases, infos, **kw):
        saved = nms.gather_rows, nms.gather_rows_plain, nms._rows
        if det.cfg.multi_label:
            nms.gather_rows, nms.gather_rows_plain = map(rolled, saved[:2])
        else:
            nms._rows = rolled(saved[2])
        try:
            return real(canvases, infos, **kw)
        finally:
            nms.gather_rows, nms.gather_rows_plain, nms._rows = saved

    det.detect_prepared = detect_prepared
    return det


DETECT = [half_batch, altered_answer, altered_scores, no_suppression,
          permuted_gather]

# -- train: each takes the TrainStep and the run's step function and
# returns the step function --------------------------------------------------


def unchanged(step, run_step):
    """A step that returns its loss and leaves its state unchanged."""
    def broken(b, lr):
        return run_step(b, 0.0)
    return broken


def half_of_batch(step, run_step):
    """Half of every batch left out, the loss's means over the rest."""
    real_batch = step.batch

    def batch(images, boxes, classes, valid):
        half = images.shape[0] // 2
        return real_batch(images[:half], boxes[:half], classes[:half],
                          valid[:half])

    step.batch = batch
    return run_step


def altered_loss(step, run_step):
    """The loss altered where it is produced: its box term doubled."""
    real = step.forward

    def forward(*args):
        terms = dict(real(*args))
        terms["total"] = terms["total"] + terms["box"]
        return terms

    step.forward = forward
    return run_step


TRAIN = [unchanged, half_of_batch, altered_loss]
