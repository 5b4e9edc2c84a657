"""The four cells' numbers of `correct`, pinned bit for bit.

A dry run of each cell on the CPU at the tiny size (conftest.shrink) and
PIN_SEED reads what `pins.json` holds: `judge.detect_numbers` of the
detect cells, with a digest of what it was handed (the program's rows,
the reference's detections and dense outputs); `judge.train_numbers`'
inputs (the program's and the reference's losses and leaf norms) and
outputs of the train cells; and `yardstick.flops_per_image` of yolov3
and fcos at 416 and 608, detect and train. A change to the harness that
is not meant to move what the benchmark reads leaves every value as it
is. The file was recorded on the CPU (its "torch" key names the build);
where a change is meant to move these numbers, re-record it with

    python portbench/tests/test_portbench_pins.py --record
"""

import hashlib
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parents[1]))

from conftest import ROOT, shrink  # noqa: E402
from portbench import cells, harness, judge, yardstick  # noqa: E402

PINS = HERE / "pins.json"
PIN_SEED = 2**31 + 777
CELLS = ("yolov3_detect_b32", "fcos_detect_b32", "fcos_train_b16",
         "yolov3_train_b64")
FLOPS = [(family, size, train) for family in ("yolov3", "fcos")
         for size in (416, 608) for train in (False, True)]


def digest(x, h=None) -> str:
    """sha256 over nested lists, tuples and dicts of arrays and scalars:
    each array's dtype, shape and bytes, each scalar's repr."""
    h = hashlib.sha256() if h is None else h
    if isinstance(x, dict):
        for k in sorted(x):
            h.update(repr(k).encode())
            digest(x[k], h)
    elif isinstance(x, (list, tuple)):
        h.update(f"[{len(x)}".encode())
        for v in x:
            digest(v, h)
    elif isinstance(x, np.ndarray):
        h.update(f"{x.dtype}{x.shape}".encode())
        h.update(np.ascontiguousarray(x).tobytes())
    else:
        h.update(repr(x).encode())
    return h.hexdigest()


def cell_readings(root: Path, cell: str) -> dict:
    """What the judge was handed and gave in one dry run of `cell`."""
    got = {}
    detect, train = judge.detect_numbers, judge.train_numbers

    def detect_numbers(*args, **kw):
        got["inputs_sha256"] = digest(list(args))
        got["numbers"] = detect(*args, **kw)
        return got["numbers"]

    def train_numbers(program, reference, *args):
        got.update(program=program, reference=reference)
        got["numbers"] = train(program, reference, *args)
        return got["numbers"]

    with mock.patch.object(judge, "detect_numbers", detect_numbers), \
            mock.patch.object(judge, "train_numbers", train_numbers):
        harness.run(cell, PIN_SEED, 0.3, False, torch.device("cpu"),
                    time.perf_counter(), root=root)
    return got


def flops_readings() -> dict:
    return {f"{family}/{size}/{'train' if train else 'detect'}":
            yardstick.flops_per_image(cells.family(family), 80, size,
                                      train=train)
            for family, size, train in FLOPS}


def test_each_cell_reads_its_pinned_numbers(tiny_root):
    pins = json.loads(PINS.read_text())
    for cell in CELLS:
        assert cell_readings(tiny_root, cell) == pins["cells"][cell], cell


def test_flops_an_image_are_pinned():
    assert flops_readings() == json.loads(PINS.read_text())["flops"]


def record() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "portbench"
        shutil.copytree(ROOT / "portbench", root,
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        shrink(root)
        torch.set_num_threads(2)    # as the tests' fixture runs them
        pins = {"torch": torch.__version__, "seed": PIN_SEED,
                "cells": {c: cell_readings(root, c) for c in CELLS},
                "flops": flops_readings()}
    PINS.write_text(json.dumps(pins, indent=1) + "\n")


if __name__ == "__main__" and sys.argv[1:] == ["--record"]:
    record()
