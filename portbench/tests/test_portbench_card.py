"""The controls of `correct` at each cell's own size, on the card: the
program passes its cell's limits through a short run of the timed path,
the lower-precision control fails them, and so does each planted fault.
Skips without a CUDA device; run on the card with

    python -m pytest --noconftest -q -p no:cacheprovider -m cuda \
        portbench/tests/test_portbench_card.py
"""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import faults  # noqa: E402
from portbench import calibrate, cells, harness, judge  # noqa: E402

BENCH_CELLS = sorted(p.stem for p in (Path(__file__).resolve().parents[1]
                                      / "workloads").glob("*.json"))
SEED = 3_900_000_017


def _kind(cell):
    return cells.load_cell(cell)["traffic"]["kind"]


def _run(cell, **fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    line, _, _ = harness.run(cell, SEED, 2.0, False, torch.device("cuda", 0),
                             time.perf_counter(), **fault)
    return line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_program_passes(cell):
    line = _run(cell)
    print(cell, line["checks"])
    assert line["correct"] is True, line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_control_fails(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs at its own size")
    loaded = cells.load_cell(cell)
    kind = loaded["traffic"]["kind"]
    readings = (calibrate.detect_readings if kind == "detect"
                else calibrate.train_readings)
    got = readings(loaded, SEED, torch.device("cuda", 0))
    print(cell, {k: v for k, v in got.items() if k != "worst_leaves"})
    limits = loaded["cell"]["limits"]
    assert not judge.verdict(got["fp8"], limits)[0], got["fp8"]
    if kind == "train":
        assert not judge.verdict(got["half_batch"], limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [faults.no_suppression,
                                   faults.permuted_gather],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", [c for c in BENCH_CELLS
                                  if _kind(c) == "detect"])
def test_postprocess_fault_fails(cell, fault):
    line = _run(cell, detector=fault)
    print(cell, fault.__name__, line["checks"])
    assert line["correct"] is False, line["checks"]
