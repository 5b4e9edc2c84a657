"""Fixtures of the harness's CPU tests: a copy of `portbench/` cut to a
size the CPU runs in seconds (64² canvases, batches of 2), which a test
may add files to or break without touching the tree."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_SIZE, TINY_BATCH = 64, 2


def shrink(root: Path) -> None:
    """Cut every configuration to TINY_SIZE in float32 and every mix to
    TINY_BATCH, with limits for float32 against the float32 reference."""
    for p in (root / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["input_size"] = TINY_SIZE
        c["dtype"] = "float32"
        p.write_text(json.dumps(c))
    for p in (root / "traffic").glob("*.json"):
        c = json.loads(p.read_text())
        c["batch"] = TINY_BATCH
        p.write_text(json.dumps(c))
    for p in (root / "workloads").glob("*.json"):
        c = json.loads(p.read_text())
        c["limits"] = {k: TINY_LIMITS[k] for k in c["limits"]}
        p.write_text(json.dumps(c))


# the program in float32 reads these numbers at rounding (loss_gap up to
# 0.002 over three steps of batch-statistics BN on 2 images of 64²);
# every fault the tests plant reads far above them
TINY_LIMITS = {"score_gap": 1e-3, "wrong_rows": 0.0, "nms_overlap": 0.45,
               "uncovered": 0.0, "loss_gap": 0.01, "grad_gap_median": 1e-3,
               "update_gap_median": 0.05, "grad_gap_kernels": 1e-3,
               "update_gap_kernels": 0.05}


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    root = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shrink(root)
    return root


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
