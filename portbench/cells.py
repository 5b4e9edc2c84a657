"""Everything the harness runs is found by name under `portbench/`:

  workloads/<cell>.json   {"config", "traffic", "limits": {number: limit}}
  configs/<config>.json   the model as run: registry name, family, input
                          size, classes, dtype, source, reduced, assumed,
                          and the training recipe
  families/<family>.py    the reference's entry points for the family:
                          build(num_classes), dense(model, images_u8),
                          class_scores(model, images_u8, dense),
                          loss(model, images_u8, gt_boxes, gt_classes,
                          gt_valid) where the family trains,
                          postprocess(dense, cfg), and GEOMETRY, the
                          detect check's box layout (judge.AxisAligned
                          lists its parts)
  traffic/<mix>.json      the mix's parameters (`traffic.py` reads them)
  metrics/<metric>.py     one per-layer metric: NAME, UNIT, LAYER, MOVES,
                          KIND ("detect" or "train") and read(ctx)

Adding a configuration, a mix, a cell or a metric is adding files. So is
adding a configuration of a new model family: families/<family>.py, its
plain model under reference/, configs/<config>.json, a mix under
traffic/ and a cell under workloads/ where the existing ones do not
serve, the metrics/ files of its own kernels, and the configuration's
and the cells' entries in BENCHMARK.json. None of them edits a file
that is there.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent


def _json(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        have = sorted(p.stem for p in (root / kind).glob("*.json"))
        raise SystemExit(f"no {kind[:-1]} named {name!r} under {root / kind} "
                         f"(have {have})")
    return json.loads(path.read_text())


def _module(path: Path, prefix: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def family(name: str, root: Path = ROOT) -> ModuleType:
    """The reference's entry points for model family `name`:
    families/<name>.py, loaded from its path."""
    path = root / "families" / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (root / "families").glob("*.py"))
        raise SystemExit(f"no family named {name!r} under "
                         f"{root / 'families'} (have {have})")
    return _module(path, "portbench_family")


def load_cell(name: str, root: Path = ROOT) -> dict:
    """{"name", "cell", "config", "traffic", "family"} for workload
    `name`."""
    cell = _json("workloads", name, root)
    config = _json("configs", cell["config"], root)
    return {"name": name, "cell": cell, "config": config,
            "traffic": _json("traffic", cell["traffic"], root),
            "family": family(config["family"], root)}


def metric_readers(root: Path = ROOT) -> list[ModuleType]:
    """Every per-layer metric module under metrics/, in name order."""
    return [_module(path, "portbench_metric")
            for path in sorted((root / "metrics").glob("*.py"))]
