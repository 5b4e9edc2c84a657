"""Everything the harness runs is found by name under `portbench/`:

  workloads/<cell>.json   {"config", "traffic", "limits": {number: limit}}
  configs/<config>.json   the model as run: registry name, family, input
                          size, classes, dtype, source, reduced, assumed,
                          and the training recipe
  traffic/<mix>.json      the mix's parameters (`traffic.py` reads them)
  metrics/<metric>.py     one per-layer metric: NAME, UNIT, LAYER, MOVES,
                          KIND ("detect" or "train") and read(ctx)

Adding a configuration, a mix, a cell or a metric is adding files.
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


def load_cell(name: str, root: Path = ROOT) -> dict:
    """{"name", "cell", "config", "traffic"} for workload `name`."""
    cell = _json("workloads", name, root)
    return {"name": name, "cell": cell,
            "config": _json("configs", cell["config"], root),
            "traffic": _json("traffic", cell["traffic"], root)}


def metric_readers(root: Path = ROOT) -> list[ModuleType]:
    """Every per-layer metric module under metrics/, in name order."""
    readers = []
    for path in sorted((root / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{path.stem.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers.append(module)
    return readers
