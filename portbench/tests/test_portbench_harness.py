"""The harness on the CPU at a tiny size: cells, configurations, mixes and
metrics found by name, a cell and a metric added as files, a dry run of
each traffic kind to a well-formed result line, the faults that
`correct` must catch, and the import rules."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import cells, harness

import faults
from conftest import ROOT

SEED = 2**31 + 12345     # more than 32 signed bits hold: seeds may be that large
CELLS = sorted(p.stem for p in (ROOT / "portbench" / "workloads").glob("*.json"))
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(root, cell, trace=False, **faults):
    return harness.run(cell, SEED, 0.5, trace, torch.device("cpu"),
                       time.perf_counter(), root=root, **faults)


def test_every_cell_config_and_mix_is_found_by_name():
    names = {w["name"] for w in BENCH["workloads"]}
    assert names == set(CELLS)
    for w in BENCH["workloads"]:
        loaded = cells.load_cell(w["name"])
        assert loaded["cell"]["config"] == w["config"]
        assert loaded["cell"]["traffic"] == w["traffic"]
        assert loaded["traffic"]["kind"] in harness.DRIVERS
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]


def test_every_metric_has_a_reader_with_its_declaration():
    readers = {r.NAME: r for r in cells.metric_readers()}
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(readers) == set(declared)
    kinds = {w["name"]: cells.load_cell(w["name"])["traffic"]["kind"]
             for w in BENCH["workloads"]}
    for name, m in declared.items():
        r = readers[name]
        assert (r.UNIT, r.LAYER, r.MOVES, r.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        assert {kinds[w] for w in m["workloads"]} == {r.KIND}


def test_unknown_cell_names_what_there_is():
    with pytest.raises(SystemExit, match="yolov3_detect_b32"):
        cells.load_cell("no_such_cell")


@pytest.mark.parametrize("cell", ["yolov3_detect_b32", "fcos_train_b16"])
def test_dry_run_line_is_well_formed(tiny_root, cell):
    line, notes, checks = run(tiny_root, cell)
    assert line["correct"] is True, line["checks"]
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert [c.split()[0] for c in checks] == list(line["checks"])
    json.dumps(line)


@pytest.mark.parametrize("cell", ["fcos_detect_b32", "yolov3_train_b64"])
def test_traced_dry_run_reads_the_spans(tiny_root, cell):
    line, _, _ = run(tiny_root, cell, trace=True)
    assert line["correct"] is True, line["checks"]
    spans = {"detect": {"detect_forward_ms", "detect_post_ms",
                        "detect_host_ms"},
             "train": {"train_fwd_ms", "train_bwd_ms"}}[
        cells.load_cell(cell, tiny_root)["traffic"]["kind"]]
    # on the CPU no device metric is read: no trace of a device, no peak
    assert set(line["metrics"]) == spans


def test_a_cell_and_a_metric_added_as_files_run(tiny_root):
    before = {p: p.read_bytes() for p in tiny_root.rglob("*") if p.is_file()}
    (tiny_root / "traffic" / "detect_small.json").write_text(json.dumps(
        {"kind": "detect", "batch": 1, "pool": 2,
         "source_sizes": [[320, 240]], "pad_value": 114}))
    (tiny_root / "workloads" / "fcos_detect_small.json").write_text(
        json.dumps({"config": "fcos", "traffic": "detect_small",
                    "limits": {"score_gap": 1e-3}}))
    (tiny_root / "metrics" / "detect_batches.py").write_text(
        'NAME, UNIT, KIND, SOURCE = "detect_batches", "1", "detect", '
        '"program_span"\nLAYER, MOVES = "dense forward (models/)", '
        '"detect_img_s"\n\n\ndef read(ctx):\n'
        '    return float(len(ctx["forward_ms"]))\n')
    line, _, _ = run(tiny_root, "fcos_detect_small", trace=True)
    assert line["correct"] is True
    assert line["metrics"]["detect_batches"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_same_seed_same_inputs(tiny_root):
    from portbench import traffic
    mix = cells.load_cell("fcos_detect_b32", tiny_root)["traffic"]
    a = traffic.detect_pool(mix, 64, SEED, "cpu")
    b = traffic.detect_pool(mix, 64, SEED, "cpu")
    c = traffic.detect_pool(mix, 64, SEED + 1, "cpu")
    assert torch.equal(a[1]["canvases"], b[1]["canvases"])
    assert not torch.equal(a[1]["canvases"], c[1]["canvases"])
    # every seed draws the same source sizes, in its own order
    sizes = sorted((i.ori_w, i.ori_h) for p in a for i in p["infos"])
    assert sizes == sorted((i.ori_w, i.ori_h) for p in c for i in p["infos"])


# -- the faults `correct` must catch ----------------------------------------

# At 64 pixels nearly every yolov3 box of the top hundred is clipped to
# the canvas's edge or alone in its class, so its NMS suppresses next to
# nothing there and `no_suppression` changes nothing to catch; the card's
# tests plant it at the cell's own size (test_portbench_card.py).
@pytest.mark.parametrize("cell, fault", [
    (cell, fault) for cell in ("yolov3_detect_b32", "fcos_detect_b32")
    for fault in faults.DETECT
    if not (cell == "yolov3_detect_b32" and fault is faults.no_suppression)],
    ids=lambda x: getattr(x, "__name__", x))
def test_detect_fault_is_not_correct(tiny_root, cell, fault):
    line, _, _ = run(tiny_root, cell, detector=fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["fcos_train_b16", "yolov3_train_b64"])
def test_train_fault_is_not_correct(tiny_root, cell, fault):
    line, _, _ = run(tiny_root, cell, stepper=fault)
    assert line["correct"] is False, line["checks"]


# -- what loads ---------------------------------------------------------------

def _modules_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_dry_run_loads_no_jax_package():
    code = ("import json, shutil, sys, tempfile, time, pathlib, torch\n"
            "sys.path.insert(0, 'portbench/tests')\n"
            "import conftest\n"
            "from portbench import harness\n"
            "root = pathlib.Path(tempfile.mkdtemp()) / 'portbench'\n"
            "shutil.copytree('portbench', root, ignore=shutil.ignore_patterns("
            "'__pycache__', 'tests'))\n"
            "conftest.shrink(root)\n"
            "harness.run('yolov3_train_b64', 7, 0.2, True, torch.device('cpu'),"
            " time.perf_counter(), root=root)\n"
            "assert harness.forbidden_modules() == []\n")
    top = _modules_after(code)
    assert "mydetection_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mydetection_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    families = sorted(p.stem for p in
                      (ROOT / "portbench" / "families").glob("*.py"))
    assert {"yolov3", "fcos"} <= set(families)
    code = ("import portbench.reference.postprocess, portbench.weights,"
            " portbench.yardstick, portbench.judge\n"
            "from portbench import cells\n"
            f"for name in {families!r}:\n"
            "    cells.family(name)")
    top = _modules_after(code)
    assert not top & {"jax", "jaxlib", "flax", "mydetection_tpu",
                      "mydetection_tpu_torch"}


def test_run_without_a_card_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "yolov3_detect_b32", "--seed", str(SEED),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.parametrize("cell", ["fcos_detect_b32", "yolov3_train_b64"])
def test_fp8_control_is_not_correct(tiny_root, cell):
    from portbench import calibrate, judge
    loaded = cells.load_cell(cell, tiny_root)
    kind = loaded["traffic"]["kind"]
    readings = (calibrate.detect_readings if kind == "detect"
                else calibrate.train_readings)
    got = readings(loaded, SEED, torch.device("cpu"))
    limits = loaded["cell"]["limits"]
    assert not judge.verdict(got["fp8"], limits)[0], got["fp8"]
    if kind == "train":
        assert judge.verdict(got["program_f32"], limits)[0], got["program_f32"]
        assert not judge.verdict(got["half_batch"], limits)[0]
