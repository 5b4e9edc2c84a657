"""The port's spans on the CPU (`utils/profiling.py`):

  * `span` while nothing records is one shared no-op, costs well under
    a microsecond and leaves nothing in a later recording;
  * `recording()` keeps nesting, parents, batch and step ids and attrs,
    per thread;
  * span stamps share the profiler's host clock: a span and a
    `record_function` opened together agree within 100 µs;
  * `trace(logdir)` writes the spans on the "program" track of its
    `trace.json`;
  * a CPU `Detector` records exactly the `detect.batch` tree a call,
    and its data-parallel branch the same names with `replica=i`;
  * a CPU `TrainStep` step records the `train.*` tree, `train.model` and
    `train.loss` inside `train.forward`, and the data-parallel step the
    same names.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import train_batch  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import registry  # noqa: E402
from mydetection_tpu_torch import training  # noqa: E402
from mydetection_tpu_torch.api import load_image_any  # noqa: E402
from mydetection_tpu_torch.models.layers import init_weights  # noqa: E402
from mydetection_tpu_torch.parallel import mesh  # noqa: E402
from mydetection_tpu_torch.utils import profiling  # noqa: E402
from mydetection_tpu_torch.utils.image_ops import letterbox_pil  # noqa: E402
from mydetection_tpu_torch.utils.profiling import recording, span  # noqa: E402

SIZE, BATCH = 64, 2
CPU = torch.device("cpu")
DETECT_CHILDREN = ["detect.inputs", "detect.forward", "detect.post",
                   "detect.copy_back", "detect.strip"]
TRAIN_PHASES = ["train.batch", "train.forward", "train.backward",
                "train.update"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree(rec, step):
    """{name: parent name} of one step's spans, and their names in the
    order they opened."""
    spans = sorted((s for s in rec.spans if s.step == step),
                   key=lambda s: s.start)
    return ({s.name: s.parent.name if s.parent else None for s in spans},
            [s.name for s in spans])


# -- the recorder -------------------------------------------------------------


def test_span_off_is_the_shared_noop_and_records_nothing():
    off = span("detect.batch", new_step=True, size=3)
    assert off is span("train.loss") is profiling._OFF
    with off as got:
        assert got is None
    with recording() as rec:
        pass
    with span("after"):
        pass
    assert rec.spans == [] and rec.steps == 0
    best = min(_ns_a_call() for _ in range(5))
    assert best < 1000, f"{best:.0f} ns a call while off"


def _ns_a_call(n: int = 20000) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("detect.forward"):
            pass
    return (time.perf_counter_ns() - t0) / n


def test_nesting_parents_steps_and_attrs():
    with recording() as rec:
        with span("loose"):
            pass
        for b in range(2):
            with span("detect.batch", new_step=True, size=b) as root:
                with span("detect.forward") as fwd:
                    with span("inner"):
                        pass
                with span("detect.strip"):
                    pass
            assert root.start <= fwd.start <= fwd.end <= root.end
        with span("after"):
            pass
    assert rec.steps == 2
    by = {(s.name, s.step): s for s in rec.spans}
    assert by["loose", 0].parent is None
    for b in (1, 2):
        assert by["detect.batch", b].parent is None
        assert by["detect.batch", b].attrs == {"size": b - 1}
        assert by["detect.forward", b].parent is by["detect.batch", b]
        assert by["inner", b].parent is by["detect.forward", b]
        assert by["detect.strip", b].parent is by["detect.batch", b]
    # a root that opens no step takes the latest id
    assert by["after", 2].parent is None
    # spans are kept in the order they closed
    assert [s.name for s in rec.spans[:4]] == ["loose", "inner",
                                                "detect.forward",
                                                "detect.strip"]


def test_threads_keep_their_own_parents():
    seen = {}

    def worker():
        with span("train.forward", replica=1) as s:
            with span("train.model") as m:
                seen["worker"] = (s, m)

    with recording() as rec:
        with span("train.batch", new_step=True):
            pass
        with span("train.forward") as main:
            t = threading.Thread(target=worker)
            t.start()
            t.join(10)
            assert not t.is_alive()
    w, m = seen["worker"]
    assert w.parent is None and m.parent is w      # not the main thread's
    assert w.step == m.step == main.step == 1
    assert w.thread != main.thread and w.attrs == {"replica": 1}
    assert len(rec.spans) == 4


def test_span_stamps_share_the_profilers_host_clock():
    """A span and a `record_function` opened and closed together (the
    span outside): the profiler's host event lies inside the span and
    agrees with it within 100 µs at each end, so kineto's start_ns() is
    the Unix-epoch clock spans are stamped on."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64, 64)
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):    # the first call's set-up
                pass
            for _ in range(3):
                with span("together"), record_function("together"):
                    (x @ x).sum()
    host = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == "together")
    mine = sorted((s.start, s.end) for s in rec.spans)
    assert len(host) == len(mine) == 3
    for (hs, he), (s, e) in zip(host, mine):
        assert s - 1000 <= hs < s + 100_000 and e - 100_000 < he <= e + 1000
        assert abs(s - time.time_ns()) < 60e9     # an epoch stamp


def test_trace_writes_the_program_spans(tmp_path):
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path)):
        with span("detect.batch", new_step=True, size=1):
            with span("detect.forward"), profiling.annotate("port_stage"):
                (x @ x).sum()
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    events = doc["traceEvents"]
    program = {e["name"]: e for e in events
               if e.get("pid") == profiling.PROGRAM_TRACK and e["ph"] == "X"}
    assert set(program) == {"detect.batch", "detect.forward"}
    assert program["detect.forward"]["args"] == {
        "step": 1, "parent": "detect.batch"}
    assert program["detect.batch"]["args"] == {"step": 1, "size": 1}
    # on the same timeline as the profiler's own range
    stage = next(e for e in events if e.get("name") == "port_stage")
    fwd = program["detect.forward"]
    assert abs(stage["ts"] - fwd["ts"]) < 100
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.PROGRAM_TRACK
               for e in events)
    with span("outside"):      # nothing records once the block is over
        assert profiling._recorder is None


# -- the detect path ------------------------------------------------------------


@pytest.fixture(scope="module")
def det():
    return Detector("yolov3", input_size=SIZE, num_classes=2, pre_nms=32,
                    compute_dtype=torch.float32, device="cpu")


def _canvases(n: int = BATCH):
    rng = np.random.RandomState(3)
    imgs = [rng.randint(0, 255, (48, 80, 3)).astype(np.uint8)
            for _ in range(n)]
    pairs = [letterbox_pil(load_image_any(im), SIZE) for im in imgs]
    return imgs, np.stack([c for c, _ in pairs]), [i for _, i in pairs]


def test_detect_prepared_records_the_batch_tree(det):
    _, canvases, infos = _canvases()
    with recording() as rec:
        det.detect_prepared(canvases, infos, conf_thres=0.3)
        det.detect_prepared(canvases, infos[:1], conf_thres=0.3)
    assert rec.steps == 2 and len(rec.spans) == 12
    for step, n in ((1, BATCH), (2, 1)):
        parents, order = tree(rec, step)
        assert order == ["detect.batch", *DETECT_CHILDREN]
        assert parents == {"detect.batch": None,
                           **{c: "detect.batch" for c in DETECT_CHILDREN}}
        root = next(s for s in rec.spans
                    if s.step == step and s.name == "detect.batch")
        assert root.attrs == {"size": n}
        kids = [s for s in rec.spans if s.parent is root]
        assert sum(s.end - s.start for s in kids) <= root.end - root.start


def test_detect_batch_records_the_letterbox(det):
    imgs, _, _ = _canvases()
    with recording() as rec:
        det.detect_batch(imgs, conf_thres=0.3)
    parents, order = tree(rec, 1)
    assert order == ["detect.batch", "detect.letterbox", *DETECT_CHILDREN]
    assert set(parents.values()) == {None, "detect.batch"}


def test_data_parallel_detect_names_each_replica(monkeypatch):
    monkeypatch.setattr(mesh, "local_devices", lambda: [CPU, CPU])
    dp = Detector("yolov3", input_size=SIZE, num_classes=2, pre_nms=32,
                  compute_dtype=torch.float32, device="cpu",
                  data_parallel=True)
    assert dp._replicas is not None
    _, canvases, infos = _canvases(4)
    with recording() as rec:
        dp.detect_prepared(canvases, infos, conf_thres=0.3)
    names = sorted((s.name, s.attrs.get("replica")) for s in rec.spans)
    assert names == sorted(
        [("detect.batch", None), ("detect.inputs", None),
         ("detect.strip", None)]
        + [(n, r) for n in ("detect.forward", "detect.post",
                            "detect.copy_back") for r in (0, 1)])
    assert all(s.parent is not None for s in rec.spans
               if s.name != "detect.batch")


# -- the train step ---------------------------------------------------------------


def _model():
    model = registry.get_model("yolov3", num_classes=2, input_size=SIZE,
                               compute_dtype=torch.float32)
    init_weights(model, 0)
    return model


def test_train_step_records_the_train_tree():
    step = training.make_train_step(_model(), input_size=SIZE, device="cpu")
    batch = train_batch(0, BATCH, SIZE, 2)
    with recording() as rec:
        step(*batch, 1e-4)
        x = step.batch(*batch)
        step.update(step.backward(step.forward(*x)), 1e-4)
    assert rec.steps == 2
    for s in (1, 2):
        parents, order = tree(rec, s)
        assert order == ["train.batch", "train.forward", "train.model",
                         "train.loss", "train.backward", "train.update"]
        assert parents == {"train.batch": None, "train.forward": None,
                           "train.model": "train.forward",
                           "train.loss": "train.forward",
                           "train.backward": None, "train.update": None}


def test_data_parallel_train_step_records_the_same_names():
    step = training.make_train_step(_model(), input_size=SIZE,
                                    mesh=[CPU, CPU])
    assert isinstance(step, training.DataParallelTrainStep)
    with recording() as rec:
        step(*train_batch(0, 4, SIZE, 2), 1e-4)
    got = sorted((s.name, str(s.attrs.get("replica")),
                  s.parent.name if s.parent else "") for s in rec.spans)
    assert got == sorted(
        [(p, "None", "") for p in TRAIN_PHASES]
        + [("train.forward", str(r), "") for r in (0, 1)]
        + [(n, "None", "train.forward")
           for n in ("train.model", "train.loss") for _ in (0, 1)])
    assert {s.step for s in rec.spans} == {1}
