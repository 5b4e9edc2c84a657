"""The port's HTTP serving daemon (`mydetection_tpu_torch.serve`) on the CPU.

`tests/test_serve.py`'s cases with the port's own objects: the
`_Batcher` units against a fake backend (coalescing, padding, key
splits, mixed-conf vectors, the queue cap, cancellation, a failing
group, each request's queue wait); a live yolov3 Detector at 64² (float32, buckets 1 and 2) behind
the server: `/healthz`, `/detect` equal to `detect_one` (a coalesced
batch may sum its convs in another order than a batch of 1: 1e-4
relative, 1e-3 px), the `conf_thres` query, concurrent requests
coalesced into fewer batches, the native JPEG path, 4xx, 413 and
`/stats` counting, `coalesce_sizes`; and the artifact backend: the
JAX package's yolov3@416 golden (`tests/golden/yolov3_e2e.npz`)
reproduced by an exported artifact loaded as the server's backend, to
`test_torch_port_e2e.py::test_golden_yolov3_416`'s gates, and a rapid
artifact answering in rotated columns.
"""

import io
import json
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from chip_smoke import golden_image  # noqa: E402
from mydetection_tpu.checkpoint import flatten_tree  # noqa: E402
from mydetection_tpu.registry import get_model as jget_model  # noqa: E402
from mydetection_tpu_torch import Detector  # noqa: E402
from mydetection_tpu_torch import native as pnative  # noqa: E402
from mydetection_tpu_torch import serve as pserve  # noqa: E402
from mydetection_tpu_torch.export import export_detector  # noqa: E402
from mydetection_tpu_torch.serve import (  # noqa: E402
    DetectionServer,
    _Batcher,
    _Pending,
    _Stats,
    _TooBusy,
)
from test_torch_port_export import scaled_weights  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "yolov3_e2e.npz"
SIZE = 64
RNG = np.random.RandomState(11)
IMG = RNG.randint(0, 255, (90, 130, 3)).astype(np.uint8)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: in the Tier-1 run six workers share the
    host's cores, and torch's per-op thread pools spin against each
    other otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work():
    """A directory removed after the module (the artifacts carry full
    weights, 250 MB each)."""
    with tempfile.TemporaryDirectory() as root:
        yield Path(root)


def png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


class Running:
    """A DetectionServer serving on a free port in a thread."""

    def __init__(self, srv: DetectionServer):
        self.srv = srv
        ready = threading.Event()
        self.thread = threading.Thread(target=srv.serve, daemon=True,
                                       kwargs={"port": 0,
                                               "ready_event": ready})
        self.thread.start()
        assert ready.wait(300), "server failed to warm up"
        self.base = f"http://127.0.0.1:{srv.port}"

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def det(work):
    w = scaled_weights(work / "w.npz", "yolov3", input_size=SIZE,
                       num_classes=3)
    return Detector("yolov3", weights_path=w, input_size=SIZE, num_classes=3,
                    pre_nms=64, max_dets=10, compute_dtype=torch.float32,
                    device="cpu")


@pytest.fixture(scope="module")
def server(det):
    running = Running(DetectionServer.from_detector(
        det, batch_buckets=[1, 2], max_wait_ms=30.0))
    yield running.srv
    running.close()


@pytest.fixture(scope="module")
def base(server):
    return f"http://127.0.0.1:{server.port}"


def test_healthz(base, det):
    h = get(base + "/healthz")
    assert h["ok"] is True
    assert h["model"] == "yolov3"
    assert h["input_sizes"] == [SIZE]
    assert h["batch_buckets"] == [1, 2]
    assert h["columns"] == ["x1", "y1", "x2", "y2", "score", "cls"]
    assert h["default_conf_thres"] == pytest.approx(det.cfg.conf_thres)


def test_detect_matches_library(base, det):
    got = post(base + "/detect?conf_thres=0.3", png_bytes(IMG))
    want = det.detect_one(np_img=IMG, conf_thres=0.3).as_array()
    assert got["n"] == len(want) > 0
    assert got["columns"][:4] == ["x1", "y1", "x2", "y2"]
    np.testing.assert_allclose(np.asarray(got["detections"]), want,
                               rtol=RTOL, atol=ATOL)
    assert got["latency_ms"] > 0


def test_conf_thres_query_respected(base, det):
    lo = post(base + "/detect?conf_thres=0.05", png_bytes(IMG))
    hi = post(base + "/detect?conf_thres=0.9", png_bytes(IMG))
    assert lo["n"] == len(det.detect_one(np_img=IMG, conf_thres=0.05))
    assert hi["n"] == len(det.detect_one(np_img=IMG, conf_thres=0.9))
    assert lo["n"] > hi["n"]


def test_concurrent_requests_coalesced(base, det):
    """Eight requests from eight threads, each answered as detect_one
    answers its image; /stats shows fewer batches than requests."""
    imgs = [np.roll(IMG, 7 * i, axis=1) for i in range(8)]
    results, errs = [None] * 8, []
    before = get(base + "/stats")

    def hit(i):
        try:
            results[i] = post(base + "/detect?conf_thres=0.3",
                              png_bytes(imgs[i]))
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs and all(r is not None for r in results)
    for img, r in zip(imgs, results):
        want = det.detect_one(np_img=img, conf_thres=0.3).as_array()
        np.testing.assert_allclose(np.asarray(r["detections"]).reshape(-1, 6),
                                   want, rtol=RTOL, atol=ATOL)
    stats = get(base + "/stats")
    requests = stats["requests"] - before["requests"]
    batches = stats["batches"] - before["batches"]
    assert requests == 8 and batches < requests
    assert stats["batches_by_size"] == {str(SIZE): stats["batches"]}
    assert stats["latency_ms"]["p50"] > 0
    assert 0 <= stats["queue_wait_ms"]["p50"] <= stats["latency_ms"]["max"]


def test_bad_requests_are_4xx(base):
    for url, body in [
        (base + "/detect", b"this is not an image"),
        (base + "/detect?conf_thres=nan-ish-garbage", png_bytes(IMG)),
        (base + "/detect?input_size=999", png_bytes(IMG)),
    ]:
        with pytest.raises(urllib.error.HTTPError) as e:
            post(url, body)
        assert e.value.code == 400
        assert "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        post(base + "/nope", png_bytes(IMG))
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        get(base + "/nope")
    assert e.value.code == 404
    req = urllib.request.Request(base + "/detect", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400


def test_native_jpeg_decode_path(base, server, det):
    """JPEG bodies go through the port's fused C++ decode + letterbox;
    the response equals the library on the same native canvas."""
    if not pnative.available():
        pytest.fail(f"the port's native decoder did not build here: "
                    f"{pnative.build_error()}")
    assert server.use_native  # auto-detected at construction
    buf = io.BytesIO()
    Image.fromarray(IMG).save(buf, format="JPEG", quality=95)
    jpeg = buf.getvalue()
    got = post(base + "/detect?conf_thres=0.3", jpeg)
    canvas, info = pnative.decode_letterbox_jpeg(jpeg, SIZE)
    want = det.detect_prepared(canvas[None], [info],
                               conf_thres=0.3)[0].as_array()
    np.testing.assert_allclose(np.asarray(got["detections"]), want,
                               rtol=RTOL, atol=ATOL)


def test_oversize_body_is_413_and_bad_length_is_400(base, server):
    big = str(server.max_body_bytes + 1)
    req = urllib.request.Request(base + "/detect", data=b"x",
                                 headers={"Content-Length": big},
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 413
    import http.client
    import socket

    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=60) as s:
        s.sendall(b"POST /detect HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: abc\r\n\r\n")
        resp = http.client.HTTPResponse(s, method="POST")
        resp.begin()
        assert resp.status == 400
        assert b"Content-Length" in resp.read()


def test_rejected_requests_counted_in_stats(base):
    before = get(base + "/stats")
    with pytest.raises(urllib.error.HTTPError):
        post(base + "/detect", b"definitely not an image")
    after = get(base + "/stats")
    assert after["requests"] == before["requests"] + 1
    assert after["errors"] == before["errors"] + 1


def test_from_detector_validates_input_sizes(det):
    with pytest.raises(ValueError, match="multiple of 32"):
        DetectionServer.from_detector(det, input_sizes=[64, 500])


def test_cli_rejects_model_flags_with_artifact(capsys):
    with pytest.raises(SystemExit):
        pserve.main(["--artifact", "x.npz", "--batch-buckets", "1,64"])
    assert "--batch-buckets only applies to --model" in capsys.readouterr().err


def test_coalesce_sizes_serves_mixed_sizes_on_one_size(det):
    """With coalesce_sizes a 32/64 client mix is letterboxed onto the
    larger canvas and batches together: batches_by_size shows only 64,
    and the answers are in original pixels."""
    running = Running(DetectionServer.from_detector(
        det, input_sizes=[32, SIZE], batch_buckets=[1, 2], max_wait_ms=50.0,
        coalesce_sizes=True))
    try:
        results = [None, None]

        def go(i, size):
            results[i] = post(f"{running.base}/detect?input_size={size}"
                              f"&conf_thres=0.3", png_bytes(IMG))

        th = [threading.Thread(target=go, args=(0, 32)),
              threading.Thread(target=go, args=(1, SIZE))]
        for x in th:
            x.start()
        for x in th:
            x.join(timeout=120)
        assert all(r is not None for r in results)
        snap = get(f"{running.base}/stats")
        assert set(snap["batches_by_size"]) == {str(SIZE)}
        want = det.detect_one(np_img=IMG, conf_thres=0.3).as_array()
        for r in results:
            np.testing.assert_allclose(np.asarray(r["detections"]), want,
                                       rtol=RTOL, atol=ATOL)
    finally:
        running.close()


# -- batcher unit tests (no HTTP, no model) ------------------------------


class FakeBackend:
    """Records dispatch shapes; returns one sentinel per real row."""

    def __init__(self):
        self.calls = []

    def detect_prepared(self, canvases, infos, *, conf_thres):
        self.calls.append((canvases.shape[0], len(infos), conf_thres))
        return [f"det{i}" for i in range(len(infos))]


def pending(key, conf=None):
    if conf is None:
        conf = key[1] if len(key) > 1 else 0.3
    return _Pending(canvas=np.zeros((8, 8, 3), np.uint8), info=None,
                    key=key, conf=conf, t_enqueue=time.monotonic())


def run_batcher(backend, buckets, wait, pend, *, start_first=False):
    stats = _Stats()
    b = _Batcher(backend, buckets, max_wait_s=wait, stats=stats)
    if start_first:
        b.start()
    for p in pend:
        b.submit(p)
    if not start_first:
        b.start()
    for p in pend:
        assert p.done.wait(10)
    b.stop()
    assert not b.is_alive()
    return stats


def test_batcher_coalesces_same_key():
    backend = FakeBackend()
    pend = [pending((128, 0.3)) for _ in range(4)]
    stats = run_batcher(backend, [1, 4], 0.5, pend)
    assert backend.calls == [(4, 4, 0.3)]
    assert [p.result for p in pend] == ["det0", "det1", "det2", "det3"]
    snap = stats.snapshot(0)
    assert snap["batches"] == 1 and snap["images"] == 4
    assert snap["bucket_occupancy"] == 1.0


def test_batcher_records_each_requests_queue_wait():
    """Four requests enqueued 0.2 s and 0 s before a batcher that
    lingers up to 0.05 s: /stats' queue_wait_ms holds each request's
    enqueue-to-dispatch time, beside latency_ms."""
    assert _Stats().snapshot(0)["queue_wait_ms"] is None
    backend = FakeBackend()
    pend = [pending((128, 0.3)) for _ in range(4)]
    pend[0].t_enqueue -= 0.2
    stats = run_batcher(backend, [1, 4], 0.05, pend)
    assert backend.calls == [(4, 4, 0.3)]
    waits = stats.snapshot(0)["queue_wait_ms"]
    assert set(waits) == {"p50", "p99", "max"}
    assert 200 <= waits["max"] < 10_000
    assert 0 <= waits["p50"] <= waits["p99"] <= waits["max"]
    assert len(stats.queue_waits) == 4


def test_batcher_pads_to_covering_bucket():
    backend = FakeBackend()
    stats = run_batcher(backend, [1, 4], 0.02,
                        [pending((128, 0.3)) for _ in range(3)],
                        start_first=True)
    assert backend.calls == [(4, 3, 0.3)]
    assert stats.snapshot(0)["bucket_occupancy"] == 0.75


def test_batcher_splits_incompatible_keys():
    backend = FakeBackend()
    a1, a2 = pending((128, 0.3)), pending((128, 0.3))
    c1 = pending((128, 0.9))
    run_batcher(backend, [1, 4], 0.02, [a1, c1, a2])
    assert len(backend.calls) == 2
    assert (4, 2, 0.3) in backend.calls and (1, 1, 0.9) in backend.calls


def test_batcher_mixed_conf_coalesces():
    """Size-only keys: requests with different thresholds share one
    dispatch, each keeping its own conf in the per-image vector;
    uniform groups pass the plain scalar."""
    backend = FakeBackend()
    confs = [0.3, 0.9, 0.1, 0.3]
    run_batcher(backend, [1, 4], 0.5,
                [pending((128,), conf=c) for c in confs])
    assert len(backend.calls) == 1
    nrows, nreal, conf_arg = backend.calls[0]
    assert (nrows, nreal) == (4, 4) and list(conf_arg) == confs
    uniform = FakeBackend()
    run_batcher(uniform, [1, 4], 0.5,
                [pending((128,), conf=0.25) for _ in range(4)])
    assert uniform.calls == [(4, 4, 0.25)]


def test_server_groups_by_size_only_with_conf_vector_backend(det):
    """The live Detector takes a per-image conf vector, so the server
    keys on input size alone; a backend without one keys on (size,
    conf)."""
    assert Detector.supports_conf_vector is True

    class ScalarBackend(FakeBackend):
        cfg = det.cfg

    live = DetectionServer(det, input_sizes=[SIZE], batch_buckets=[1, 4],
                           use_native=False)
    assert live._conf_vector
    legacy = DetectionServer(ScalarBackend(), input_sizes=[SIZE],
                             batch_buckets=[1, 4], use_native=False)
    assert not legacy._conf_vector


def test_batcher_queue_cap_sheds():
    b = _Batcher(FakeBackend(), [1, 4], max_wait_s=1.0, stats=_Stats(),
                 max_queue=2)
    b.submit(pending((128, 0.3)))
    b.submit(pending((128, 0.3)))
    with pytest.raises(_TooBusy, match="queue full"):
        b.submit(pending((128, 0.3)))


def test_batcher_cancel_removes_undispatched():
    b = _Batcher(FakeBackend(), [1, 4], max_wait_s=1.0, stats=_Stats())
    p1, p2 = pending((128, 0.3)), pending((128, 0.3))
    b.submit(p1)
    b.submit(p2)
    assert b.cancel(p1) is True
    assert list(b.queue) == [p2]
    assert b.cancel(p1) is False


def test_batcher_error_fails_whole_group():
    class Boom:
        def detect_prepared(self, canvases, infos, *, conf_thres):
            raise RuntimeError("kaboom")

    p1, p2 = pending((128, 0.3)), pending((128, 0.3))
    run_batcher(Boom(), [1, 2], 0.01, [p1, p2])
    assert "kaboom" in str(p1.error) and "kaboom" in str(p2.error)
    assert p1.result is None


# -- the artifact backend ------------------------------------------------


def test_artifact_backend_golden_416(work):
    """The JAX PRNGKey(0) yolov3 at 416, float32, exported and loaded as
    the server's backend: its detect_one reproduces the JAX pipeline's
    golden to the e2e test's gates (counts and classes equal, scores
    within 1e-4, boxes within 1e-2 px). (Each 416 forward costs seconds
    here; the HTTP path of an artifact is the rapid test's.)"""
    flat = {k: np.asarray(v) for k, v in flatten_tree(
        jget_model("yolov3").init(jax.random.PRNGKey(0))).items()}
    det416 = Detector("yolov3", input_size=416, compute_dtype=torch.float32,
                      device="cpu", params=flat)
    path = str(work / "golden.npz")
    export_detector(det416, path, batch_size=1)
    del det416
    ref = np.load(GOLDEN)
    srv = DetectionServer.from_artifact(path, max_wait_ms=5.0)
    assert srv.batch_buckets == [1] and srv.input_sizes == [416]
    d = srv.backend.detect_one(np_img=golden_image(), conf_thres=0.25,
                               nms_iou=0.45)
    assert len(d) == len(ref["scores"])
    np.testing.assert_array_equal(d.classes, ref["classes"])
    np.testing.assert_allclose(d.scores, ref["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.boxes_xyxy, ref["boxes"], rtol=0, atol=1e-2)
    assert srv.meta["model"] == "yolov3" and srv._conf_vector


def test_artifact_backend_rotated(work):
    """A rapid artifact behind the server answers in rotated columns,
    as the live Detector's detect_one does (the seeded init: RAPiD's
    heads saturate, scores 1.0, as in its golden)."""
    rdet = Detector("rapid", input_size=SIZE, pre_nms=64,
                    compute_dtype=torch.float32, device="cpu")
    path = str(work / "rapid.npz")
    export_detector(rdet, path, batch_size=1)
    running = Running(DetectionServer.from_artifact(path, max_wait_ms=5.0))
    try:
        health = get(f"{running.base}/healthz")
        got = post(f"{running.base}/detect?conf_thres=0.3", png_bytes(IMG))
    finally:
        running.close()
    assert health["columns"] == ["cx", "cy", "w", "h", "deg", "score"]
    want = rdet.detect_one(np_img=IMG, conf_thres=0.3).as_array()
    assert got["n"] == len(want) > 0
    np.testing.assert_allclose(np.asarray(got["detections"]), want,
                               rtol=RTOL, atol=ATOL)
