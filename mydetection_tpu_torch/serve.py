"""HTTP serving daemon with dynamic micro-batching.

The port of `mydetection_tpu/serve.py`: a dependency-free HTTP daemon
(stdlib `http.server`) that coalesces concurrent requests into one
batched detect, in front of either serving backend —

  - an export artifact (`export.load_exported`) — the production path:
    no model-building code, a fixed (size × batch) bucket grid;
  - a live `Detector` (float or int8) — the development path: any
    size, buckets warmed up at start.

Design:
  - **Dynamic micro-batching.** Handler threads decode and letterbox on
    the host (the parallel part), then enqueue. ONE dispatcher thread
    owns the card and groups compatible requests (same input size;
    conf_thres is a per-image vector in both backends, so mixed
    thresholds coalesce — a backend without one falls back to
    same-conf grouping) into the smallest covering batch bucket. A
    group dispatches as soon as it fills the largest bucket, or when
    its oldest request has waited `max_wait_ms` — the latency /
    occupancy knob.
  - **Static shapes only.** Requests are padded to fixed buckets, so
    after warmup every request runs a shape cuDNN and the kernels have
    already seen.
  - **Observability.** `/stats` reports request and batch counters,
    mean bucket occupancy, queue depth, batches by input size, and
    percentiles of the latency and of the queue wait (enqueue to the
    batch's dispatch) from bounded reservoirs.

Endpoints:
  POST /detect?conf_thres=&input_size=   body: image bytes (JPEG/PNG/
        anything PIL decodes). → JSON {n, columns, detections, ...}.
        Rows follow `Detections.as_array()`: (x1,y1,x2,y2,score,cls)
        or (cx,cy,w,h,deg,score) for rotated models, in ORIGINAL
        image pixel coordinates.
  GET  /healthz   → model / bucket metadata (also the readiness probe:
        it only answers after warmup).
  GET  /stats     → serving counters.

CLI:
  python -m mydetection_tpu_torch.serve --artifact yolov3.npz --port 8000
  python -m mydetection_tpu_torch.serve --model yolov3 --weights w.npz \
      --batch-buckets 1,8,32 --max-wait-ms 4
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_LATENCY_WINDOW = 512  # recent requests kept for percentile stats


@dataclasses.dataclass
class _Pending:
    """One letterboxed request waiting for a device slot."""

    canvas: np.ndarray          # (S, S, 3) uint8
    info: object                # LetterboxInfo
    key: tuple                  # batchable group: (input_size,) when the
                                # backend takes per-image conf vectors,
                                # else (input_size, conf)
    conf: float                 # this request's threshold
    t_enqueue: float
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object = None       # Detections on success
    error: Exception | None = None


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.images = 0
        self.padded_rows = 0
        self.batches_by_size: dict[int, int] = collections.Counter()
        self.latencies = collections.deque(maxlen=_LATENCY_WINDOW)
        self.queue_waits = collections.deque(maxlen=_LATENCY_WINDOW)

    def record_batch(self, n_real: int, bucket: int, input_size: int,
                     queue_waits_s: list[float]) -> None:
        with self.lock:
            self.queue_waits.extend(queue_waits_s)
            self.batches += 1
            self.images += n_real
            self.padded_rows += bucket - n_real
            self.batches_by_size[input_size] += 1

    def record_request(self, latency_s: float, ok: bool) -> None:
        with self.lock:
            self.requests += 1
            if ok:
                self.latencies.append(latency_s)
            else:
                self.errors += 1

    def snapshot(self, queue_depth: int) -> dict:
        with self.lock:
            total_rows = self.images + self.padded_rows
            return {
                "requests": self.requests,
                "errors": self.errors,
                "batches": self.batches,
                "images": self.images,
                "mean_images_per_batch": (
                    round(self.images / self.batches, 3) if self.batches else None),
                "bucket_occupancy": (
                    round(self.images / total_rows, 3) if total_rows else None),
                # per-input-size dispatch counts: the stat that shows
                # size coalescing working — a 416/608 client mix under
                # coalesce_sizes collapses to one size's batches
                "batches_by_size": dict(self.batches_by_size),
                "queue_depth": queue_depth,
                "latency_ms": _percentiles_ms(self.latencies),
                # enqueue to the batch's dispatch: the linger plus the
                # wait behind earlier batches on the one dispatcher
                "queue_wait_ms": _percentiles_ms(self.queue_waits),
            }


def _percentiles_ms(seconds) -> dict | None:
    s = sorted(seconds)
    if not s:
        return None
    return {"p50": round(1e3 * s[len(s) // 2], 2),
            "p99": round(1e3 * s[min(len(s) - 1, int(len(s) * 0.99))], 2),
            "max": round(1e3 * s[-1], 2)}


class _Batcher(threading.Thread):
    """Single consumer thread: groups compatible pending requests and
    runs them through the backend's `detect_prepared`.

    One thread by design: it owns the card, which runs one batch at a
    time on its stream, so a dispatcher pool would only add lock
    traffic. Host-parallel work (decode, letterbox, JSON) stays in the
    HTTP handler threads. The backends enter `torch.inference_mode`
    themselves, so nothing else is needed on this thread.
    """

    def __init__(self, backend, buckets: list[int], max_wait_s: float,
                 stats: _Stats, max_queue: int = 256):
        super().__init__(daemon=True, name="mydet-batcher")
        self.backend = backend
        self.buckets = sorted(buckets)
        self.max_wait_s = max_wait_s
        self.stats = stats
        self.max_queue = max_queue
        self.queue: collections.deque[_Pending] = collections.deque()
        self.cond = threading.Condition()
        self._stopping = False

    def submit(self, p: _Pending) -> None:
        """Enqueue or shed: a bounded queue turns overload into fast
        503s instead of an ever-growing canvas backlog (each entry
        holds an (S, S, 3) buffer) and ever-later timeouts."""
        with self.cond:
            if len(self.queue) >= self.max_queue:
                raise _TooBusy(
                    f"serving queue full ({self.max_queue} pending) — "
                    "retry with backoff")
            self.queue.append(p)
            self.cond.notify()

    def cancel(self, p: _Pending) -> bool:
        """Drop an abandoned request if it has not been dispatched yet,
        so timed-out work doesn't still burn device time."""
        with self.cond:
            try:
                self.queue.remove(p)
                return True
            except ValueError:  # already collected into a dispatch
                return False

    def stop(self) -> None:
        with self.cond:
            self._stopping = True
            self.cond.notify()
        self.join(timeout=30)

    def _covering_bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def run(self) -> None:  # noqa: C901 — one explicit state machine
        max_bucket = self.buckets[-1]
        while True:
            with self.cond:
                while not self.queue and not self._stopping:
                    self.cond.wait()
                if self._stopping and not self.queue:
                    return
                head = self.queue[0]
                # Linger until the head's group fills the largest
                # bucket or the head has waited long enough. New
                # arrivals notify; re-check each wakeup.
                while not self._stopping:
                    matching = sum(1 for p in self.queue if p.key == head.key)
                    remaining = head.t_enqueue + self.max_wait_s - time.monotonic()
                    if matching >= max_bucket or remaining <= 0:
                        break
                    self.cond.wait(timeout=remaining)
                group, rest = [], collections.deque()
                for p in self.queue:
                    if p.key == head.key and len(group) < max_bucket:
                        group.append(p)
                    else:
                        rest.append(p)
                self.queue = rest
            if group:  # head may have been cancel()ed during the linger
                self._dispatch(group)

    def _dispatch(self, group: list[_Pending]) -> None:
        t_dispatch = time.monotonic()
        n = len(group)
        bucket = self._covering_bucket(n)
        try:
            canvases = np.stack([p.canvas for p in group])
            if n < bucket:  # pad to the bucket — padding rows ignored
                pad = np.repeat(canvases[-1:], bucket - n, axis=0)
                canvases = np.concatenate([canvases, pad], axis=0)
            confs = [p.conf for p in group]
            # per-image conf vector when the backend takes one (mixed-
            # threshold requests coalesced into this group); uniform
            # groups pass the single scalar either way
            conf = confs[0] if len(set(confs)) == 1 else confs
            dets = self.backend.detect_prepared(
                canvases, [p.info for p in group], conf_thres=conf)
            self.stats.record_batch(
                n, bucket, input_size=group[0].canvas.shape[0],
                queue_waits_s=[t_dispatch - p.t_enqueue for p in group])
            for p, d in zip(group, dets):
                p.result = d
                p.done.set()
        except Exception as e:  # noqa: BLE001 — fail the whole group loudly
            for p in group:
                p.error = e
                p.done.set()


class DetectionServer:
    """Ties a backend, a `_Batcher`, and the HTTP layer together.

    backend: `Detector` or `export.ExportedDetector` — anything with
    `detect_prepared(canvases, infos, conf_thres=…)`, a `cfg`, and the
    bucket metadata this class derives in `from_*`.
    """

    def __init__(self, backend, *, input_sizes: list[int],
                 batch_buckets: list[int], max_wait_ms: float = 4.0,
                 request_timeout_s: float = 120.0,
                 max_queue: int = 256, max_body_bytes: int = 32 << 20,
                 use_native: bool | None = None,
                 coalesce_sizes: bool = False):
        self.backend = backend
        self.input_sizes = sorted(input_sizes)
        self.batch_buckets = sorted(batch_buckets)
        # OPT-IN mixed-size coalescing: every request is letterboxed
        # onto the LARGEST served canvas, so a 416/608 client mix
        # batches together instead of fragmenting micro-batches per
        # exact size. The requested input_size is still validated (the
        # API contract is unchanged) but becomes advisory: detections
        # map back through the request's own LetterboxInfo, so
        # coordinates are in the same frame — the image is simply
        # processed at the higher resolution (upsampled small objects
        # shift the scale distribution, which costs some accuracy).
        self.coalesce_sizes = bool(coalesce_sizes)
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        if use_native is None:  # auto: fused C++ JPEG decode+letterbox
            from mydetection_tpu_torch import native

            use_native = native.available()
        self.use_native = bool(use_native)
        # mixed-conf coalescing: when the backend takes a per-image
        # conf vector (the live Detector and every export artifact),
        # batch groups key on input_size ONLY — one client with a
        # custom threshold does not fragment batching for everyone. A
        # backend without one keeps (size, conf) grouping.
        self._conf_vector = bool(getattr(backend, "supports_conf_vector",
                                         False))
        self.stats = _Stats()
        self.batcher = _Batcher(backend, self.batch_buckets,
                                max_wait_ms / 1e3, self.stats,
                                max_queue=max_queue)
        self._httpd: ThreadingHTTPServer | None = None
        cfg = backend.cfg
        self.meta = {
            "model": cfg.name,
            "rotated": bool(cfg.rotated),
            "class_names": list(cfg.class_names or []),
            "input_sizes": self.input_sizes,
            "default_input_size": (cfg.input_size
                                   if cfg.input_size in self.input_sizes
                                   else self.input_sizes[-1]),
            "batch_buckets": self.batch_buckets,
            "coalesce_sizes": self.coalesce_sizes,
            "default_conf_thres": float(cfg.conf_thres),
            "columns": (["cx", "cy", "w", "h", "deg", "score"]
                        if cfg.rotated else
                        ["x1", "y1", "x2", "y2", "score", "cls"]),
        }

    # -- construction --------------------------------------------------

    @classmethod
    def from_artifact(cls, path: str, *, device=None,
                      **kw) -> "DetectionServer":
        from mydetection_tpu_torch.export import load_exported

        served = load_exported(path, device=device)
        return cls(served, input_sizes=served.input_sizes,
                   batch_buckets=served.batch_sizes, **kw)

    @classmethod
    def from_detector(cls, det, *, input_sizes: list[int] | None = None,
                      batch_buckets: list[int] | None = None,
                      **kw) -> "DetectionServer":
        from mydetection_tpu_torch.registry import check_input_size

        for s in input_sizes or ():  # readable error, not a shape
            check_input_size(s)      # mismatch deep inside warmup
        return cls(det,
                   input_sizes=input_sizes or [det.cfg.input_size],
                   batch_buckets=batch_buckets or [1, 8, 32], **kw)

    # -- lifecycle ------------------------------------------------------

    def warmup(self) -> None:
        """Run every (size, bucket) shape once before accepting traffic:
        the kernels' first build (nvcc, seconds) and cuDNN's first call
        at a shape inside a request would blow every latency target and,
        worse, stall the whole batcher."""
        from mydetection_tpu_torch.export import ExportedDetector

        if isinstance(self.backend, ExportedDetector):
            # warms every exported (size, batch) program
            self.backend.warmup()
            return
        sizes = ([self.input_sizes[-1]] if self.coalesce_sizes
                 else self.input_sizes)  # coalescing dispatches only
        for s in sizes:                  # the covering size's buckets
            for b in self.batch_buckets:
                canvases = np.zeros((b, s, s, 3), np.uint8)
                from mydetection_tpu_torch.utils.image_ops import LetterboxInfo

                info = LetterboxInfo(ori_w=s, ori_h=s, ratio=1.0,
                                     pad_x=0.0, pad_y=0.0, input_size=s)
                self.backend.detect_prepared(
                    canvases, [info], conf_thres=self.meta["default_conf_thres"])

    def serve(self, host: str = "127.0.0.1", port: int = 8000, *,
              ready_event: threading.Event | None = None) -> None:
        """Warm up, then block serving HTTP until `shutdown()`."""
        self.warmup()
        self.batcher.start()
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_address[1]  # resolves port=0
        if ready_event is not None:
            ready_event.set()
        try:
            self._httpd.serve_forever(poll_interval=0.1)
        finally:
            self.batcher.stop()

    def shutdown(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()

    # -- request path -----------------------------------------------------

    def handle_detect(self, body: bytes, query: dict) -> dict:
        t0 = time.monotonic()
        try:
            size = int(query.get("input_size", self.meta["default_input_size"]))
        except ValueError as e:
            raise _BadRequest(f"bad input_size: {e}") from e
        if size not in self.input_sizes:
            raise _BadRequest(
                f"input_size={size} not served (buckets: {self.input_sizes})")
        if self.coalesce_sizes:
            size = self.input_sizes[-1]  # letterbox onto the covering
            # canvas; the per-request LetterboxInfo still inverts to
            # original pixel coords, so the response is unchanged in
            # format and frame
        try:
            conf = float(query.get("conf_thres",
                                   self.meta["default_conf_thres"]))
        except ValueError as e:
            raise _BadRequest(f"bad conf_thres: {e}") from e
        canvas = info = None
        if self.use_native and body[:2] == b"\xff\xd8":  # JPEG magic
            # fused C++ decode + DCT-prescale + letterbox (GIL-free —
            # handler threads get true decode parallelism); non-JPEG
            # bodies and decode failures fall back to PIL below
            from mydetection_tpu_torch import native

            try:
                canvas, info = native.decode_letterbox_jpeg(body, size)
            except (ValueError, RuntimeError):
                canvas = info = None
        if canvas is None:
            from PIL import Image

            from mydetection_tpu_torch.utils.image_ops import letterbox_pil

            try:
                img = Image.open(io.BytesIO(body))
                img.load()
            except Exception as e:
                raise _BadRequest(
                    f"body is not a decodable image: {e}") from e
            canvas, info = letterbox_pil(img, size)
        key = (size,) if self._conf_vector else (size, conf)
        p = _Pending(canvas=canvas, info=info, key=key, conf=conf,
                     t_enqueue=time.monotonic())
        try:
            self.batcher.submit(p)
        except _TooBusy:
            self.stats.record_request(time.monotonic() - t0, ok=False)
            raise
        if not p.done.wait(self.request_timeout_s):
            # shed the abandoned work if it hasn't been collected into
            # a dispatch yet — an overloaded server must stop burning
            # device time on answers nobody will read
            self.batcher.cancel(p)
            self.stats.record_request(time.monotonic() - t0, ok=False)
            raise _ServerError("detect timed out in the batching queue")
        if p.error is not None:
            self.stats.record_request(time.monotonic() - t0, ok=False)
            raise _ServerError(f"detect failed: {p.error}")
        dt = time.monotonic() - t0
        self.stats.record_request(dt, ok=True)
        dets = p.result
        return {
            "n": len(dets),
            "columns": self.meta["columns"],
            "detections": [[round(float(v), 4) for v in row]
                           for row in dets.as_array()],
            "latency_ms": round(dt * 1e3, 2),
        }


class _BadRequest(ValueError):
    pass


class _TooBusy(RuntimeError):
    pass


class _ServerError(RuntimeError):
    pass


def _make_handler(server: DetectionServer):
    class Handler(BaseHTTPRequestHandler):
        # one server per process; quiet access log by default
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"ok": True, **server.meta})
            elif path == "/stats":
                with server.batcher.cond:
                    depth = len(server.batcher.queue)
                self._json(200, server.stats.snapshot(depth))
            else:
                self._json(404, {"error": f"no route {path}"})

        def _reject(self, code: int, msg: str) -> None:
            # rejected requests still count in /stats — operators tune
            # against TOTAL traffic, not just the well-formed slice
            server.stats.record_request(0.0, ok=False)
            self._json(code, {"error": msg})

        def do_POST(self):  # noqa: N802
            parsed = urlparse(self.path)
            if parsed.path != "/detect":
                self._json(404, {"error": f"no route {parsed.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reject(400, "bad Content-Length header")
                return
            if length <= 0:
                self._reject(400, "empty body — POST image bytes")
                return
            if length > server.max_body_bytes:
                self._reject(413, f"body of {length} bytes exceeds the "
                                  f"{server.max_body_bytes}-byte limit")
                return
            body = self.rfile.read(length)
            query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
            try:
                self._json(200, server.handle_detect(body, query))
            except _BadRequest as e:
                self._reject(400, str(e))
            except _TooBusy as e:
                self._json(503, {"error": str(e)})  # recorded at submit
            except Exception as e:  # noqa: BLE001 — report, don't crash
                self._json(500, {"error": str(e)})

    return Handler


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="HTTP detection server with dynamic micro-batching")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="export artifact "
                     "(mydetection_tpu_torch.export)")
    src.add_argument("--model", help="live model name (registry)")
    ap.add_argument("--weights", default=None, help="weights for --model")
    ap.add_argument("--quantized", default=None,
                    help="int8 artifact path for --model (quant.py)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; an artifact runs on "
                         "the device it was exported for unless it calls "
                         "no kernel")
    ap.add_argument("--input-size", default=None,
                    help="size bucket(s) for --model, comma-separated")
    ap.add_argument("--batch-buckets", default=None,
                    help="batch buckets for --model (default 1,8,32; an "
                         "artifact brings its own)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-wait-ms", type=float, default=4.0,
                    help="max time a request lingers for batch-mates")
    ap.add_argument("--coalesce-sizes", action="store_true",
                    help="serve every request on the largest input-size "
                         "canvas so mixed-size clients batch together "
                         "(opt-in: it trades some accuracy on small "
                         "objects for fuller batches)")
    args = ap.parse_args(argv)

    if args.artifact:
        # fail loudly instead of silently serving the artifact's baked
        # buckets while the operator believes these flags took effect
        for flag, val in (("--weights", args.weights),
                          ("--quantized", args.quantized),
                          ("--input-size", args.input_size),
                          ("--batch-buckets", args.batch_buckets)):
            if val is not None:
                ap.error(f"{flag} only applies to --model; an artifact's "
                         f"buckets/weights are baked at export time "
                         f"(re-export to change them)")
        server = DetectionServer.from_artifact(
            args.artifact, device=args.device, max_wait_ms=args.max_wait_ms,
            coalesce_sizes=args.coalesce_sizes)
    else:
        from mydetection_tpu_torch.api import Detector

        sizes = ([int(x) for x in args.input_size.split(",")]
                 if args.input_size else None)
        overrides = {"input_size": sizes[0]} if sizes else {}
        det = Detector(model_name=args.model, weights_path=args.weights,
                       quantized=args.quantized or False,
                       device=args.device, **overrides)
        server = DetectionServer.from_detector(
            det, input_sizes=sizes,
            batch_buckets=[int(x) for x in
                           (args.batch_buckets or "1,8,32").split(",")],
            max_wait_ms=args.max_wait_ms,
            coalesce_sizes=args.coalesce_sizes)
    # run the server in a worker thread so the readiness line prints
    # AFTER warmup with the truly bound port (--port 0 picks a free one)
    ready = threading.Event()
    t = threading.Thread(target=server.serve, daemon=True,
                         kwargs={"host": args.host, "port": args.port,
                                 "ready_event": ready})
    t.start()
    ready.wait()
    print(json.dumps({"serving": server.meta, "host": args.host,
                      "port": server.port, "ready": True}), flush=True)
    try:
        t.join()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
