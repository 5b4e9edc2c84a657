"""Tracing helpers: the program's spans, and a profiler trace that holds them.

The port of `mydetection_tpu/utils/profiling.py`:
  * `span(name, **attrs)` — a named stretch of the program's host time,
    put only at the detect and train layer boundaries (`api.py`,
    `training.py`, `registry.loss_sums`). While nothing records it is
    one shared no-op context: no clock read, no span built;
  * `recording()` — records every span opened inside its block, on any
    thread, and yields the `Recorder` that keeps them: name, start and
    end, the parent span on the same thread, the id of the batch or step
    the span belongs to, and its attrs. The stamps are `time.time_ns()`,
    the Unix-epoch clock the profiler's host events carry, so spans and
    a `torch.profiler` trace of the same run share one timeline;
  * `trace(logdir)` — a `torch.profiler` trace of the enclosed block
    (CPU activity, and CUDA activity where a card is present), written
    to `logdir/trace.json` in Chrome's trace format (chrome://tracing,
    Perfetto) with the block's spans on a track of their own,
    "program"; the context yields the profiler, so `key_averages()`
    can be read after the block;
  * `annotate` — `torch.profiler.record_function`, a named range in
    the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch

TRACE_FILE = "trace.json"
PROGRAM_TRACK = "program"


class Span:
    """One recorded span; `start` and `end` are Unix-epoch ns, `parent`
    the enclosing span on the same thread (None at the root), `step` the
    batch or step id."""

    __slots__ = ("name", "start", "end", "parent", "step", "thread", "attrs",
                 "_rec")

    def __init__(self, rec: "Recorder", name: str, new_step: bool,
                 attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        stack = rec._stack()
        self.parent = stack[-1] if stack else None
        if new_step:
            with rec._lock:
                rec.steps += 1
                self.step = rec.steps
        else:
            self.step = self.parent.step if self.parent else rec.steps
        # get_ident, not get_native_id: the latter is a system call,
        # which costs ~10 µs where system calls are trapped
        self.thread = threading.get_ident()

    def __enter__(self) -> "Span":
        self._rec._stack().append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.time_ns()
        self._rec._stack().pop()
        self._rec.spans.append(self)


class Recorder:
    """The spans of one `recording()` block, in the order they closed.
    A span that opens a step (`new_step=True`) takes the next id; the
    others take their parent's, or at the root the latest one."""

    def __init__(self):
        self.spans: list[Span] = []
        self.steps = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack


_OFF = contextlib.nullcontext()
_recorder: Recorder | None = None


def span(name: str, *, new_step: bool = False, **attrs):
    """A context over one stretch of the program; `new_step` opens a new
    batch or step id. The shared no-op while nothing records."""
    rec = _recorder
    if rec is None:
        return _OFF
    return Span(rec, name, new_step, attrs)


@contextlib.contextmanager
def recording():
    """Record the spans opened inside the block; yields the `Recorder`."""
    global _recorder
    saved, rec = _recorder, Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = saved


def chrome_events(spans, base_ns: int = 0) -> list[dict]:
    """Spans as Chrome trace events on the "program" track, one lane a
    thread, `ts` in µs from `base_ns` (the trace's baseTimeNanoseconds)."""
    out = [{"ph": "M", "name": "process_name", "pid": PROGRAM_TRACK,
            "args": {"name": PROGRAM_TRACK}}]
    for s in spans:
        args = {"step": s.step, **s.attrs}
        if s.parent is not None:
            args["parent"] = s.parent.name
        out.append({"ph": "X", "cat": PROGRAM_TRACK, "name": s.name,
                    "pid": PROGRAM_TRACK, "tid": s.thread,
                    "ts": (s.start - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block and record its spans; writes
    `logdir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with recording() as rec:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += chrome_events(rec.spans,
                                        doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


annotate = torch.profiler.record_function
