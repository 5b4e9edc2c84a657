"""Tracing and timing helpers.

The port of `mydetection_tpu/utils/profiling.py`:
  * `trace(logdir)` — a `torch.profiler` trace of the enclosed block
    (CPU activity, and CUDA activity where a card is present), written
    to `logdir/trace.json` in Chrome's trace format (chrome://tracing,
    Perfetto); the context yields the profiler, so `key_averages()`
    can be read after the block;
  * `annotate` — `torch.profiler.record_function`, a named range in
    the trace;
  * `timer` / `Timer` — wall timers that synchronise the device of
    `sync` (a tensor, a module output or a callable returning one)
    before the clock stops: CUDA work is asynchronous, so a clock read
    without it measures the enqueue.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
import torch.utils._pytree as pytree

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; writes `logdir/trace.json`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


annotate = torch.profiler.record_function


def synchronize(sync) -> None:
    """Wait for every CUDA device that holds a tensor of `sync` (a
    tensor, any nesting of them, or a callable returning one)."""
    value = sync() if callable(sync) else sync
    devices = {t.device for t in pytree.tree_leaves(value)
               if torch.is_tensor(t) and t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timer(name: str, results: dict | None = None, *, sync=None):
    """Wall timer; the devices of `sync` are synchronised before the
    clock stops. Appends the seconds to `results[name]`, or prints."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        synchronize(sync)
    dt = time.perf_counter() - t0
    if results is not None:
        results.setdefault(name, []).append(dt)
    else:
        print(f"[timer] {name}: {dt * 1000:.2f} ms")


class Timer:
    """Accumulating multi-stage timer.

    with t.stage("decode"): ...
    print(t.summary())
    """

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, *, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            synchronize(sync)
        self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            total = sum(ts)
            out[name] = {
                "calls": len(ts),
                "total_s": round(total, 4),
                "mean_ms": round(1000 * total / len(ts), 3),
                "max_ms": round(1000 * max(ts), 3),
            }
        return out
