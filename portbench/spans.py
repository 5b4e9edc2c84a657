"""The program's spans against a profiled stretch.

`yardstick.reduce_trace` names an idle gap by the CUDA runtime call the
host was in, and nothing else: between launches every gap reads "host
code". The port records spans at its detect and train layer boundaries
(`mydetection_tpu_torch.utils.profiling.recording`), stamped on the
clock the profiler's host events carry (Unix-epoch ns), so the two line
up on one timeline:

  * `attribute` splits each idle gap over the innermost span covering
    each part of it, and puts each device activity's time down to the
    innermost span that covered the runtime call that launched it
    (matched by correlation id). Spans are matched by time, not by
    thread: autograd launches the backward's kernels from a thread of
    its own, inside the caller's `train.backward`;
  * `name_gaps` names each gap by its innermost span, or by
    "<span> > <runtime call>" where a runtime call is innermost. Spans
    and runtime calls sit on separate stacks, so a few µs of skew
    between the two clocks cannot break either's nesting;
  * `host_ms` is each span's host time a batch or step, over the steps
    a window ran before its stretch;
  * `READERS` are the per-layer metrics these give, each a function of a
    run's ctx like `metrics/*.py`'s `read`, None without spans.

Spans here are (start_ns, end_ns, name) tuples, and for `host_ms` any
object with `name`, `start`, `end` and `step`.
"""

from __future__ import annotations

import torch

from portbench import yardstick

HOST_CODE = "(no host event: host code)"   # yardstick's own label
NO_SPAN = "(no program span)"
NO_CALL = "(no runtime call)"
DETECT_ISSUE = ("detect.inputs", "detect.forward", "detect.post")
TRAIN_PHASES = ("train.batch", "train.forward", "train.backward",
                "train.update")


def split_events(events):
    """Device activity (start, end, name, correlation id), annotations
    left out as the yardstick leaves them, and the host's runtime calls
    (start, end, name, correlation id, (thread id, resource id)): the
    profiler's two names for the calling thread."""
    dev, calls = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not yardstick._annotation(e):
                dev.append((s, s + d, e.name(), e.correlation_id()))
        else:
            calls.append((s, s + d, e.name(), e.correlation_id(),
                          (e.start_thread_id(), e.device_resource_id())))
    return dev, calls


def innermost(spans, points, none: str = NO_SPAN) -> list[str]:
    """For each of the sorted `points`, the name of the latest-starting
    span that covers it, or `none`."""
    return [none if x == HOST_CODE else x
            for x in yardstick._innermost(list(spans), points)]


def _gaps(dev) -> list[tuple[int, int]]:
    busy = yardstick._union([(s, e) for s, e, *_ in dev])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]


def _segments(spans) -> list[tuple[int, int, str]]:
    """The timeline cut at every span's start and end, each piece named
    by its innermost span; pieces no span covers are left out."""
    edges = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = [(p, q) for p, q in zip(edges, edges[1:]) if q > p]
    names = innermost(spans, [(p + q) / 2 for p, q in pieces])
    return [(p, q, n) for (p, q), n in zip(pieces, names) if n != NO_SPAN]


def attribute(events, spans) -> dict | None:
    """{"idle_s": {span: s}, "busy_s": {span: s}}: each idle gap of the
    stretch split over the innermost span of each part (NO_SPAN where
    none covers it), and each device activity's time under the innermost
    span at its launching call's start (NO_CALL where no call matches
    its correlation id). None without device activity."""
    dev, calls = split_events(events)
    if not dev:
        return None
    idle: dict[str, float] = {}
    segs, i = _segments(spans), 0
    for a, b in _gaps(dev):
        t = a
        while t < b:
            while i < len(segs) and segs[i][1] <= t:
                i += 1
            if i < len(segs) and segs[i][0] <= t:
                end, name = min(segs[i][1], b), segs[i][2]
            else:
                end, name = min(segs[i][0] if i < len(segs) else b, b), NO_SPAN
            idle[name] = idle.get(name, 0.0) + (end - t) / 1e9
            t = end
    launched = {c[3]: c[0] for c in calls}
    starts = sorted((launched[d[3]], k) for k, d in enumerate(dev)
                    if d[3] in launched)
    names = dict(zip((k for _, k in starts),
                     innermost(spans, [t for t, _ in starts])))
    busy: dict[str, float] = {}
    for k, (s, e, _, _) in enumerate(dev):
        name = names.get(k, NO_CALL)
        busy[name] = busy.get(name, 0.0) + (e - s) / 1e9
    return {"idle_s": idle, "busy_s": busy}


def name_gaps(events, spans) -> list:
    """`reduce_trace`'s "idle_gaps" with the spans: [[label, s]] top 10,
    a gap named at its middle by its innermost span, or "<span> >
    <runtime call>" where a runtime call covers it too."""
    dev, calls = split_events(events)
    gaps = _gaps(dev)
    mids = [(a + b) // 2 for a, b in gaps]
    inner = innermost(spans, mids)
    call = innermost([c[:3] for c in calls], mids, none=HOST_CODE)
    out: dict[str, float] = {}
    for (a, b), s, c in zip(gaps, inner, call):
        if c != HOST_CODE:
            label = c if s == NO_SPAN else f"{s} > {c}"
        else:
            label = HOST_CODE if s == NO_SPAN else s
        out[label] = out.get(label, 0.0) + (b - a) / 1e9
    return [[n[:200], s] for n, s in
            sorted(out.items(), key=lambda x: -x[1])[:10]]


def host_ms(spans, t0: int, t1: int, root: str) -> dict[str, float]:
    """{span name: host ms a step}, the mean over the steps whose `root`
    span (the one that opens the step) starts in [t0, t1); a step without
    a span of that name counts 0 for it."""
    steps = {s.step for s in spans if s.name == root and t0 <= s.start < t1}
    total: dict[str, float] = {}
    for s in spans:
        if s.step in steps:
            total[s.name] = total.get(s.name, 0.0) + (s.end - s.start) / 1e6
    return {k: v / len(steps) for k, v in total.items()} if steps else {}


def as_tuples(spans) -> list[tuple[int, int, str]]:
    return [(s.start, s.end, s.name) for s in spans]


def reduce(events, spans, t0: int, t1: int, root: str) -> dict | None:
    """`yardstick.reduce_trace(events)` with its gaps named by the spans
    (`name_gaps`), and "program": `attribute`'s split and `host_ms` over
    the steps in [t0, t1)."""
    trace = yardstick.reduce_trace(events)
    if trace is None:
        return None
    tuples = as_tuples(spans)
    trace["idle_gaps"] = name_gaps(events, tuples)
    trace["program"] = {**attribute(events, tuples),
                        "host_ms": host_ms(spans, t0, t1, root)}
    return trace


# -- the per-layer metrics these give ------------------------------------------

def _program(ctx):
    trace = ctx.get("trace")
    return trace.get("program") if trace else None


def _host(ctx, names) -> float | None:
    p = _program(ctx)
    if not p or not any(n in p["host_ms"] for n in names):
        return None
    return sum(p["host_ms"].get(n, 0.0) for n in names)


def _per_step_ms(ctx, key: str, names, *, invert: bool = False):
    p, steps = _program(ctx), ctx.get("profiled_steps")
    if not p or not steps:
        return None
    got = p[key]
    s = (sum(v for k, v in got.items() if k not in names) if invert
         else sum(got.get(n, 0.0) for n in names))
    return 1e3 * s / steps


READERS = {
    # host ms a batch issuing the work: the inputs, the forward's and
    # the postprocess's launches
    "detect_issue_ms": ("detect", lambda c: _host(c, DETECT_ISSUE)),
    # host ms a batch in the copy back: the device's lead, then the copy
    "detect_wait_ms": ("detect", lambda c: _host(c, ("detect.copy_back",))),
    "detect_strip_ms": ("detect", lambda c: _host(c, ("detect.strip",))),
    # device idle ms a batch while the host issues, and anywhere else
    "detect_idle_issue_ms": (
        "detect", lambda c: _per_step_ms(c, "idle_s", DETECT_ISSUE)),
    "detect_idle_after_ms": (
        "detect", lambda c: _per_step_ms(c, "idle_s", DETECT_ISSUE,
                                         invert=True)),
    "train_issue_ms": ("train", lambda c: _host(c, TRAIN_PHASES)),
    # device busy ms a step of what the loss and the update launch
    "train_loss_busy_ms": (
        "train", lambda c: _per_step_ms(c, "busy_s", ("train.loss",))),
    "train_update_busy_ms": (
        "train", lambda c: _per_step_ms(c, "busy_s", ("train.update",))),
}
