"""A cell's traced run with the program's spans, and what recording costs.

    python3 portbench/spanprobe.py --workload <cell> --seed <n> --seconds <s>
    python3 portbench/spanprobe.py --workload <cell> --seed <n> --seconds <s> --cost 3

The first form runs the cell's traced window as `run.py --trace 1` does,
inside `profiling.recording()`, with the profiled stretch reduced by
`spans.reduce`: idle gaps named by the program's spans, device time put
down to them. It prints one JSON line: `correct`, the harness's traced
metrics beside `spans.READERS`, the span-named breakdown, and the checks
that the spans line up with the trace (launches inside a span, each
detect kernel inside a `detect.batch`, idle split against the stretch's
idle, a batch's spans against its latency). A program without
`recording` gives the harness's own metrics and breakdown.

`--cost k` sets the cell up once and runs 2k untraced windows of
`--seconds`, recording off and on in turns (off, on, on, off, ...), and
prints each window's rate, the spans a step and what a span costs on
this host with recording on.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ROOTS = {"detect": "detect.batch", "train": "train.batch"}
INSIDE = {"detect": ("detect.batch",),
          "train": ("train.batch", "train.forward", "train.backward",
                    "train.update")}


def recorder():
    """`profiling.recording`, or a context that records nothing where the
    program has none."""
    from mydetection_tpu_torch.utils import profiling
    return getattr(profiling, "recording", contextlib.nullcontext)


def span_profiled(harness, spans_mod, rec, kind: str, kept: dict):
    """`harness.Profiled` reducing its stretch with the spans `rec` holds
    (`spans.reduce`), over the steps between the window's start and the
    stretch's; the stretch's events are left in `kept["events"]`."""

    class SpanProfiled(harness.Profiled):
        def __init__(self, *args):
            super().__init__(*args)
            self.window_ns = time.time_ns()
            self.stretch_ns = None

        def tick(self, now):
            if self.state == 0 and now >= self.start_at:
                self.stretch_ns = time.time_ns()
            super().tick(now)

        def reduce(self):
            if self.state != 2 or rec is None:
                return super().reduce()
            kept["events"] = self.prof.profiler.kineto_results.events()
            return spans_mod.reduce(kept["events"], rec.spans, self.window_ns,
                                    self.stretch_ns, ROOTS[kind])

    return SpanProfiled


def checks(kind: str, events, spans, ctx) -> dict:
    """How well the spans line up with the stretch's trace."""
    from portbench import spans as sp
    dev, calls = sp.split_events(events)
    tuples = sp.as_tuples(spans)
    launches = sorted((c[0], "/".join(map(str, c[4]))) for c in calls
                      if c[2] == "cudaLaunchKernel")
    names = sp.innermost(tuples, [t for t, _ in launches])
    by_thread: dict = {}
    for (_, tid), name in zip(launches, names):
        n = by_thread.setdefault(tid, [0, 0])
        n[0] += 1
        n[1] += name != sp.NO_SPAN
    outer = [t for t in tuples if t[2] in INSIDE[kind]]
    launched = {c[3]: c[0] for c in calls}
    starts = sorted(launched[d[3]] for d in dev if d[3] in launched)
    inside = sp.innermost(outer, starts)
    trace, steps = ctx["trace"], ctx["profiled_steps"]
    gaps = dict(trace["idle_gaps"])
    idle_s = sum(gaps.values())
    out = {"profiled_steps": steps,
           "launches_in_span_by_thread": by_thread,
           "device_ops_launched_inside": [len(starts) - inside.count(sp.NO_SPAN),
                                          len(dev)],
           "host_code_share_of_idle": (gaps.get(sp.HOST_CODE, 0.0) / idle_s
                                       if idle_s else None),
           "idle_ms_a_step": 1e3 * (trace["window_s"] - trace["busy_s"]) / steps,
           "host_ms": trace["program"]["host_ms"]}
    if kind == "detect":
        host = trace["program"]["host_ms"]
        children = sum(v for k, v in host.items() if k != "detect.batch")
        out["children_ms_over_batch_ms"] = (
            children / statistics.fmean(ctx["batch_ms"])
            if ctx.get("batch_ms") else None)
    else:
        out["step_ms"] = 1e3 * ctx["batch"] / ctx["rate"]
    return out


def traced(cell: str, seed: int, seconds: float, device, root=None) -> dict:
    from portbench import cells, harness, judge
    from portbench import spans as sp

    root = root or cells.ROOT
    loaded = cells.load_cell(cell, root)
    kind = loaded["traffic"]["kind"]
    saved, kept = harness.Profiled, {}
    with recorder()() as rec:
        harness.Profiled = span_profiled(harness, sp, rec, kind, kept)
        try:
            out = harness.DRIVERS[kind](loaded, seed, seconds, True, device,
                                        T_START)
        finally:
            harness.Profiled = saved
    for text in out["notes"]:
        print(text, file=sys.stderr)
    ok, numbers = judge.verdict(out["numbers"], loaded["cell"]["limits"])
    ctx = out["ctx"]
    metrics = {}
    for reader in cells.metric_readers(root):
        if reader.KIND == kind:
            value = reader.read(ctx)
            if value is not None:
                metrics[reader.NAME] = value
    for name, (k, read) in sp.READERS.items():
        value = read(ctx) if k == kind else None
        if value is not None:
            metrics[name] = value
    line = {"cell": cell, "seed": seed, "correct": ok, "metrics": metrics,
            "checks": numbers}
    trace = ctx.get("trace")
    if trace is not None:
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"],
                             "busy_s": trace["busy_s"],
                             "window_s": trace["window_s"]}
        if "program" in trace:
            line["program"] = {k: trace["program"][k]
                               for k in ("idle_s", "busy_s")}
            line["span_checks"] = checks(kind, kept["events"], rec.spans,
                                         ctx)
    return line


def cost(cell: str, seed: int, seconds: float, device, k: int) -> dict:
    """2k untraced windows after one set-up, recording off and on in
    turns; img/s of each, the spans a step, and ns a span."""
    from portbench import cells, harness
    from mydetection_tpu_torch.utils import profiling

    loaded = cells.load_cell(cell)
    cfg, mix, family = loaded["config"], loaded["traffic"], loaded["family"]
    kind = mix["kind"]
    if kind == "detect":
        pool, _, det = harness.detect_setup(family, cfg, mix, seed, device)
        infos = [harness._program_infos(b["infos"]) for b in pool]
        batch = pool[0]["canvases"].shape[0]

        def one(i):
            b = i % len(pool)
            det.detect_prepared(pool[b]["canvases"], infos[b],
                                conf_thres=cfg["conf_thres"])
    else:
        pool, _, step = harness.train_setup(family, cfg, mix, seed, device)
        recipe = cfg["train"]
        batch = pool[0]["images"].shape[0]

        def one(i):
            x = pool[i % len(pool)]
            step(x["images"], x["boxes"], x["classes"], x["valid"],
                 harness.burn_in_lr(recipe["first_step"] + i,
                                    recipe["base_lr"], recipe["burn_in"]))
    for i in range(len(pool)):
        one(i)
    harness.sync(device)
    order = [False, True, True, False] * k
    rates = {False: [], True: [], "spans_a_step": None}
    for on in order[:2 * k]:
        ctx = profiling.recording() if on else contextlib.nullcontext()
        with ctx as rec:
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                one(n)
                n += 1
            harness.sync(device)
            wall = time.perf_counter() - t0
        rates[on].append(n * batch / wall)
        if on:
            rates["spans_a_step"] = len(rec.spans) / n
    with profiling.recording():
        t0 = time.perf_counter_ns()
        for _ in range(100_000):
            with profiling.span("probe"):
                pass
        on_ns = (time.perf_counter_ns() - t0) / 100_000
    t0 = time.perf_counter_ns()
    for _ in range(100_000):
        with profiling.span("probe"):
            pass
    off_ns = (time.perf_counter_ns() - t0) / 100_000
    return {"cell": cell, "seed": seed, "img_s_off": rates[False],
            "img_s_on": rates[True], "spans_a_step": rates["spans_a_step"],
            "ns_a_span_on": on_ns, "ns_a_span_off": off_ns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("spanprobe: no CUDA device is visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.cost:
        line = cost(args.workload, args.seed, args.seconds, device, args.cost)
    else:
        line = traced(args.workload, args.seed, args.seconds, device)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
