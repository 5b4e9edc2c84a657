"""One run of one cell: set-up, the measured window, the check of what
the window produced, and the result line.

Detect cells drive `Detector.detect_prepared` in a closed loop over a
pool of device-resident batches; train cells drive `TrainStep` in a
closed loop over a pool of pinned host batches. With `trace` the window
also times the layers by CUDA events around the calls into them and
profiles a short stretch (`Profiled`); the per-layer metrics are read
from that by `metrics/*.py`.
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench import cells, judge, seeds, traffic, weights, yardstick
from portbench.reference import models as ref_models
from portbench.reference import postprocess as ref_post
from portbench.reference import precision

FORBIDDEN = ("jax", "jaxlib", "flax", "mydetection_tpu")
PROFILED_BATCHES = 48   # the profiled stretch of a detect window
PROFILED_STEPS = 4      # and of a train window
SAMPLE_OCCURRENCES = 8  # which of a batch's first 8 window outputs is checked
CORRECT_STEPS = 3


@contextlib.contextmanager
def tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Marks:
    """Device-time marks: CUDA events on the card, the host clock after a
    synchronisation elsewhere (the CPU runs of the tests)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX package's, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


class Profiled:
    """One profiled stretch of a window, device activity and the CUDA
    runtime's calls only, a fixed number of steps from half the window
    on: busy time, kernel time, the idle gaps named by the runtime call
    the host was in. Steps, not seconds, bound it: the profiler keeps a
    bounded buffer, and a train step is some 5,000 kernels. Starting it
    takes seconds, and tracing the runtime slows a host-bound loop, in
    the stretch and after it, so the traced run's rate is taken over the
    steps before it. `tick(now)` before each step counts, starts and
    stops it; `reduce()` reads it after the window."""

    def __init__(self, device: torch.device, seconds: float, steps: int):
        acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
                else [ProfilerActivity.CPU])
        self.device = device
        self.start_at, self.steps = seconds / 2, steps
        self.prof = profile(activities=acts)
        self.state = 0
        self.before = [0, 0.0]      # steps, seconds before the stretch
        self.inside = 0             # steps run inside it

    def tick(self, now: float) -> None:
        if self.state == 0 and now >= self.start_at:
            sync(self.device)
            self.before[1] = now
            self.prof.start()
            self.state, self.inside = 1, 1
        elif self.state == 0:
            self.before[0] += 1
        elif self.state == 1:
            if self.inside >= self.steps:
                self.finish()
            else:
                self.inside += 1

    def finish(self) -> None:
        if self.state == 1:
            sync(self.device)
            self.prof.stop()
            self.state = 2

    def rate(self, steps: int, seconds: float, batch: int) -> float:
        """Images a second before the stretch (over the whole window where
        the stretch never started)."""
        n, s = self.before
        return batch * n / s if n and self.state else batch * steps / seconds

    def reduce(self) -> dict | None:
        if self.state != 2:
            return None
        return yardstick.reduce_trace(self.prof.profiler.kineto_results.events())


def reset_launches() -> None:
    from mydetection_tpu_torch.kernels import reset_launches as reset
    reset()


def launches() -> dict:
    """The port's kernel launch counters (`kernels.KERNELS`)."""
    from mydetection_tpu_torch.kernels import KERNELS
    return {fn.__name__: fn.launches for fn in KERNELS if fn.launches}


# -- detect -----------------------------------------------------------------

def _program_infos(infos):
    from mydetection_tpu_torch.utils.image_ops import LetterboxInfo
    return [LetterboxInfo(**vars(i)) for i in infos]


def lap(laps: list, name: str) -> None:
    """Mark the end of a set-up phase: laps holds (name, clock) pairs."""
    laps.append((name, time.perf_counter()))


def laps_text(laps: list) -> str:
    return "set-up s: " + ", ".join(
        f"{name} {t - t_prev:.2f}" for (_, t_prev), (name, t) in
        zip(laps, laps[1:]))


def reference_state(cfg: dict, pool: list, seed: int, device) -> dict:
    """The reference model's weights from the seed, BatchNorm calibrated
    on the pool's first images, on the host."""
    with tf32_off():
        ref = weights.reference_model(
            cfg["family"], cfg["num_classes"], seed, device,
            pool[0]["canvases"][:weights.CALIB_IMAGES])
    return {k: v.detach().cpu() for k, v in ref.state_dict().items()}


def detect_setup(cfg: dict, mix: dict, seed: int, device, laps=None):
    from mydetection_tpu_torch.api import Detector
    from mydetection_tpu_torch.convert import to_jax_params

    laps = [] if laps is None else laps
    pool = traffic.detect_pool(mix, cfg["input_size"], seed, device)
    lap(laps, "inputs")
    state = reference_state(cfg, pool, seed, device)
    flat = to_jax_params(state)
    lap(laps, "weights")
    det = Detector(cfg["model"], params=flat, device=device,
                   compute_dtype=getattr(torch, cfg["dtype"]))
    lap(laps, "Detector")
    return pool, state, det


def detect_run(loaded: dict, seed: int, seconds: float, trace: bool,
               device: torch.device, t_start: float,
               detector=None) -> dict:
    cfg, mix = loaded["config"], loaded["traffic"]
    laps = [("start", t_start)]
    lap(laps, "imports")
    pool, state, det = detect_setup(cfg, mix, seed, device, laps)
    if detector is not None:    # the tests' faults: the program, broken
        det = detector(det)
    infos = [_program_infos(b["infos"]) for b in pool]
    conf = cfg["conf_thres"]
    marks, stamps = Marks(device), []
    if trace:
        forward, post = det._forward_dense, det._post

        def timed_forward(images):
            with record_function("portbench.forward_dense"):
                a = marks.mark()
                out = forward(images)
                stamps.append([a, marks.mark()])
            return out

        def timed_post(dense, conf_t, iou):
            with record_function("portbench.postprocess"):
                a = marks.mark()
                out = post(dense, conf_t, iou)
                stamps[-1] += [a, marks.mark()]
            return out

        det._forward_dense, det._post = timed_forward, timed_post

    def call(b):
        with record_function("portbench.detect_prepared"):
            return det.detect_prepared(pool[b]["canvases"], infos[b],
                                       conf_thres=conf)

    for b in range(len(pool)):          # warm-up: every shape of the cell
        call(b)
    sync(device)
    lap(laps, "warm-up")
    stamps.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    reset_launches()
    rng = seeds.numpy_rng(seed, "sample")
    sample_at = rng.integers(0, SAMPLE_OCCURRENCES, len(pool))
    seen = [0] * len(pool)
    kept: dict[int, list] = {}
    lat = []
    prof = Profiled(device, seconds, PROFILED_BATCHES) if trace else None
    t0 = time.perf_counter()
    i = 0
    while True:
        b = i % len(pool)
        if prof is not None:
            prof.tick(time.perf_counter() - t0)
        ts = time.perf_counter()
        dets = call(b)
        te = time.perf_counter()
        lat.append(te - ts)
        if seen[b] <= sample_at[b]:
            kept[b] = dets
        seen[b] += 1
        i += 1
        if te - t0 >= seconds and i >= len(pool):
            break
    wall = te - t0
    if prof is not None:
        prof.finish()
    batch = pool[0]["canvases"].shape[0]
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    result = {
        "attempted": i * batch, "failed": 0, "memory": memory,
        "notes": [laps_text(laps), f"launches in the window: {launches()}",
                  "batch latency ms: median "
                  f"{float(np.median(lat)) * 1e3!r}, p95 "
                  f"{float(np.percentile(lat, 95)) * 1e3!r}, {len(lat)} batches"],
        "e2e": {"setup_s": setup_s, "detect_img_s": i * batch / wall}}
    ctx = {"kind": "detect", "device": device, "config": cfg, "mix": mix,
           "batch": batch, "rate": i * batch / wall}
    if trace:
        sync(device)
        early = stamps[:prof.before[0]] or stamps  # before the stretch
        fwd = [marks.ms(s[0], s[1]) for s in early]
        pst = [marks.ms(s[2], s[3]) for s in early]
        ctx.update(forward_ms=fwd, post_ms=pst,
                   batch_ms=[x * 1e3 for x in lat[:len(early)]],
                   rate=prof.rate(i, wall, batch), trace=prof.reduce(),
                   profiled_steps=prof.inside)
    program = [[(d.boxes_xyxy, d.scores, d.classes) for d in kept[b]]
               for b in range(len(pool))]
    del det, kept
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, nms_inputs = detect_check(cfg, pool, state, program, device)
    ctx["nms_inputs"] = nms_inputs
    result.update(numbers=numbers, ctx=ctx)
    return result


def reference_detections(cfg: dict, pool: list, state: dict, device,
                         lowered: str | None = None):
    """The reference's detections of every pool batch, an image; its
    dense boxes and class scores in image pixels, an image; and each
    batch's NMS inputs on the canvas (for the NMS bound)."""
    with tf32_off(), torch.device(device):
        ref = ref_models.build(cfg["family"], cfg["num_classes"])
    ref.load_state_dict(state)
    ref.eval().requires_grad_(False)
    dets, dense_out, nms_inputs = [], [], []
    with tf32_off(), torch.no_grad(), precision.lowered(lowered):
        for b in pool:
            dense = ref_models.dense(ref, cfg["family"], b["canvases"])
            out = ref_post.postprocess(
                dense, multi_label=cfg["multi_label"],
                conf_thres=cfg["conf_thres"], iou_thres=cfg["nms_iou"],
                pre_nms=cfg["pre_nms"], max_dets=cfg["max_dets"])
            dets.append(ref_post.detections(out, b["infos"]))
            scores = ref_models.class_scores(ref, cfg["family"],
                                             b["canvases"], dense)
            boxes = dense["boxes"].cpu().numpy()
            for i, info in enumerate(b["infos"]):
                dense_out.append({"boxes": ref_post.to_original(boxes[i], info),
                                  "scores": scores[i].cpu().numpy(),
                                  "size": (info.ori_w, info.ori_h),
                                  "letterbox": (info.ratio, info.pad_x,
                                                info.pad_y)})
            nms_inputs.append((out["nms_boxes"], out["nms_valid"],
                               out["nms_keep"]))
    return dets, dense_out, nms_inputs


def judge_detections(cfg: dict, program: list, dets: list,
                     dense: list) -> dict:
    """`judge.detect_numbers` of per-batch detections against the
    reference's, with the configuration's postprocess settings."""
    return judge.detect_numbers(
        [img for batch in program for img in batch],
        [img for batch in dets for img in batch], dense,
        nms_iou=cfg["nms_iou"], conf_thres=cfg["conf_thres"],
        max_dets=cfg["max_dets"], multi_label=cfg["multi_label"])


def detect_check(cfg, pool, state, program, device):
    dets, dense, nms_inputs = reference_detections(cfg, pool, state, device)
    return judge_detections(cfg, program, dets, dense), nms_inputs


# -- train ------------------------------------------------------------------

def burn_in_lr(step: int, base_lr: float, burn_in: int) -> float:
    """darknet's burn-in: base_lr·min(step/burn_in, 1)⁴."""
    return base_lr * min(step / burn_in, 1.0) ** 4


def norms(tensors: dict) -> dict:
    names = list(tensors)
    vals = torch._foreach_norm([tensors[k].float() for k in names])
    return dict(zip(names, torch.stack(vals).cpu().tolist()))


def train_setup(cfg: dict, mix: dict, seed: int, device, laps=None,
                **overrides):
    from mydetection_tpu_torch.registry import get_model
    from mydetection_tpu_torch.training import make_train_step

    laps = [] if laps is None else laps
    pool = traffic.train_pool(mix, cfg["input_size"], cfg["num_classes"],
                              seed, device)
    lap(laps, "inputs")
    calib = pool[0]["images"][:weights.CALIB_IMAGES].to(device)
    with tf32_off():
        ref = weights.reference_model(cfg["family"], cfg["num_classes"],
                                      seed, device, calib, head_init=True)
    state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
    lap(laps, "weights")
    overrides.setdefault("compute_dtype", getattr(torch, cfg["dtype"]))
    with torch.device(device):
        model = get_model(cfg["model"], **overrides)
    model.load_state_dict(ref.state_dict())
    del ref
    recipe = cfg["train"]
    step = make_train_step(model, input_size=cfg["input_size"],
                           momentum=recipe["momentum"],
                           weight_decay=recipe["weight_decay"], device=device)
    lap(laps, "TrainStep")
    return pool, state, step


def train_lrs(recipe: dict, n: int) -> list[float]:
    first = recipe["first_step"]
    return [burn_in_lr(first + i, recipe["base_lr"], recipe["burn_in"])
            for i in range(n)]


def first_steps(step, pool: list, recipe: dict, run_step) -> dict:
    """The program's first CORRECT_STEPS steps through `run_step(batch,
    lr)`: each step's total loss, each leaf's first gradient (from the
    velocity after step 1: v = g + wd·p) and its change over the steps,
    as norms."""
    lrs = train_lrs(recipe, CORRECT_STEPS)
    p0 = {k: p.detach().clone() for k, p in step.params.items()}
    losses = []
    for i in range(CORRECT_STEPS):
        terms = run_step(i % len(pool), lrs[i])
        losses.append(float(terms["total"]))
        if i == 0:
            wd = recipe["weight_decay"]
            grad = norms({k: step.velocity[k] - wd * p0[k] for k in p0})
    update = norms({k: step.params[k].detach() - p0[k] for k in p0})
    return {"losses": losses, "grad": grad, "update": update}


def train_run(loaded: dict, seed: int, seconds: float, trace: bool,
              device: torch.device, t_start: float, stepper=None) -> dict:
    cfg, mix = loaded["config"], loaded["traffic"]
    recipe = cfg["train"]
    laps = [("start", t_start)]
    lap(laps, "imports")
    pool, state, step = train_setup(cfg, mix, seed, device, laps)
    marks, phases = Marks(device), []

    def run_step(b, lr):
        x = pool[b]
        if not trace:
            return step(x["images"], x["boxes"], x["classes"], x["valid"], lr)
        with record_function("portbench.train.batch"):
            args = step.batch(x["images"], x["boxes"], x["classes"],
                              x["valid"])
        a = marks.mark()
        with record_function("portbench.train.forward"):
            terms = step.forward(*args)
        f = marks.mark()
        with record_function("portbench.train.backward"):
            grads = step.backward(terms)
        g = marks.mark()
        with record_function("portbench.train.update"):
            step.update(grads, lr)
        phases.append((a, f, g))
        return {k: v.detach() for k, v in terms.items()}

    if stepper is not None:     # the tests' faults: the step, broken
        run_step = stepper(step, run_step)
    # set-up drives the step through its first CORRECT_STEPS steps, on
    # pool batches that all differ, through the window's own call
    program = first_steps(step, pool, recipe, run_step)
    sync(device)
    lap(laps, "first steps")
    phases.clear()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = Profiled(device, seconds, PROFILED_STEPS) if trace else None
    batch = pool[0]["images"].shape[0]
    n = 0
    reset_launches()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if prof is not None:
            prof.tick(time.perf_counter() - t0)
        k = CORRECT_STEPS + n
        last = run_step(k % len(pool), burn_in_lr(recipe["first_step"] + k,
                                                  recipe["base_lr"],
                                                  recipe["burn_in"]))
        n += 1
    sync(device)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.finish()
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    result = {"attempted": n * batch, "failed": 0, "memory": memory,
              "e2e": {"setup_s": setup_s, "train_img_s": n * batch / wall},
              "notes": [laps_text(laps), f"launches in the window: {launches()}",
                        f"steps {n}, last loss terms "
                        f"{ {k: float(v) for k, v in last.items()} }"]}
    ctx = {"kind": "train", "device": device, "config": cfg, "mix": mix,
           "batch": batch, "rate": n * batch / wall}
    if trace:
        early = phases[:prof.before[0]] or phases  # before the stretch
        ctx.update(fwd_ms=[marks.ms(a, f) for a, f, _ in early],
                   bwd_ms=[marks.ms(f, g) for _, f, g in early],
                   rate=prof.rate(n, wall, batch), trace=prof.reduce(),
                   profiled_steps=prof.inside)
    del step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_steps(cfg, pool, state, device)
    result["notes"].append("worst leaves [leaf, program, reference]: "
                           + json.dumps(judge.worst_leaves(program, reference)))
    result.update(numbers=judge.train_numbers(
        program, reference, cfg.get("kernel_leaves", [])), ctx=ctx)
    return result


def reference_steps(cfg: dict, pool: list, state: dict, device, *,
                    lowered: str | None = None, half: bool = False) -> dict:
    """The reference's first CORRECT_STEPS steps from `state` on the pool's
    first batches: each step's total loss, each leaf's first gradient
    norm and its change over the steps. `half` leaves out the second
    half of every batch (a fault the check must catch)."""
    recipe = cfg["train"]
    with torch.device(device):
        model = ref_models.build(cfg["family"], cfg["num_classes"])
    model.load_state_dict(state)
    model.train()
    params = dict(model.named_parameters())
    velocity = {k: torch.zeros_like(p) for k, p in params.items()}
    p0 = {k: p.detach().clone() for k, p in params.items()}
    lrs = train_lrs(recipe, CORRECT_STEPS)
    losses = []
    with tf32_off(), precision.lowered(lowered):
        for i in range(CORRECT_STEPS):
            x = pool[i % len(pool)]
            rows = slice(0, x["images"].shape[0] // 2 if half else None)
            terms = ref_models.loss(
                model, cfg["family"], x["images"][rows].to(device),
                x["boxes"][rows].to(device), x["classes"][rows].to(device),
                x["valid"][rows].to(device))
            grads = torch.autograd.grad(terms["total"], list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), grads)}
            if i == 0:
                grad = norms(grads)
            ref_models.sgd(params, grads, velocity, lr=lrs[i],
                           momentum=recipe["momentum"],
                           weight_decay=recipe["weight_decay"])
            losses.append(float(terms["total"].detach()))
            del terms, grads
    update = norms({k: params[k].detach() - p0[k] for k in p0})
    return {"losses": losses, "grad": grad, "update": update}


# -- one run ----------------------------------------------------------------

DRIVERS = {"detect": detect_run, "train": train_run}


def run(cell: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, root=cells.ROOT,
        **faults) -> tuple[dict, list[str], list[str]]:
    """One run of `cell`: (the result line, notes for earlier lines, the
    lines of numbers beside their limits)."""
    loaded = cells.load_cell(cell, root)
    kind = loaded["traffic"]["kind"]
    out = DRIVERS[kind](loaded, seed, seconds, trace, device, t_start,
                        **faults)
    ok, checks = judge.verdict(out["numbers"], loaded["cell"]["limits"])
    out["notes"].append("not compared: " + json.dumps(
        {k: v for k, v in out["numbers"].items() if k not in checks}))
    if trace:
        metrics = {}
        for reader in cells.metric_readers(root):
            if reader.KIND != kind:
                continue
            value = reader.read(out["ctx"])
            if value is not None:
                metrics[reader.NAME] = {"value": value, "unit": reader.UNIT}
    else:
        units = {"setup_s": "s", "detect_img_s": "img/s",
                 "train_img_s": "img/s"}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["e2e"].items()}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(out["memory"])}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    line = {"correct": ok, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}"
             for k, c in checks.items()]
    return line, out["notes"], lines

