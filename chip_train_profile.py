"""Where a train step's time goes on one NVIDIA GPU: chip_smoke.py's train
main paths (fcos-608, yolov3-416, retinanet-608, rapid-1024; bf16, batch
16, from the seeded init) stepped under `torch.profiler`.

    python3 chip_train_profile.py [name ...]

For each path, `chip_smoke.train_main` first runs and prints its usual
line (2 warm-up and 5 timed steps, unprofiled); then PROFILED more
steps run one at a time under the profiler, GPU activity only. For each
profiled step: the kernels and copies on the card, the device span
(first start to last end), the busy time (the union of their
intervals) and so the idle share of the span, and the busy time by
class of kernel (convolution and GEMM, elementwise, reduction, copy,
other). One line a path gives the medians over the profiled steps;
one more step, profiled with the host's operators too, names the
TOP_OPS operators with the most device time of their own. Exits
non-zero, printing no result, when no card is visible or a trace holds
no kernel.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from chip_smoke import TRAIN_BATCH, TRAIN_MAINS, smi_line, train_main

PATHS = (("fcos", 608, TRAIN_BATCH),) + TRAIN_MAINS
LAUNCHES = {"fcos": {"bias_gn_relu_fwd_stats": 40, "bias_gn_relu_bwd": 40}}
PROFILED = 3
TOP_OPS = 8
CLASSES = ("conv/gemm", "elementwise", "reduction", "copy", "other")


def kernel_class(name: str) -> str:
    """A kernel's class by its name: copies (memcpy and memset, PyTorch's
    copy and concatenation kernels, cuDNN's layout transforms) first,
    then cuDNN's and CUTLASS's convolutions and GEMMs, PyTorch's
    reductions and elementwise kernels."""
    n = name.lower()
    if any(k in n for k in ("memcpy", "memset", "copy", "tonhwc", "tonchw")):
        return "copy"
    if any(k in n for k in ("conv", "cudnn", "gemm", "xmma", "cutlass",
                            "wgrad", "dgrad", "implicit")):
        return "conv/gemm"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def busy_union(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_summary(path: str) -> dict:
    """Kernel and copy events of one chrome trace → counts and µs."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise AssertionError(f"no kernel in the trace {path}")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in device]
    by_class = dict.fromkeys(CLASSES, 0.0)
    for e in device:
        by_class[kernel_class(e["name"])] += float(e["dur"])
    span = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = busy_union(spans)
    return {"kernels": len(device), "span_us": span, "busy_us": busy,
            "idle": 1.0 - busy / span, "by_class_us": by_class}


def profile_path(name: str, size: int, batch: int, smi: str,
                 out_dir: str) -> dict:
    from mydetection_tpu_torch.training import burn_in_lr

    step, data, *_ = train_main(name, size, batch, smi,
                                LAUNCHES.get(name, {}))
    rows = []
    for i in range(PROFILED):
        lr = burn_in_lr(100 + i, base_lr=0.01)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(*data, lr)
            torch.cuda.synchronize()
        path = os.path.join(out_dir, f"{name}-{i}.json")
        prof.export_chrome_trace(path)
        rows.append(trace_summary(path))
        os.remove(path)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        step(*data, burn_in_lr(100 + PROFILED, base_lr=0.01))
        torch.cuda.synchronize()
    own = [(e.self_device_time_total / 1e3, e.key)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU]  # operators
    top = [(k, round(ms, 3)) for ms, k in sorted(own, reverse=True)[:TOP_OPS]]
    med = {k: float(np.median([r[k] for r in rows]))
           for k in ("kernels", "span_us", "busy_us", "idle")}
    med["by_class_ms"] = {c: round(float(np.median(
        [r["by_class_us"][c] for r in rows])) / 1e3, 3) for c in CLASSES}
    print(f"train profile: {name}-{size} bf16 batch {batch}, {PROFILED} "
          f"profiled steps (medians): {med['kernels']:.0f} kernels and "
          f"copies a step, device span {med['span_us'] / 1e3:.2f} ms, busy "
          f"{med['busy_us'] / 1e3:.2f} ms, idle share of the span "
          f"{med['idle']:.3f}; busy by class (ms, summed durations) "
          f"{med['by_class_ms']}; operators with the most device time of "
          f"their own (ms, one step with host activity): {top}; on {smi}",
          flush=True)
    med["top_ops_ms"] = top
    del step, data
    torch.cuda.empty_cache()
    return med


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_train_profile: no CUDA device visible", file=sys.stderr)
        return 1
    names = sys.argv[1:] or [p[0] for p in PATHS]
    smi = smi_line()
    result = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for name, size, batch in PATHS:
            if name in names:
                result[name] = profile_path(name, size, batch, smi, out_dir)
    print(json.dumps({"train_profile": result, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
