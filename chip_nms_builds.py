"""Time builds of the two greedy-NMS kernels against each other on one
NVIDIA GPU, at the detect paths' shapes and on their own inputs.

    python3 chip_nms_builds.py [--old build/variants/old] [build/variants/a/nms.cu ...]

For each kernel, `mydetection_tpu_torch/kernels/csrc/nms.cu` (the
axis-aligned keep-mask) and `csrc/rotated_nms.cu` (the suppress from an
IoU matrix), the committed source is built by
`chip_builds.compare_builds` beside:

* `--old DIR`: `DIR/nms.cu` and `DIR/rotated_nms.cu` with the interface
  the kernels had before their launch plan (one block an image, no
  scratch, no plan): the baseline. Those are the sources as of commit
  6424a22:

      mkdir -p build/variants/old
      git show 6424a22:mydetection_tpu_torch/kernels/csrc/nms.cu > build/variants/old/nms.cu
      git show 6424a22:mydetection_tpu_torch/kernels/csrc/rotated_nms.cu > build/variants/old/rotated_nms.cu

* each positional source: an edited copy with the committed C interface,
  kept under `build/` (which git ignores), named by its file name, or by
  its directory and file name where the directory is not
  build/variants/ itself (a directory may hold an edited copy of the
  shared greedy_nms.cuh beside the kernels, which its kernels then
  include); a name ending in `rotated_nms.cu` is a copy of
  rotated_nms.cu, any other of nms.cu. A build that exports
  `greedy_phase_cycles` and `greedy_block_spans` (a copy whose header
  keeps SM clocks of block 0's phases and every block's global-timer
  span and SM) also has them printed, for the first path's inputs at
  B = 32 (at the plan's cluster and at 4) and B = 1.

The main paths' NMS inputs are captured first: one bf16
`detect_prepared` of batch 32 on chip_smoke's canvases each for
yolov3-416, fcos-608 and retinanet-608 (the boxes kernel) and rapid-1024
(the IoU-matrix kernel). Each build, the committed one first and last,
must be bit-equal to the plain version on those inputs and on
chip_smoke's hard cases at K = 512, 1024 and 2048 (B = 32; 2048 is
banded), then is timed with CUDA events at B = 32 and at B = 1 (the
first image) on every one of them. Each build with the committed
interface also times other cluster sizes (`nms_plan`'s choice marked
with *) on the paths' inputs. A build outside its gate is reported and not timed,
unless its file name starts with `timing_`; the exit code is 1 if any
other build failed to compile or to pass.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

from chip_builds import compare_builds
from chip_smoke import (
    BATCH,
    IOU_THRES,
    OLD_LARGEST_ROTATED_K,
    cuda_ms,
    main_canvases,
    nms_cases,
    rotated_cases,
    smi_line,
)

KS = (512, 1024, 2048)
PATHS = {"nms": [("yolov3", 416, 0.25), ("fcos", 608, 0.005),
                 ("retinanet", 608, 0.005)],
         "rotated_nms": [("rapid", 1024, 0.3)]}


def capture(name: str, size: int, conf: float):
    """(src, valid) of the greedy kernel's call in one bf16 detect of
    BATCH canvases: boxes (B, K, 4) for nms_keep, the IoU matrix for the
    rotated suppress."""
    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch.ops import nms as ops_nms
    from mydetection_tpu_torch.ops import rotated as ops_rot

    got = {}
    keep_fn, supp_fn = ops_nms.nms_keep, ops_rot.nms_from_iou_keep

    def grab_nms(src, valid, thr, **kw):
        got["args"] = (src, valid)
        return keep_fn(src, valid, thr, **kw)

    def grab_supp(src, valid, thr, **kw):
        got["args"] = (src, valid)
        return supp_fn(src, valid, thr, **kw)

    det = Detector(name, input_size=size, rng_seed=0)
    canvases, infos = main_canvases(size)
    ops_nms.nms_keep, ops_rot.nms_from_iou_keep = grab_nms, grab_supp
    try:
        det.detect_prepared(canvases, infos, conf_thres=conf,
                            nms_iou=IOU_THRES)
    finally:
        ops_nms.nms_keep, ops_rot.nms_from_iou_keep = keep_fn, supp_fn
    return got["args"]


def cases_for(kernel: str) -> dict[str, tuple]:
    """label -> (src, valid, plain keep) at B = 32: the paths' inputs,
    then the hard cases."""
    from mydetection_tpu_torch.kernels.nms import nms_keep_plain
    from mydetection_tpu_torch.kernels.rotated_nms import (
        nms_from_iou_keep_plain,
    )

    plain = nms_keep_plain if kernel == "nms" else nms_from_iou_keep_plain
    cases = {}
    for name, size, conf in PATHS[kernel]:
        cases[f"{name}-{size}"] = capture(name, size, conf)
    for k in KS:
        rng = np.random.RandomState(k)
        if kernel == "nms":
            boxes, valid = nms_cases(rng, BATCH, k)
            cases[f"hard K={k}"] = (torch.from_numpy(boxes).cuda(),
                                    torch.from_numpy(valid).cuda())
        else:
            cases[f"hard K={k}"] = rotated_cases(rng, BATCH, k, device="cuda")
    out = {}
    for label, (src, valid) in cases.items():
        out[label] = (src, valid, plain(src, valid, IOU_THRES))
    torch.cuda.synchronize()
    return out


def keep_fn(kernel: str, lib: ctypes.CDLL):
    """keep(src, valid) through the loaded build: the port's wrapper for
    a build with the committed interface, a direct launch for an old
    one (None where its one block cannot hold the K x K/32 mask)."""
    from mydetection_tpu_torch.kernels.nms import nms_keep
    from mydetection_tpu_torch.kernels.rotated_nms import nms_from_iou_keep

    if hasattr(lib, "nms_keep_layout_bytes") \
            or hasattr(lib, "rotated_nms_layout_bytes"):
        fn = nms_keep if kernel == "nms" else nms_from_iou_keep
        return lambda src, valid: fn(src, valid, IOU_THRES)
    entry = (lib.nms_keep_launch if kernel == "nms"
             else lib.nms_from_iou_keep_launch)
    entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def old(src, valid):
        b, k = valid.shape
        if kernel == "rotated_nms" and k > OLD_LARGEST_ROTATED_K:
            return None
        keep = torch.empty((b, k), dtype=torch.bool, device=src.device)
        err = entry(src.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                    float(np.float32(IOU_THRES)),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old {kernel} launch failed: {err}")
        return keep
    return old


def sweep(kernel: str, cases: dict) -> None:
    """The loaded build at other cluster sizes, at B = 32 and B = 1
    on the paths' inputs (the same plan otherwise)."""
    from mydetection_tpu_torch.kernels import nms as knms
    from mydetection_tpu_torch.kernels import rotated_nms as krot

    lib = knms._library() if kernel == "nms" else krot._library()
    entry = lib.nms_keep_launch if kernel == "nms" \
        else lib.nms_from_iou_keep_launch
    floats = knms.BOX_FLOATS if kernel == "nms" else 0
    for label, (src, valid, ref) in cases.items():
        if label.startswith("hard"):
            continue
        for b in (BATCH, 1):
            s, v, r = src[:b], valid[:b], ref[:b]
            k = v.shape[1]
            chosen = knms.plan_for(v, box_floats=floats)
            parts = []
            for n in (1, 2, 4, 8, 16):
                plan = knms.NMSPlan(n, chosen.stages, chosen.smem,
                                    -(-k // n), chosen.scratch)
                keep = torch.empty_like(v)

                def run():
                    err = knms.launch(entry, s, v, keep, IOU_THRES, plan)
                    if err:
                        raise RuntimeError(f"cluster {n}: error {err}")
                run()
                if not torch.equal(keep, r):
                    raise AssertionError(f"{kernel} {label} B={b} cluster "
                                         f"{n} differs from plain")
                mark = "*" if n == chosen.cluster else ""
                parts.append(f"{n}{mark} {cuda_ms(run):.4f}")
            print(f"  sweep {kernel} {label} B={b}: cluster ms "
                  + ", ".join(parts), flush=True)


PHASES = ("valid bits", "boxes in, cluster started", "thread 0's rows done",
          "the cluster's mask done", "resolve done", "end")  # then word steps


def phases(lib, kernel: str, case) -> None:
    """For a build exporting greedy_phase_cycles (block 0's SM clock at
    each phase's end, the resolve's word steps and its cycles before, in
    and after the fixpoints) and greedy_block_spans (every block's
    global times at entry, when the cluster's mask is done and at exit,
    and its SM), launches on `case` at B = 32 (at nms_plan's cluster and
    at 4) and at B = 1 and prints them."""
    from mydetection_tpu_torch.kernels import nms as knms

    entry = (lib.nms_keep_launch if kernel == "nms"
             else lib.nms_from_iou_keep_launch)
    entry.argtypes = knms.LAUNCH_ARGTYPES
    floats = knms.BOX_FLOATS if kernel == "nms" else 0
    buf = (ctypes.c_ulonglong * 11)()
    src, valid, _ = case
    k = valid.shape[1]
    chosen32 = knms.plan_for(valid[:BATCH], box_floats=floats)
    for b, n in ((BATCH, chosen32.cluster), (BATCH, 4), (1, None)):
        plan = knms.plan_for(valid[:b], box_floats=floats)
        if n is not None:
            plan = knms.NMSPlan(n, plan.stages, plan.smem, -(-k // n),
                                plan.scratch)
        n = plan.cluster
        s, v = src[:b].contiguous(), valid[:b].contiguous()
        err = knms.launch(entry, s, v, torch.empty_like(v), IOU_THRES, plan)
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"clock build launch failed: {err}")
        lib.greedy_phase_cycles(buf)
        print(f"  clocks B={b}, cluster {n}, block 0 from entry: " + ", ".join(
            f"{name} {buf[i + 1] - buf[0]}" for i, name in enumerate(PHASES))
            + f"; resolve word steps {buf[7]}; on chip, cycles before, in "
            f"and after the fixpoints {buf[8]}, {buf[9]}, {buf[10]}",
            flush=True)
        spans = (ctypes.c_ulonglong * (4 * b * n))()
        lib.greedy_block_spans(spans, b * n)
        t = np.array(spans, dtype=np.float64).reshape(-1, 4)
        sm = t[:, 3].astype(int)
        t = (t[:, :3] - t[:, 0].min()) / 1e3  # us from the first entry
        first = t[::n]  # each cluster's block 0, which resolves

        def q(x):
            return "/".join(f"{v:.1f}" for v in np.percentile(x, [0, 50, 100]))
        print(f"  spans B={b}, cluster {n}, us min/median/max: entry "
              f"{q(t[:, 0])}, mask done {q(t[:, 1])}, exit of the mask "
              f"blocks {q(np.delete(t, np.s_[::n], 0)[:, 2]) if n > 1 else '-'}"
              f", resolve {q(first[:, 2] - first[:, 1])}, exit of the "
              f"resolving blocks {q(first[:, 2])}; {len(set(sm))} SMs",
              flush=True)
        if b > 1:  # each cluster's mask time against its blocks' SM loads
            shared = np.bincount(sm, minlength=sm.max() + 1)[sm]
            rows = [f"{t[c * n, 1] - t[c * n:(c + 1) * n, 0].max():.1f}"
                    f"/{int(shared[c * n:(c + 1) * n].max())}"
                    f"@{t[c * n:(c + 1) * n, 0].max():.0f}"
                    for c in range(b)]
            print("  clusters (mask us after its last entry / most blocks "
                  "on one of its SMs @ entry us): " + " ".join(rows),
                  flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--old", type=Path, default=None)
    parser.add_argument("sources", nargs="*", type=Path)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_nms_builds: no CUDA device visible", file=sys.stderr)
        return 1
    from mydetection_tpu_torch.kernels import build

    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    build.build_all()
    failed = 0
    for kernel in ("nms", "rotated_nms"):
        sources = {}
        if args.old is not None:
            sources["old"] = args.old / f"{kernel}.cu"
        for src in args.sources:
            if src.name.endswith("rotated_nms.cu") == (kernel == "rotated_nms"):
                name = (src.stem if src.parent.name == "variants"
                        else f"{src.parent.name}-{src.stem}")
                sources[name] = src
        with torch.inference_mode():
            cases = cases_for(kernel)
        swept = set()

        def check(name, lib):
            fn = keep_fn(kernel, lib)
            for label, (src, valid, ref) in cases.items():
                got = fn(src, valid)
                torch.cuda.synchronize()
                if got is not None and not torch.equal(got, ref):
                    return f"{label}: {int((got != ref).sum())} entries differ"
            return None

        def report(name, lib, cut):
            fn = keep_fn(kernel, lib)
            parts = []
            for label, (src, valid, _) in cases.items():
                if fn(src, valid) is None:
                    parts.append(f"{label} not taken")
                    continue
                t32 = cuda_ms(lambda: fn(src, valid))
                s1, v1 = src[:1].contiguous(), valid[:1].contiguous()
                t1 = cuda_ms(lambda: fn(s1, v1))
                parts.append(f"{label} {t32:.4f} / {t1:.4f}")
            print(f"{kernel} {name}{' (cut)' if cut else ''}: ms at B={BATCH} "
                  f"/ B=1: " + "; ".join(parts), flush=True)
            if hasattr(lib, "greedy_phase_cycles"):
                phases(lib, kernel, next(iter(cases.values())))
            if name not in swept and not name.startswith("old") \
                    and not hasattr(lib, "greedy_phase_cycles") and not cut:
                swept.add(name)
                sweep(kernel, cases)

        failed |= compare_builds(kernel, sources, ("registers", "spill"),
                                 check, report)
        del cases
        torch.cuda.empty_cache()
    print(smi)
    return failed


if __name__ == "__main__":
    sys.exit(main())
