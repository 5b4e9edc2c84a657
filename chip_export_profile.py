"""Where an exported detect path's host time goes on one NVIDIA GPU,
beside the live Detector's, in a fresh process.

    python3 chip_export_profile.py [name ...]

For each of chip_smoke.py's EXPORT_MAINS named (default: fcos, the
path whose exported batch ran slower than the live one inside
chip_smoke.py's phase 18), bf16 at batch 32 from the seeded init: the
Detector is built and warmed up, exported on the card and loaded back
in this process. Then, timed in turn (`chip_smoke.interleaved_batch_s`,
ROUNDS each): the programs alone on a batch already on the card (the
live dense forward and postprocess, the exported program), and the
whole `detect_prepared` from host canvases. Last, a thread samples the
main thread's stack every SAMPLE_S seconds while ROUNDS whole batches
of each run, and the line names the TOP most frequent innermost
frames: where each path's host time goes; and the caching allocator's
device allocations, frees, retries and peak while each program runs
ROUNDS times. One line a path, with the card's name and power limit. Exits non-zero, printing no result, when
no card is visible.
"""

from __future__ import annotations

import collections
import os
import sys
import tempfile
import threading
import time

import torch

from chip_smoke import (
    BATCH,
    EXPORT_MAINS,
    interleaved_batch_s,
    main_canvases,
    seconds_of,
    smi_line,
)

ROUNDS = 20
SAMPLE_S = 0.0005
TOP = 6


def sampled(fn, rounds: int = ROUNDS) -> list:
    """The TOP innermost (file:line:function) frames of the main thread,
    with their share of the samples, while `fn` runs `rounds` times."""
    main, hits, stop = threading.get_ident(), collections.Counter(), []

    def sample():
        while not stop:
            frame = sys._current_frames().get(main)
            if frame is not None:
                hits[f"{os.path.basename(frame.f_code.co_filename)}:"
                     f"{frame.f_lineno}:{frame.f_code.co_name}"] += 1
            time.sleep(SAMPLE_S)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    for _ in range(rounds):
        seconds_of(fn)
    stop.append(True)
    thread.join()
    total = sum(hits.values()) or 1
    return [(k, round(v / total, 3)) for k, v in hits.most_common(TOP)]


def allocator_use(fn, rounds: int = ROUNDS) -> dict:
    """The caching allocator's device allocations and frees (cudaMalloc,
    cudaFree), retries and peak GiB while `fn` runs `rounds` times."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    for _ in range(rounds):
        seconds_of(fn)
    after = torch.cuda.memory_stats()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("num_device_alloc", "num_device_free",
                      "num_alloc_retries")} | {
        "peak_gib": round(after["allocated_bytes.all.peak"] / 2**30, 2)}


def profile_path(label: str, name: str, size: int, conf: float, smi: str,
                 work: str) -> None:
    from mydetection_tpu_torch import Detector
    from mydetection_tpu_torch.export import export_detector, load_exported

    canvases, infos = main_canvases(size)
    det = Detector(name, input_size=size, rng_seed=0)
    det.warmup(batch_size=BATCH)
    path = os.path.join(work, f"{label}.npz")
    export_detector(det, path, batch_size=(BATCH,))
    served = load_exported(path)
    served.warmup()
    images = torch.from_numpy(canvases).cuda()
    conf_t = torch.full((BATCH,), conf, device="cuda")
    call = served._calls[(size, BATCH)]

    def live_program():
        with torch.inference_mode():
            det._post(det._forward_dense(images), conf_t, det.cfg.nms_iou)

    def exported_program():
        with torch.inference_mode():
            call(served.params, images, conf_t)

    def live():
        det.detect_prepared(canvases, infos, conf_thres=conf)

    def exported():
        served.detect_prepared(canvases, infos, conf_thres=conf)

    programs = interleaved_batch_s(live_program, exported_program, ROUNDS)
    whole = interleaved_batch_s(live, exported, ROUNDS)
    allocator = {"live": allocator_use(live_program),
                 "exported": allocator_use(exported_program)}
    print(f"export profile: {label}-{size} bf16 batch {BATCH}, a fresh "
          f"process, medians of {ROUNDS} timed in turn, live / exported: "
          f"the programs alone on a batch on the card "
          f"{programs[0] * 1e3:.2f} / {programs[1] * 1e3:.2f} ms, the whole "
          f"detect_prepared {whole[0] * 1e3:.2f} / {whole[1] * 1e3:.2f} ms; "
          f"the main thread's innermost frames (share of samples) in "
          f"{ROUNDS} whole batches, live {sampled(live)}, exported "
          f"{sampled(exported)}; the caching allocator over {ROUNDS} "
          f"programs alone {allocator}; on {smi}", flush=True)
    del det, served, images
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_export_profile: no CUDA device visible", file=sys.stderr)
        return 1
    from mydetection_tpu_torch.kernels import build

    build.build_all()
    smi = smi_line()
    names = sys.argv[1:] or ["fcos"]
    mains = {m[0]: m for m in EXPORT_MAINS}
    with tempfile.TemporaryDirectory() as work:
        for label in names:
            _, name, size, _, conf, int8, _ = mains[label]
            if int8:
                raise SystemExit(f"{label}: the int8 path is not profiled "
                                 f"here")
            profile_path(label, name, size, conf, smi, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
