"""The controls' readings, which the upper ends of the limits of
`correct` are set from, for one cell, in one process on one NVIDIA GPU:

    python3 portbench/calibrate.py --workload <cell> --seeds 3 \
        [--first-seed n] [--out file.json]

For each seed: detect, the reference computed in fp8 in the program's
place; train, the reference in fp8 and the reference with half of every
batch left out, and beside them the program in float32 with TF32 off, a
witness that sides with the reference where bf16's readings are in
doubt. The lower readings are the program's own, printed by every run
of `run.py`. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import cells, harness, judge, traffic  # noqa: E402


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def detect_readings(loaded, seed, device) -> dict:
    cfg, mix = loaded["config"], loaded["traffic"]
    pool = traffic.detect_pool(mix, cfg["input_size"], seed, device)
    state = harness.reference_state(cfg, pool, seed, device)
    fp8, _, _ = harness.reference_detections(cfg, pool, state, device,
                                             lowered="fp8")
    control = [[(d["boxes"], d["scores"], d["classes"]) for d in batch]
               for batch in fp8]
    dets, dense, _ = harness.reference_detections(cfg, pool, state, device)
    return {"fp8": harness.judge_detections(cfg, control, dets, dense)}


def train_readings(loaded, seed, device) -> dict:
    cfg, mix = loaded["config"], loaded["traffic"]
    with harness.tf32_off():
        pool, state, step = harness.train_setup(cfg, mix, seed, device,
                                                compute_dtype=torch.float32)

        def run_step(b, lr):
            x = pool[b]
            return step(x["images"], x["boxes"], x["classes"], x["valid"],
                        lr)

        program = {"program_f32": harness.first_steps(step, pool,
                                                      cfg["train"], run_step)}
    del step
    free(device)
    program["fp8"] = harness.reference_steps(cfg, pool, state, device,
                                             lowered="fp8")
    free(device)
    program["half_batch"] = harness.reference_steps(cfg, pool, state, device,
                                                    half=True)
    free(device)
    reference = harness.reference_steps(cfg, pool, state, device)
    leaves = cfg.get("kernel_leaves", [])
    out = {name: judge.train_numbers(p, reference, leaves)
           for name, p in program.items()}
    out["worst_leaves"] = {name: judge.worst_leaves(p, reference)
                           for name, p in program.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    loaded = cells.load_cell(args.workload)
    readings = (detect_readings if loaded["traffic"]["kind"] == "detect"
                else train_readings)
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        row = readings(loaded, seed, device)
        row["seed"], row["seconds"] = seed, time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]:
        if name in ("seed", "seconds", "worst_leaves"):
            continue
        got = [r[name] for r in rows if name in r]
        summary[name] = {k: [min(g[k] for g in got), max(g[k] for g in got)]
                         for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
