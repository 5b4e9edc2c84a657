"""Run one benchmark cell once on one NVIDIA GPU and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `portbench/workloads/<cell>.json`. With --trace 0 the result
line carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics. The last lines on standard error are the numbers
that decide `correct`, each beside its limit; the last line on
standard output is the JSON result. Exits non-zero, printing no result,
without a CUDA device, or when a JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"unavailable ({e})"
    return f"card: {out}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("portbench: no CUDA device is visible", file=sys.stderr)
        return 2
    line, notes, checks = harness.run(args.workload, args.seed, args.seconds,
                                      bool(args.trace),
                                      torch.device("cuda", 0), T_START)
    for text in [card_line(), *notes]:
        print(text, file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX packages loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    sys.stdout.flush()
    for text in checks:
        print(text, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
