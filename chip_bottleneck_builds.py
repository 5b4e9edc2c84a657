"""Time other builds of the fused-bottleneck kernel against the committed
one on one NVIDIA GPU.

    python3 chip_bottleneck_builds.py [build/variants/a.cu ...]

Each argument is an edited copy of
`mydetection_tpu_torch/kernels/csrc/bottleneck.cu` with the same C
interface, kept under `build/` (which git ignores); it may include the
shared `csrc/hopper.cuh`. Every source is built and loaded by
`chip_builds.compare_builds`, and its ptxas lines are printed. Each build,
the committed one first and last, is held to `chip_smoke.py`'s bf16 gate
(`BOTTLENECK_BF16_GATE` of the plain version, two runs bit for bit) at
`CHECK_SHAPES` and at the halo case, then the three block shapes of a
ResNet-50 608 batch-32 bf16 forward (stage 0's block 0 and block 1,
stage 1's block 1) are timed with CUDA events beside the same blocks
unfused on cuDNN; the six routed calls sum them once, twice and three
times. A build that exports `bottleneck_phase_cycles` (clock counts of
block 0's consumer phases, summed over its tiles) also prints them per
tile at each block shape. A build outside its gate is reported and not
timed, unless its
file name starts with `timing_` (a cut of the kernel that leaves out
some of its work, timed to see what that work costs); the exit code is
1 if any other build failed to compile or to pass.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

from chip_builds import compare_builds
from chip_smoke import (
    BATCH,
    bottleneck_bound_ms,
    bottleneck_case,
    bottleneck_error,
    cuda_ms,
    smi_line,
)

CHECK_SHAPES = [(2, 9, 13, 64, 256), (2, 9, 13, 512, 512), (3, 17, 5, 256, 256),
                (1, 8, 16, 256, 256), (1, 1, 1, 512, 512), (1, 9, 13, 512, 512),
                (4, 76, 76, 512, 512), (4, 152, 152, 256, 256)]
# (B, H, W, c_in, c_out) of the routed calls, and how many a forward makes
MAIN_CALLS = [((BATCH, 152, 152, 64, 256), 1), ((BATCH, 152, 152, 256, 256), 2),
              ((BATCH, 76, 76, 512, 512), 3)]


def check(seed: int = 3) -> str | None:
    """None if the loaded build is within its gate at every shape and on
    the halo case, else what failed."""
    from mydetection_tpu_torch.kernels.bottleneck import (
        fused_bottleneck,
        fused_bottleneck_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(s, 0.0) for s in CHECK_SHAPES] + [((2, 9, 13, 64, 256), 3.0)]
    for (b, h, w, c_in, c_out), bn_bias in cases:
        x, f = bottleneck_case(gen, b, h, w, c_in, c_out, torch.bfloat16,
                               bn_bias=bn_bias)
        got, again = fused_bottleneck(x, *f), fused_bottleneck(x, *f)
        torch.cuda.synchronize()
        err, ok = bottleneck_error(got, fused_bottleneck_plain(x, *f))
        if not (ok and torch.equal(got, again)):
            return (f"{(b, h, w, c_in, c_out)} BN bias {bn_bias}: max-scaled "
                    f"|d| {err:.3g}, bit-equal {torch.equal(got, again)}")
    return None


@torch.no_grad()
def time_calls(cases) -> list[tuple[tuple, int, float, float, float]]:
    """(shape, count, kernel ms, cuDNN ms, bound ms) for each block shape."""
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck

    return [(shape, n, cuda_ms(lambda: fused_bottleneck(x, *f), 10),
             cuda_ms(lambda: blk.unfused(x), 10),
             bottleneck_bound_ms([(x, f)])[0])
            for (shape, n), (x, f, blk) in zip(MAIN_CALLS, cases)]


PHASES = ("conv1", "barrier", "conv2", "conv2 epilogue", "barrier",
          "conv3", "conv3 epilogue")


@torch.no_grad()
def phase_cycles(lib, cases) -> None:
    """Per warpgroup of block 0, the SM clocks a tile spends in each
    consumer phase, at each block shape (one launch)."""
    from mydetection_tpu_torch.kernels.bottleneck import fused_bottleneck

    buf = (ctypes.c_ulonglong * 16)()
    for (shape, _), (x, f, _) in zip(MAIN_CALLS, cases):
        lib.bottleneck_phase_cycles(buf, 1)
        fused_bottleneck(x, *f)
        torch.cuda.synchronize()
        lib.bottleneck_phase_cycles(buf, 0)
        for wg in (0, 1):
            c = buf[wg * 8: wg * 8 + 8]
            tiles = max(c[7], 1)
            print(f"  {shape} warpgroup {wg}, {c[7]} tiles, clocks a tile: "
                  + ", ".join(f"{n} {v / tiles:.0f}"
                              for n, v in zip(PHASES, c[:7]))
                  + f"; all {sum(c[:7]) / tiles:.0f}", flush=True)


@torch.no_grad()
def main(paths: list[str]) -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [bottleneck_case(gen, *shape, torch.bfloat16, with_block=True)
             for shape, _ in MAIN_CALLS]

    def report(name, lib, cut):
        rows = time_calls(cases)
        print(f"{name}: {'timed' if cut else 'within its gate'}; the six "
              f"routed calls "
              f"{sum(n * k for _, n, k, _, _ in rows):.4f} ms (cuDNN unfused "
              f"{sum(n * lb for _, n, _, lb, _ in rows):.4f}, bound "
              f"{sum(n * bd for _, n, _, _, bd in rows):.4f}); by block "
              f"((B, H, W, c_in, c_out) x count: kernel / cuDNN / bound ms): "
              + ", ".join(f"{s} x{n} {k:.4f} / {lb:.4f} / {bd:.4f}"
                          for s, n, k, lb, bd in rows), flush=True)
        if hasattr(lib, "bottleneck_phase_cycles"):
            phase_cycles(lib, cases)

    return compare_builds(
        "bottleneck", {Path(p).stem: Path(p) for p in paths},
        ("registers", "spill", "wgmma", "Function properties"),
        lambda name, lib: check(), report)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
