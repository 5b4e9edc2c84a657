"""Time other builds of the conv-chain kernel against the committed one
on one NVIDIA GPU.

    python3 chip_tower_builds.py build/variants/a.cu [build/variants/b.cu ...]

Each argument is an edited copy of
`mydetection_tpu_torch/kernels/csrc/tower.cu` with the same C interface,
kept under `build/` (which git ignores); it may include the shared
`csrc/hopper.cuh`. Every source is built and loaded by
`chip_builds.compare_builds`. Each build, the committed one first and
last, is held to `chip_smoke.py`'s gates for the bf16 chain (0.05 of the
plain version, the kernel-order reference at one and four layers, two
runs bit for bit) at six shapes, then one subnet's five RetinaNet-608
levels at batch 32 are timed with CUDA events beside cuDNN. A build
outside its gates is reported and not timed, unless its file name
starts with `timing_`; the exit code is 1 if any other build failed to
compile or to pass.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from chip_builds import compare_builds
from chip_smoke import (
    cuda_ms,
    smi_line,
    tower_bound_ms,
    tower_case,
    tower_error,
    tower_ref_error,
)

SHAPES = [(1, 5, 5, 64), (2, 9, 13, 64), (3, 7, 11, 256), (32, 76, 76, 256),
          (32, 5, 5, 256), (32, 19, 19, 256)]


def check(seed: int = 3) -> str | None:
    """None if the loaded build is within its gates at every shape and
    layer count, else what failed."""
    from mydetection_tpu_torch.kernels.tower import (
        conv3x3_chain,
        conv3x3_chain_plain,
        conv3x3_chain_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for b, h, w, c in SHAPES:
        for layers in (1, 4):
            args = tower_case(gen, b, h, w, torch.bfloat16, c, layers=layers)
            got, again = conv3x3_chain(*args), conv3x3_chain(*args)
            torch.cuda.synchronize()
            plain, ok_plain = tower_error(got, conv3x3_chain_plain(*args))
            ref, ok_ref = tower_ref_error(got, conv3x3_chain_reference(*args),
                                          layers)
            if not (ok_plain and ok_ref and torch.equal(got, again)):
                return (f"{(b, h, w, c)} L = {layers}: plain {plain:.3g}, "
                        f"reference {ref:.3g}, bit-equal "
                        f"{torch.equal(got, again)}")
    return None


def time_levels(cases) -> list[tuple[tuple, float, float, float]]:
    """(shape, kernel ms, cuDNN ms, bound ms) for each level call."""
    from mydetection_tpu_torch.kernels.tower import conv3x3_chain, unpack_weights

    rows = []
    for args in cases:
        x, packed, biases = args
        layers = [(wt.contiguous(), bi.to(x.dtype))
                  for wt, bi in zip(unpack_weights(packed), biases)]

        def library():
            y = x
            for wt, bi in layers:
                y = F.conv2d(y, wt, bi, padding=1).relu_()

        rows.append((tuple(x.shape), cuda_ms(lambda: conv3x3_chain(*args), 10),
                     cuda_ms(library, 10), tower_bound_ms([args])[0]))
    return rows


@torch.no_grad()
def main(paths: list[str]) -> int:
    if not torch.cuda.is_available() or not paths:
        print(__doc__, file=sys.stderr)
        return 2
    from mydetection_tpu_torch.models.retinanet import level_shapes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [tower_case(gen, 32, h, w, torch.bfloat16, 256)
             for h, w in level_shapes(608)]

    def report(name, lib, cut):
        rows = time_levels(cases)
        print(f"{name}: {'timed' if cut else 'within its gates'}; one subnet "
              f"{sum(r[1] for r in rows):.4f} ms (cuDNN "
              f"{sum(r[2] for r in rows):.4f}); by level (kernel / cuDNN / "
              f"bound ms): " + ", ".join(
                  f"{s[2]}x{s[3]} {k:.4f} / {lib:.4f} / {bd:.4f}"
                  for s, k, lib, bd in rows), flush=True)

    return compare_builds("tower", {Path(p).stem: Path(p) for p in paths},
                          ("registers", "spill", "C75"),
                          lambda name, lib: check(), report)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
