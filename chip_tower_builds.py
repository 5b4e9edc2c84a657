"""Time other builds of the conv-chain kernel against the committed one
on one NVIDIA GPU.

    python3 chip_tower_builds.py build/variants/a.cu [build/variants/b.cu ...]

Each argument is an edited copy of
`mydetection_tpu_torch/kernels/csrc/tower.cu` with the same C interface,
kept under `build/` (which git ignores); it may include the shared
`csrc/hopper.cuh`. Every source is built with the repository's nvcc
flags, all at once. Each build, the committed one
first and last, is held to `chip_smoke.py`'s gates for the bf16 chain
(0.05 of the plain version, the kernel-order reference at one and four
layers, two runs bit for bit) at six shapes, then one subnet's five
RetinaNet-608 levels at batch 32 are timed with CUDA events beside
cuDNN. A build outside its gates is reported and not timed; the exit
code is 1 if any build failed to compile or to pass.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

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
    from mydetection_tpu_torch.kernels import build
    from mydetection_tpu_torch.models.retinanet import level_shapes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smi_line(), flush=True)
    out = Path(build.BUILD_DIR)
    out.mkdir(parents=True, exist_ok=True)
    sources = {"committed": build.CSRC / "tower.cu"}
    sources.update({Path(p).stem: Path(p) for p in paths})
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(out / f"cmp_{name}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    failed = False
    built = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        notes = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "C75" in ln]
        print(f"build {name}: exit {proc.returncode}; {' | '.join(notes)}",
              flush=True)
        if proc.returncode:
            print(log, flush=True)
            failed = True
        else:
            built.append(name)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [tower_case(gen, 32, h, w, torch.bfloat16, 256)
             for h, w in level_shapes(608)]
    order = built + built[:1] if built and built[0] == "committed" else built
    for name in order:
        build._loaded["tower"] = ctypes.CDLL(str(out / f"cmp_{name}.so"))
        bad = check()
        if bad:
            print(f"{name}: outside its gates at {bad}", flush=True)
            failed = True
            continue
        rows = time_levels(cases)
        print(f"{name}: within its gates; one subnet "
              f"{sum(r[1] for r in rows):.4f} ms (cuDNN "
              f"{sum(r[2] for r in rows):.4f}); by level (kernel / cuDNN / "
              f"bound ms): " + ", ".join(
                  f"{s[2]}x{s[3]} {k:.4f} / {lib:.4f} / {bd:.4f}"
                  for s, k, lib, bd in rows), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
