"""The build-and-compare loop that `chip_gn_builds.py`,
`chip_tower_builds.py` and `chip_bottleneck_builds.py` share, on one
NVIDIA GPU.

`compare_builds` builds the committed `csrc/<kernel>.cu` beside every
edited copy named, with the repository's nvcc flags and `-I csrc` (a
copy may include the shared `csrc/hopper.cuh`), one nvcc each, all at
once, and prints the ptxas lines of each. Then each build, the committed
one first and last, is loaded in place of the kernel's library (so the
port's wrappers launch it), held to the caller's checks and, if it
passes, timed by the caller. A build outside its checks is reported and
not timed, unless its file name starts with `timing_`: a cut that
leaves out some of the work, timed to see what that work costs.
"""

from __future__ import annotations

import ctypes
import subprocess
from collections.abc import Callable
from pathlib import Path


def compare_builds(kernel: str, sources: dict[str, Path],
                   notes: tuple[str, ...],
                   check: Callable[[str, ctypes.CDLL], str | None],
                   report: Callable[[str, ctypes.CDLL, bool], None]) -> int:
    """Builds `csrc/<kernel>.cu` as "committed" and each of `sources`
    ({name: .cu path}) under its name, printing the lines of nvcc's
    output that hold any of `notes`; then for each build that compiled
    calls `check(name, lib)` (None, or what failed) and
    `report(name, lib, cut)` (cut: a `timing_` build outside its
    checks). Returns 1 if any build failed to compile or, other than a
    `timing_` cut, its checks; else 0."""
    from mydetection_tpu_torch.kernels import build

    out = Path(build.BUILD_DIR)
    out.mkdir(parents=True, exist_ok=True)
    every = {"committed": build.CSRC / f"{kernel}.cu", **sources}
    so = {name: out / f"cmp_{kernel}_{name}.so" for name in every}
    procs = {name: subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
         str(so[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in every.items()}
    failed = False
    built = []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        lines = [ln.strip() for ln in log.splitlines()
                 if any(word in ln for word in notes)]
        print(f"build {name}: exit {proc.returncode}; {' | '.join(lines)}",
              flush=True)
        if proc.returncode:
            print(log, flush=True)
            failed = True
        else:
            built.append(name)
    order = built + built[:1] if len(built) > 1 and built[0] == "committed" \
        else built
    for name in order:
        lib = build._loaded[kernel] = ctypes.CDLL(str(so[name]))
        bad = check(name, lib)
        if bad:
            print(f"{name}: outside its gates at {bad}", flush=True)
            if not name.startswith("timing_"):
                failed = True
                continue
        report(name, lib, bool(bad))
    build._loaded.pop(kernel, None)
    return 1 if failed else 0
