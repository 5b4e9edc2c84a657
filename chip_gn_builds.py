"""Time builds of the GroupNorm kernels against each other on one NVIDIA
GPU, at the FCOS-608 main paths' shapes.

    python3 chip_gn_builds.py [--old build/variants/old_gn.cu] [build/variants/a.cu ...]
    python3 chip_gn_builds.py --sweep

The committed `mydetection_tpu_torch/kernels/csrc/gn.cu` is built beside
every source named by `chip_builds.compare_builds`, and the ptxas lines
of each are printed. A positional source is an edited copy of gn.cu
with the same C interface, kept under `build/` (which git ignores); it
may include the shared `csrc/hopper.cuh`. `--old` names a source with
the interface gn.cu had before its launch plan (an int `vectorized` in
place of the plan, part (3, B, C)): the one-block-per-(image, group)
design, timed as the baseline. That source is gn.cu as of commit
b4fe3f0:

    git show b4fe3f0:mydetection_tpu_torch/kernels/csrc/gn.cu > build/variants/old_gn.cu

Each build, the committed one first and last, is held to
`chip_smoke.py`'s gates against the plain versions (forward f32 1e-5,
bf16 one ulp + 1e-5; statistics 1e-5 max-scaled; backward
`gn_train_error`; every output bit-equal over two runs) at
`CHECK_SHAPES`, then timed with CUDA events: the forward's 8 calls at
each FCOS level at batch 32 (the detect path's 40), the forward with
statistics and the backward at batch 16 (the train step's 40 each),
beside the bytes bound and the library calls (`F.group_norm` on
x + bias; `aten.native_group_norm_backward`). A build outside its gate
is reported and not timed, unless its file name starts with `timing_`
(a cut that leaves out some of the work, timed to see what that work
costs); the exit code is 1 if any other build failed to compile or to
pass. A build that exports `gn_phase_cycles(out, arm)` (arm 1 zeroes,
arm 0 reads sixteen counters: block 0's SM clocks from its entry, consumer thread
0's at out[0..5], producer lane 0's at out[8..11]) also prints them for
one P3 forward at batch 32 and one P3 backward at batch 16.

`--sweep` runs the committed build at other plans than `gn_plan`'s (the
plan is an argument of the launch), each held to its gate first: the
forward at P3 (batch 32 and 16) at resident clusters of 14, 15 and 16
blocks, and the backward at every FCOS level (batch 16) on `gn_plan`'s
resident plan and streaming through 4 stages of up to 32 pixels at
clusters of 1 to 16, each with how many of its clusters the card holds
at once.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from chip_builds import compare_builds
from chip_smoke import (
    BATCH,
    GN_F32_GATE,
    GN_GROUPS,
    TRAIN_BATCH,
    cuda_ms,
    gn_bound_ms,
    gn_case,
    gn_error,
    gn_train_error,
    max_scaled,
    smi_line,
)

CHECK_SHAPES = [(2, 76, 76), (12, 76, 76), (1, 19, 19), (3, 5, 7), (4, 38, 38)]
LEVELS = [(76, 76), (38, 38), (19, 19), (10, 10), (5, 5)]
CALLS_A_LEVEL = 8   # 4 tower GNs in each of the two FCOS towers


class OldGN:
    """The three calls of a build with the pre-plan interface."""

    def __init__(self, lib: ctypes.CDLL):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bias_gn_relu_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, i,
                                            i, p]
        lib.bias_gn_relu_fwd_stats_launch.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, f, i, i, p]
        lib.bias_gn_relu_bwd_launch.argtypes = [
            p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        self.lib = lib

    @staticmethod
    def _args(x):
        b, c, h, w = x.shape
        return b, h * w, c, GN_GROUPS

    def fwd(self, x, bias, scale, shift):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        self.lib.bias_gn_relu_launch(
            x.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), *self._args(x), 1e-5,
            int(x.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream().cuda_stream)
        return out

    def fwd_stats(self, x, bias, scale, shift):
        out = torch.empty_like(x, memory_format=torch.channels_last)
        mean = torch.empty(x.shape[0], GN_GROUPS, device=x.device)
        inv = torch.empty_like(mean)
        self.lib.bias_gn_relu_fwd_stats_launch(
            x.data_ptr(), bias.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            out.data_ptr(), mean.data_ptr(), inv.data_ptr(), *self._args(x),
            1e-5, int(x.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream().cuda_stream)
        return out, mean, inv

    def bwd(self, x, y, dy, bias, scale, mean, inv):
        b, c = x.shape[:2]
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        part = torch.empty(3, b, c, device=x.device)
        sums = torch.empty(3, c, device=x.device)
        self.lib.bias_gn_relu_bwd_launch(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), mean.data_ptr(), inv.data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), *self._args(x),
            int(x.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream().cuda_stream)
        return dx, sums[0], sums[1], sums[2]


class NewGN:
    """The three wrappers of kernels/gn.py over the loaded build."""

    def __init__(self):
        from mydetection_tpu_torch.kernels import gn
        self.gn = gn

    def fwd(self, *a):
        return self.gn.bias_gn_relu(*a, groups=GN_GROUPS)

    def fwd_stats(self, *a):
        return self.gn.bias_gn_relu_fwd_stats(*a, groups=GN_GROUPS)

    def bwd(self, *a):
        return self.gn.bias_gn_relu_bwd(*a, groups=GN_GROUPS)


def bwd_case(gen, b, h, w, dtype):
    """gn_case's inputs, their plain forward's y, mean and inv, and a dy
    N(0, 1) in channels_last: the backward's arguments."""
    from mydetection_tpu_torch.kernels.gn import bias_gn_relu_fwd_stats_plain

    x, bias, scale, shift = gn_case(gen, b, h, w, dtype)
    y, mean, inv = bias_gn_relu_fwd_stats_plain(x, bias, scale, shift,
                                                groups=GN_GROUPS)
    y = y.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    return (x, bias, scale, shift), (x, y, dy, bias, scale, mean, inv)


@torch.no_grad()
def check(k, seed: int = 5) -> str | None:
    """None if build k is within its gates and bit-reproducible at every
    check shape in both dtypes, else what failed."""
    from mydetection_tpu_torch.kernels import gn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CHECK_SHAPES:
            f, bw = bwd_case(gen, *shape, dtype)
            got, again = k.fwd(*f), k.fwd(*f)
            e, ok = gn_error(got, gn.bias_gn_relu_plain(*f, groups=GN_GROUPS))
            if not (ok and torch.equal(got, again)):
                return f"forward {dtype} {shape}: {e:.3g}"
            got, again = k.fwd_stats(*f), k.fwd_stats(*f)
            ref = gn.bias_gn_relu_fwd_stats_plain(*f, groups=GN_GROUPS)
            e, ok = gn_error(got[0], ref[0])
            st = max(max_scaled(a, b) for a, b in zip(got[1:], ref[1:]))
            if not (ok and st <= GN_F32_GATE
                    and all(torch.equal(a, b) for a, b in zip(got, again))):
                return f"forward with statistics {dtype} {shape}: {e:.3g}, {st:.3g}"
            got, again = k.bwd(*bw), k.bwd(*bw)
            ref = gn.bias_gn_relu_bwd_plain(*bw, groups=GN_GROUPS)
            for a, b, c in zip(got, again, ref):
                e, ok = gn_train_error(a, c)
                if not (ok and torch.equal(a, b)):
                    return f"backward {dtype} {shape}: {e:.3g}"
    torch.cuda.synchronize()
    return None


def library_fwd(f):
    x, b, s, t = f
    xb = x + b.to(x.dtype)[:, None, None]
    return lambda: F.group_norm(xb, GN_GROUPS, s.to(x.dtype), t.to(x.dtype),
                                1e-5)


def library_bwd(bw):
    x, _, dy, bias, scale, _, _ = bw
    b, c, h, w = x.shape
    xb = (x + bias.to(x.dtype)[:, None, None]).contiguous()
    wt = scale.to(x.dtype)
    _, mean, rstd = torch.ops.aten.native_group_norm(
        xb, wt, None, b, c, h * w, GN_GROUPS, 1e-5)
    dyc = dy.contiguous()
    return lambda: torch.ops.aten.native_group_norm_backward(
        dyc, xb, mean, rstd, wt, b, c, h * w, GN_GROUPS, [True, True, True])


FWD_PHASES = ("parameters in", "sums done", "of which waiting for data",
              "exchange done", "normalize done", "end")
BWD_PHASES = ("pass 1 done", "of which waiting for data", "exchange done",
              "pass 2 done", "of which waiting for data", "end")
PRODUCER = ("all loads issued", "walk done", "of which waiting on consumers",
            "end")


@torch.no_grad()
def phase_cycles(lib, cases) -> None:
    """Block 0's phase clocks for one P3 forward (batch 32) and one P3
    backward (batch 16), from a build exporting gn_phase_cycles."""
    buf = (ctypes.c_ulonglong * 16)()
    k = NewGN()
    for label, names, run in (
            ("forward B=32 P3", FWD_PHASES, lambda: k.fwd(*cases[0][0])),
            ("backward B=16 P3", BWD_PHASES, lambda: k.bwd(*cases[0][2]))):
        lib.gn_phase_cycles(buf, 1)
        run()
        torch.cuda.synchronize()
        lib.gn_phase_cycles(buf, 0)
        print(f"  {label}, block 0 clocks: "
              + ", ".join(f"{n} {buf[i]}" for i, n in enumerate(names))
              + "; producer: " + ", ".join(f"{n} {buf[8 + i]}"
                                           for i, n in enumerate(PRODUCER)),
              flush=True)


def plan_of(kind, b, hw, n, chunk, stages, resident, copies=4):
    """A GNPlan of the given cut at C = 256 bf16, 32 groups."""
    from mydetection_tpu_torch.kernels import gn

    m = -(-hw // n)
    if kind == "fwd":
        chunk = -(-m // copies)
        slots = -(-m // chunk)
    else:
        chunk = min(chunk, m)
        slots = stages
    smem = gn._smem_bytes(kind, 256, 2, GN_GROUPS, resident=resident,
                          tile=m if resident else 0, stages=stages,
                          chunk=chunk, slots=slots)
    chunk2 = chunk if kind == "fwd" or not resident else 3 * chunk
    return gn.GNPlan(n, resident, chunk, chunk2, stages,
                     m if resident else 0, slots, smem, b * n)


@torch.no_grad()
def sweep() -> None:
    """The committed build at other plans (see the module docstring)."""
    from mydetection_tpu_torch.kernels import gn

    lib = gn._library()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def clusters(kind, x, plan):
        b, c, h, w = x.shape
        return lib.gn_max_active_clusters(int(kind == "bwd"), b, h * w, c,
                                          GN_GROUPS, gn._DTYPES[x.dtype],
                                          plan.as_ints())

    for b in (BATCH, TRAIN_BATCH):
        f, _ = bwd_case(gen, b, 76, 76, torch.bfloat16)
        x, bias, scale, shift = f
        out = torch.empty_like(x)
        ref = gn.bias_gn_relu_plain(*f, groups=GN_GROUPS)
        for n in (16, 15, 14):
            plan = plan_of("fwd", b, 76 * 76, n, 0, 0, True)
            run = lambda: gn._launch_fwd(x, bias, scale, shift, out, None,
                                         GN_GROUPS, plan)
            run()
            ok = gn_error(out, ref)[1]
            print(f"sweep forward B={b} P3, resident cluster {n}: "
                  f"{clusters('fwd', x, plan)} clusters at once, within its "
                  f"gate {ok}, {cuda_ms(run, 20):.4f} ms", flush=True)
    for h, w in LEVELS:
        _, bw = bwd_case(gen, TRAIN_BATCH, h, w, torch.bfloat16)
        x, y, dy, bias, scale, mean, inv = bw
        dx = torch.empty_like(x)
        sums = torch.empty(3, x.shape[1], device="cuda")
        ref = gn.bias_gn_relu_bwd_plain(*bw, groups=GN_GROUPS)
        plans = [("the default, resident", gn.plan_for("bwd", x, GN_GROUPS))]
        plans += [(f"streaming cluster {n}, 4 stages of up to 32 px",
                   plan_of("bwd", TRAIN_BATCH, h * w, n, 32, 4, False))
                  for n in (1, 2, 4, 8, 16) if n <= h * w]
        for label, plan in plans:
            run = lambda: gn._launch_bwd(x, y, dy, bias, scale, mean, inv, dx,
                                         sums, GN_GROUPS, plan)
            run()
            ok = all(gn_train_error(a, r)[1]
                     for a, r in zip((dx, sums[0], sums[1], sums[2]), ref))
            print(f"sweep backward B={TRAIN_BATCH} {h}x{w}, {label}: "
                  f"{clusters('bwd', x, plan)} clusters at once, within its "
                  f"gate {ok}, {cuda_ms(run, 20):.4f} ms", flush=True)


@torch.no_grad()
def time_build(k, cases) -> dict:
    """ms for one call at each level: forward (batch 32), forward with
    statistics and backward (batch 16); and each path's 40 calls."""
    rows = {"fwd": [], "fwd_stats": [], "bwd": []}
    for (f32b, f16b, bw) in cases:
        rows["fwd"].append(cuda_ms(lambda: k.fwd(*f32b), 20))
        rows["fwd_stats"].append(cuda_ms(lambda: k.fwd_stats(*f16b), 20))
        rows["bwd"].append(cuda_ms(lambda: k.bwd(*bw), 20))
    return rows


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(smi_line(), flush=True)
    if argv == ["--sweep"]:
        sweep()
        return 0
    sources = {}
    if argv[:1] == ["--old"]:
        sources["old"], argv = Path(argv[1]), argv[2:]
    sources.update({Path(p).stem: Path(p) for p in argv})
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for h, w in LEVELS:
        f32b, _ = bwd_case(gen, BATCH, h, w, torch.bfloat16)
        f16b, bw = bwd_case(gen, TRAIN_BATCH, h, w, torch.bfloat16)
        cases.append((f32b, f16b, bw))
    lib_rows = {"fwd": [cuda_ms(library_fwd(c[0]), 20) for c in cases],
                "bwd": [cuda_ms(library_bwd(c[2]), 20) for c in cases]}
    bounds = {"fwd": [gn_bound_ms([c[0]])[0] for c in cases],
              "fwd_stats": [gn_bound_ms([c[1]], stats=True)[0] for c in cases],
              "bwd": [gn_bound_ms([c[2]], backward=True)[0] for c in cases]}
    for kind, per in bounds.items():
        print(f"bound {kind}: 40 calls {CALLS_A_LEVEL * sum(per):.4f} ms; by "
              f"level " + ", ".join(f"{v:.4f}" for v in per), flush=True)
    for kind, per in lib_rows.items():
        print(f"library {kind}: 40 calls {CALLS_A_LEVEL * sum(per):.4f} ms; "
              f"by level " + ", ".join(f"{v:.4f}" for v in per), flush=True)

    def kernels(name, lib):
        return OldGN(lib) if name == "old" else NewGN()

    def report(name, lib, cut):
        rows = time_build(kernels(name, lib), cases)
        print(f"{name}: {'timed' if cut else 'within its gates, bit-reproducible'}; "
              + "; ".join(f"{kind} 40 calls {CALLS_A_LEVEL * sum(per):.4f} ms "
                          f"(by level " + ", ".join(f"{v:.4f}" for v in per)
                          + ")" for kind, per in rows.items()), flush=True)
        if name != "old" and hasattr(lib, "gn_phase_cycles"):
            phase_cycles(lib, cases)

    return compare_builds(
        "gn", sources, ("registers", "spill", "Function properties", "error"),
        lambda name, lib: check(kernels(name, lib)), report)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
