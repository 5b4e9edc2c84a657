"""Fused bias + GroupNorm + ReLU: CUDA kernel wrappers, plain versions,
the launch plan, and the autograd Function that pairs the forward with
its backward.

Three wrappers, each over a kernel of `csrc/gn.cu`, each with its plain
version and its launch count:

* `bias_gn_relu` replaces `mydetection_tpu/ops/pallas/gn_kernel.py::
  bias_gn_relu_pallas_impl` (`_gn_kernel`): the inference forward;
* `bias_gn_relu_fwd_stats` replaces `_fwd_with_stats`
  (`_gn_fwd_stats_kernel`): the same forward, also returning the
  per-(image, group) mean and inverse standard deviation;
* `bias_gn_relu_bwd` replaces `_bwd_fused` (`_gn_bwd_kernel`): the
  fused backward from x, the saved y, dy and the saved statistics.

`BiasGNReLU` pairs the last two as `_make_trainable`'s `custom_vjp`
does. On a CUDA tensor each wrapper launches its kernel or raises; only
a CPU tensor takes the plain version, which repeats the kernel's
arithmetic (float32 bias add and sums, the variance as E[x²] − E[x]²
floored at 0, 1/sqrt); the two differ only in the order of the sums.

`gn_plan` is the kernels' launch plan, a pure function of the shape: a
thread block cluster of `cluster` blocks an image, each block holding a
contiguous range of the image's pixels (all C channels) in shared
memory; where no cluster of 16 holds an image, the kernels stream it
through a ring of bulk copies instead.
`gn_ranges` lists the pixels each block owns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from mydetection_tpu_torch.kernels import build

GN_EPS = 1e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256              # csrc/gn.cu kThreads: consumer threads a block
SMEM_LIMIT = 232_448       # csrc/gn.cu kSmemLimit: 227 KB a block on sm_90
MAX_CLUSTER = 16           # the largest (non-portable) cluster on Hopper
SMS = 132                  # an H100 SXM's SMs
FWD_CHUNKS = 4             # bulk copies a resident forward range is cut into
FWD_MIN_CHUNK = 24576      # ... of at least this many bytes each
MIN_SPLIT = 32768          # a forward block of a cluster owns at least this
STAGE_BYTES = 49152        # the most bytes a ring stage holds
STREAM_STAGES = 4          # ring stages where a range does not stay
BWD_STAGES = 3             # ring stages of a resident backward
BWD_GOOD_CHUNK = 16        # pixels a resident backward stage should hold
BWD_MIN_CHUNK = 4          # ... and must
BWD_BLOCKS = 64            # blocks a backward aims for
BWD_MIN_PIXELS = 24        # pixels a backward block of a cluster keeps


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How one GN launch cuts its work; csrc/gn.cu's `Plan` reads these
    nine numbers in this order and refuses a plan its layout disagrees
    with."""
    cluster: int    # blocks an image, 1 to MAX_CLUSTER
    resident: bool  # the block's range (backward: dpre) stays on chip
    chunk: int      # pixels a bulk copy (backward: of each of x, y, dy)
    chunk2: int     # backward pass 2: pixels of x a stage
    stages: int     # ring stages (0: no ring)
    tile: int       # pixels the resident tile holds
    slots: int      # mbarriers
    smem: int       # dynamic shared memory bytes a block
    blocks: int     # the grid

    def as_ints(self) -> ctypes.Array:
        return (ctypes.c_int * 9)(*(int(getattr(self, f.name))
                                     for f in dataclasses.fields(self)))


def _smem_bytes(kind: str, c: int, elem: int, groups: int, *,
                resident: bool, tile: int, stages: int, chunk: int,
                slots: int) -> int:
    """A block's shared memory, region by region as csrc/gn.cu's
    `make_layout` lays it out, each rounded up to 128 bytes: the tile,
    the ring (x; backward x, y and dy), the per-channel parameters, the
    slot reduction, the group partials, the statistics, the backward's
    m1 and m2, and a full and a done mbarrier a slot."""
    row = c * elem
    bwd = kind == "bwd"
    regions = (tile * row if resident else 0,
               stages * (3 if bwd else 1) * chunk * row,
               (2 if bwd else 3) * c * 4,
               THREADS // (row // 16) * c * 4,
               2 * groups * 4,
               2 * groups * 4,
               2 * groups * 4 if bwd else 0,
               slots * 2 * 8)
    return sum(-(-r // 128) * 128 for r in regions)


@functools.lru_cache(maxsize=512)
def gn_plan(kind: str, b: int, hw: int, c: int, groups: int, elem: int,
            sms: int = SMS) -> GNPlan:
    """The launch plan of the forward (`kind` "fwd", with or without the
    statistics) or the backward ("bwd") on (b, hw pixels, c channels)
    of `elem`-byte elements, chosen by measurement on an H100 (PERF.md):
    fewer, larger copies win at every level, as do fewer blocks
    an image at the small levels.

    Forward: the cluster size n is the smallest at which a block's range
    of ceil(hw / n) pixels fits SMEM_LIMIT, in up to FWD_CHUNKS even
    copies of about FWD_MIN_CHUNK bytes or more, raised towards 2 * sms
    blocks in all while each block keeps MIN_SPLIT bytes, then rounded
    to a power of two where that stays within those limits. Backward: n
    is the smallest at which the block's dpre fits beside BWD_STAGES
    ring stages of BWD_GOOD_CHUNK pixels (else MAX_CLUSTER, for the
    largest ring), raised towards BWD_BLOCKS blocks and to a power of
    two while each block keeps BWD_MIN_PIXELS pixels; its stages take up
    to STAGE_BYTES, at least BWD_MIN_CHUNK pixels. Where no cluster of
    16 holds an image the plan streams (`resident` False):
    STREAM_STAGES ring stages, read twice. Raises ValueError for a shape
    the kernels do not take (a pixel row that is not 16 to 16 * THREADS
    bytes in 16-byte steps)."""
    if kind not in ("fwd", "bwd"):
        raise ValueError(f"gn_plan: kind is 'fwd' or 'bwd', got {kind!r}")
    row = c * elem
    if b < 1 or hw < 1 or groups < 1 or c % groups:
        raise ValueError(f"gn_plan: no plan for b={b}, hw={hw}, c={c}, "
                         f"groups={groups}")
    if row % 16 or row // 16 > THREADS:
        raise ValueError(f"GN kernels take a pixel row of 16 to "
                         f"{16 * THREADS} bytes in 16-byte steps: {c} "
                         f"channels of {elem} bytes are {row}")
    bwd = kind == "bwd"
    img = hw * row
    most = min(MAX_CLUSTER, hw)

    def plan(n, resident, chunk, chunk2, stages, tile, slots):
        smem = _smem_bytes(kind, c, elem, groups, resident=resident,
                           tile=tile, stages=stages, chunk=chunk, slots=slots)
        if smem > SMEM_LIMIT:
            return None
        return GNPlan(n, resident, chunk, chunk2, stages, tile, slots, smem,
                      b * n)

    def resident(n, least=BWD_MIN_CHUNK):
        m = -(-hw // n)                 # the most pixels a block
        if not bwd:
            copies = max(1, min(FWD_CHUNKS, m * row // FWD_MIN_CHUNK))
            chunk = -(-m // copies)
            return plan(n, True, chunk, chunk, 0, m, copies)
        for chunk in range(min(m, max(1, STAGE_BYTES // (3 * row))),
                           min(m, least) - 1, -1):
            got = plan(n, True, chunk, 3 * chunk, BWD_STAGES, m, BWD_STAGES)
            if got:
                return got
        return None

    def smallest(**kw):
        return next((n for n in range(1, most + 1) if resident(n, **kw)),
                    None)

    least = smallest()
    if bwd and least:
        n = max(smallest(least=BWD_GOOD_CHUNK) or most, -(-BWD_BLOCKS // b))
        n = min(most, 1 << (n - 1).bit_length(),
                max(least, hw // BWD_MIN_PIXELS))
    else:
        least = least or 1
        cap = max(least, min(most, img // MIN_SPLIT))
        n = max(least, min(-(-2 * sms // b), cap))
        up = 1 << (n - 1).bit_length()
        down = 1 << (n.bit_length() - 1)
        n = up if up <= cap else down if down >= least else n
    got = resident(n)
    if got:
        return got
    chunk = max(1, STAGE_BYTES // (row * (3 if bwd else 1)) // (1 if bwd else 3))
    got = plan(n, False, chunk, chunk, STREAM_STAGES, 0, STREAM_STAGES)
    if got is None:
        raise ValueError(f"gn_plan: {kind} on {c} channels of {elem} bytes "
                         f"does not fit {SMEM_LIMIT} bytes of shared memory")
    return got


def gn_ranges(plan: GNPlan, hw: int) -> list[tuple[int, int, int]]:
    """The pixels each block of `plan` owns, as csrc/gn.cu's
    `block_range` computes them: (image, first pixel, pixels) a block.
    Block i is rank i % n of image i // n's cluster of n blocks; rank r
    owns pixels r * hw // n up to (r + 1) * hw // n."""
    n = plan.cluster
    return [(blk // n, blk % n * hw // n,
             (blk % n + 1) * hw // n - blk % n * hw // n)
            for blk in range(plan.blocks)]


def _params_c(v: torch.Tensor) -> torch.Tensor:
    """A (C,) parameter as a float32 (C, 1, 1) for NCHW broadcasting."""
    return v.float()[:, None, None]


def bias_gn_relu_fwd_stats_plain(x: torch.Tensor, bias: torch.Tensor,
                                 scale: torch.Tensor, shift: torch.Tensor, *,
                                 groups: int = 32
                                 ) -> tuple[torch.Tensor, ...]:
    """(relu(GN(x + bias)·scale + shift) in x's dtype, mean (B, G) f32,
    inv (B, G) f32) for NCHW x of any layout, with float32 per-channel
    bias, scale and shift."""
    b, c, h, w = x.shape
    xf = x.float() + _params_c(bias)
    g = xf.reshape(b, groups, c // groups * h * w)
    n = torch.tensor(np.float32(g.shape[-1]), device=x.device)
    mean = g.sum(dim=-1, keepdim=True) / n
    var = torch.clamp((g * g).sum(dim=-1, keepdim=True) / n - mean * mean,
                      min=0.0)
    inv = 1.0 / torch.sqrt(var + np.float32(GN_EPS))
    y = ((g - mean) * inv).reshape(b, c, h, w)
    y = y * _params_c(scale) + _params_c(shift)
    return torch.relu(y).to(x.dtype), mean[..., 0], inv[..., 0]


def bias_gn_relu_plain(x: torch.Tensor, bias: torch.Tensor,
                       scale: torch.Tensor, shift: torch.Tensor, *,
                       groups: int = 32) -> torch.Tensor:
    """relu(GN(x + bias)·scale + shift) for NCHW x of any layout, with
    float32 per-channel bias, scale and shift; returns x's dtype."""
    return bias_gn_relu_fwd_stats_plain(x, bias, scale, shift,
                                        groups=groups)[0]


def bias_gn_relu_bwd_plain(x: torch.Tensor, y: torch.Tensor,
                           dy: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, mean: torch.Tensor,
                           inv: torch.Tensor, *, groups: int = 32
                           ) -> tuple[torch.Tensor, ...]:
    """The fused backward of `gn_kernel.py::_gn_bwd_kernel`: (dx in x's
    dtype, dbias, dscale, dshift (C,) float32). The ReLU mask is the
    saved output's `y > 0`; the per-channel sums are taken per image and
    then added over the images in image order."""
    b, c, h, w = x.shape
    cpg = c // groups
    mean_c = mean.repeat_interleave(cpg, dim=1)[:, :, None, None]
    inv_c = inv.repeat_interleave(cpg, dim=1)[:, :, None, None]
    xhat = ((x.float() + _params_c(bias)) - mean_c) * inv_c
    dpre = torch.where(y.float() > 0.0, dy.float(), 0.0)
    dxhat = dpre * _params_c(scale)
    n = torch.tensor(np.float32(cpg * h * w), device=x.device)
    m1 = dxhat.reshape(b, groups, -1).sum(dim=-1) / n
    m2 = (dxhat * xhat).reshape(b, groups, -1).sum(dim=-1) / n
    m1 = m1.repeat_interleave(cpg, dim=1)[:, :, None, None]
    m2 = m2.repeat_interleave(cpg, dim=1)[:, :, None, None]
    dxf = inv_c * ((dxhat - m1) - xhat * m2)
    sums = []
    for t in (dxf, dpre * xhat, dpre):
        per_image = t.sum(dim=(2, 3))
        acc = torch.zeros(c, device=x.device)
        for i in range(b):
            acc = acc + per_image[i]
        sums.append(acc)
    return (dxf.to(x.dtype), *sums)


def _check_cuda(name: str, x: torch.Tensor, groups: int, *,
                layout: bool = True, **params: torch.Tensor) -> None:
    """What the kernels take, in checks a fake tensor can answer too: x
    a 4-D float32 or bfloat16 tensor on the card in channels_last
    memory, C split into whole groups, each parameter a contiguous
    float32 (C,) tensor on x's device. `gn_plan` checks the pixel row,
    `_check_aligned` the start. `layout` False skips x's memory layout:
    a traced call's fake strides may disagree with the ones the card
    produces (the launch checks the real ones)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be a 4-D float32 or bfloat16 "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{name}: {c} channels do not split into {groups} "
                         f"groups")
    if layout and not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} reads channels_last (NHWC) memory; got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    for pname, v in params.items():
        if v.shape != (c,) or v.dtype != torch.float32 \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"{name}: {pname} must be a contiguous float32 "
                             f"({c},) tensor on {x.device}, got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _check_aligned(name: str, x: torch.Tensor) -> None:
    """x must start on a 16-byte boundary: bulk copies move 16-byte
    units."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary")


def plan_for(kind: str, x: torch.Tensor, groups: int) -> GNPlan:
    """`gn_plan` for x (B, C, H, W) on its card."""
    b, c, h, w = x.shape
    return gn_plan(kind, b, h * w, c, groups, x.element_size(),
                   build.sm_count(x.device))


def max_active_clusters(kind: str, x: torch.Tensor, groups: int) -> int:
    """How many clusters of `plan_for(kind, x, groups)` can be resident
    on x's card at once (cudaOccupancyMaxActiveClusters of the forward
    or the backward kernel)."""
    b, c, h, w = x.shape
    lib = _library()
    got = lib.gn_max_active_clusters(
        int(kind == "bwd"), b, h * w, c, groups, _DTYPES[x.dtype],
        plan_for(kind, x, groups).as_ints())
    if got < 0:
        raise RuntimeError(f"gn_max_active_clusters failed: "
                           f"{lib.gn_error_string(-got).decode()}")
    return got


def _device_of(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    return x.device.type


def _raise_on(err: int, name: str, lib: ctypes.CDLL) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.gn_error_string(err).decode()}")


def _launch_fwd(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor, out: torch.Tensor,
                stats: tuple[torch.Tensor, torch.Tensor] | None,
                groups: int, plan: GNPlan) -> None:
    """One forward launch on `plan` (with `stats`, the (mean, inv)
    outputs, the statistics variant); raises if the library refuses it."""
    b, c, h, w = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (x.data_ptr(), bias.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), out.data_ptr())
        tail = (b, h * w, c, groups, GN_EPS, _DTYPES[x.dtype],
                plan.as_ints(), stream)
        if stats is None:
            name = "bias_gn_relu"
            err = lib.bias_gn_relu_launch(*head, *tail)
        else:
            name = "bias_gn_relu_fwd_stats"
            err = lib.bias_gn_relu_fwd_stats_launch(
                *head, stats[0].data_ptr(), stats[1].data_ptr(), *tail)
    _raise_on(err, name, lib)


def bias_gn_relu(x: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, *, groups: int = 32) -> torch.Tensor:
    """y = relu(GN(x + bias)·scale + shift), x NCHW (B, C, H, W), eps 1e-5.

    CPU tensors run `bias_gn_relu_plain`. CUDA tensors call the custom
    op `mydet::bias_gn_relu` (`kernels.ops`), whose CUDA implementation
    `bias_gn_relu_launch` launches the kernel on `gn_plan`'s clusters and
    counts the launch: x float32 or bfloat16 in channels_last memory
    (NHWC, as the convs emit it on the card), bias/scale/shift float32
    (C,). The output has x's dtype and layout.
    """
    if _device_of("bias_gn_relu", x) == "cpu":
        return bias_gn_relu_plain(x, bias, scale, shift, groups=groups)
    return torch.ops.mydet.bias_gn_relu(x, bias, scale, shift, groups)


def bias_gn_relu_launch(x: torch.Tensor, bias: torch.Tensor,
                        scale: torch.Tensor, shift: torch.Tensor,
                        groups: int) -> torch.Tensor:
    """The CUDA implementation of `mydet::bias_gn_relu`: one launch of
    csrc/gn.cu's forward, counted on `bias_gn_relu.launches`."""
    _check_cuda("bias_gn_relu", x, groups, bias=bias, scale=scale,
                shift=shift)
    _check_aligned("bias_gn_relu", x)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    if x.numel() == 0:
        return out
    _launch_fwd(x, bias, scale, shift, out, None, groups,
                plan_for("fwd", x, groups))
    bias_gn_relu.launches += 1
    return out


def bias_gn_relu_fake(x: torch.Tensor, bias: torch.Tensor,
                      scale: torch.Tensor, shift: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """`mydet::bias_gn_relu`'s output for a traced call."""
    _check_cuda("bias_gn_relu", x, groups, layout=False, bias=bias,
                scale=scale, shift=shift)
    return torch.empty_like(x, memory_format=torch.channels_last)


bias_gn_relu.launches = 0


def bias_gn_relu_fwd_stats(x: torch.Tensor, bias: torch.Tensor,
                           scale: torch.Tensor, shift: torch.Tensor, *,
                           groups: int = 32) -> tuple[torch.Tensor, ...]:
    """`bias_gn_relu` that also returns the statistics the backward
    needs: (y, mean (B, G) f32, inv (B, G) f32). CPU tensors run
    `bias_gn_relu_fwd_stats_plain`; CUDA tensors launch the forward
    kernel's statistics variant and count the launch."""
    if _device_of("bias_gn_relu_fwd_stats", x) == "cpu":
        return bias_gn_relu_fwd_stats_plain(x, bias, scale, shift,
                                            groups=groups)
    _check_cuda("bias_gn_relu_fwd_stats", x, groups, bias=bias, scale=scale,
                shift=shift)
    _check_aligned("bias_gn_relu_fwd_stats", x)
    b = x.shape[0]
    out = torch.empty_like(x, memory_format=torch.channels_last)
    mean = torch.empty(b, groups, device=x.device)
    inv = torch.empty(b, groups, device=x.device)
    if x.numel() == 0:
        return out, mean, inv
    _launch_fwd(x, bias, scale, shift, out, (mean, inv), groups,
                plan_for("fwd", x, groups))
    bias_gn_relu_fwd_stats.launches += 1
    return out, mean, inv


bias_gn_relu_fwd_stats.launches = 0


def _launch_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                bias: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                inv: torch.Tensor, dx: torch.Tensor, sums: torch.Tensor,
                groups: int, plan: GNPlan) -> None:
    """One backward call on `plan` (the kernel, then the sum of its
    per-block channel partials); raises if the library refuses it."""
    b, c, h, w = x.shape
    part = torch.empty(3, b, plan.cluster, c, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bias_gn_relu_bwd_launch(
            x.data_ptr(), y.data_ptr(), dy.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), mean.data_ptr(), inv.data_ptr(), dx.data_ptr(),
            part.data_ptr(), sums.data_ptr(), b, h * w, c, groups,
            _DTYPES[x.dtype], plan.as_ints(), stream)
    _raise_on(err, "bias_gn_relu_bwd", lib)


def bias_gn_relu_bwd(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                     bias: torch.Tensor, scale: torch.Tensor,
                     mean: torch.Tensor, inv: torch.Tensor, *,
                     groups: int = 32) -> tuple[torch.Tensor, ...]:
    """The fused backward: (dx in x's dtype and layout, dbias, dscale,
    dshift (C,) float32). CPU tensors run `bias_gn_relu_bwd_plain`; CUDA
    tensors launch the backward kernel on `gn_plan`'s clusters, then one
    small kernel that adds the per-block channel sums over each image's
    blocks and then over the images, in order, and count one launch. x,
    y and dy have one dtype and shape, x and y channels_last; mean and
    inv are (B, G) float32."""
    if _device_of("bias_gn_relu_bwd", x) == "cpu":
        return bias_gn_relu_bwd_plain(x, y, dy, bias, scale, mean, inv,
                                      groups=groups)
    _check_cuda("bias_gn_relu_bwd", x, groups, bias=bias, scale=scale)
    _check_aligned("bias_gn_relu_bwd", x)
    b, c, h, w = x.shape
    for name, t in (("y", y), ("dy", dy)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"bias_gn_relu_bwd: {name} must match x's "
                             f"shape {tuple(x.shape)} and dtype {x.dtype} "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if not y.is_contiguous(memory_format=torch.channels_last) \
            or y.data_ptr() % 16:
        raise ValueError("bias_gn_relu_bwd reads channels_last (NHWC) "
                         f"memory from a 16-byte boundary; y has strides "
                         f"{y.stride()}")
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (b, groups) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"bias_gn_relu_bwd: {name} must be a contiguous "
                             f"float32 ({b}, {groups}) tensor on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    # autograd hands the gradient over in whatever layout the consumer's
    # backward produced; the kernel reads NHWC from a 16-byte boundary,
    # so this is a layout change (a copy when needed), not a fallback
    dy = dy.contiguous(memory_format=torch.channels_last)
    if dy.data_ptr() % 16:
        dy = dy.clone(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    sums = torch.empty(3, c, device=x.device)
    if x.numel() == 0:
        return dx, *torch.zeros(3, c, device=x.device)
    _launch_bwd(x, y, dy, bias, scale, mean, inv, dx, sums, groups,
                plan_for("bwd", x, groups))
    bias_gn_relu_bwd.launches += 1
    return dx, sums[0], sums[1], sums[2]


bias_gn_relu_bwd.launches = 0


class BiasGNReLU(torch.autograd.Function):
    """Differentiable relu(GN(x + bias)·scale + shift): the port of
    `gn_kernel.py::_make_trainable`. The forward runs
    `bias_gn_relu_fwd_stats` and saves what the JAX residuals hold (x
    before the bias, y, bias, scale, mean, inv); the backward runs
    `bias_gn_relu_bwd`. Each is the CUDA kernel on the card and the plain
    version on the CPU."""

    @staticmethod
    def forward(ctx, x, bias, scale, shift, groups):
        y, mean, inv = bias_gn_relu_fwd_stats(x, bias, scale, shift,
                                              groups=groups)
        ctx.save_for_backward(x, y, bias, scale, mean, inv)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y, bias, scale, mean, inv = ctx.saved_tensors
        dx, dbias, dscale, dshift = bias_gn_relu_bwd(
            x, y, dy, bias, scale, mean, inv, groups=ctx.groups)
        return dx, dbias, dscale, dshift, None


def _library() -> ctypes.CDLL:
    lib = build.load("gn")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bias_gn_relu_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p, p]
    lib.bias_gn_relu_fwd_stats_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, f, i, p, p]
    lib.bias_gn_relu_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, p]
    lib.gn_max_active_clusters.argtypes = [i, i, i, i, i, i, p]
    lib.gn_max_active_clusters.restype = ctypes.c_int
    for fn in (lib.bias_gn_relu_launch, lib.bias_gn_relu_fwd_stats_launch,
               lib.bias_gn_relu_bwd_launch):
        fn.restype = ctypes.c_int
    lib.gn_error_string.argtypes = [ctypes.c_int]
    lib.gn_error_string.restype = ctypes.c_char_p
    return lib
