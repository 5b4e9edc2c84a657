"""The yardstick: published peaks, the least time a kernel's work needs
on these shapes, FLOPs counted on the reference, and the reduction of a
profiler trace to busy time, kernel time and idle gaps.

Nothing here reads a number that the program reports about itself: the
shapes come from the configuration, the NMS work from the reference's
own candidates, the FLOPs from the reference model.
"""

from __future__ import annotations

from types import ModuleType

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.boxes import pairwise_iou

# NVIDIA H100 SXM data sheet, dense rates (700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989.4e12
FP32_FLOPS = 67e12
OPS_PER_IOU = 12            # min/max x4, sub x2, clamp x2, mul, add, sub, div
OPS_PER_GN_ELEMENT = 9      # bias add, sum, square, sum; sub, x inv, x scale, + shift, max
OPS_PER_GN_BWD_ELEMENT = 16
GN_GROUPS = 32
BF16 = 2


def least_ms(nbytes: float, ops: float, rate: float) -> float:
    """The larger of bytes over HBM rate and operations over `rate`, ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3


def greedy_pairs(iou: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor, iou_thres: float) -> int:
    """The (kept i, later j) IoUs greedy NMS must compute on these
    inputs: each valid box against the kept boxes before it, up to its
    first suppressor."""
    k = iou.shape[-1]
    kept = keep.long()
    rank = torch.cumsum(kept, dim=1)
    sup = ((iou > np.float32(iou_thres)) & keep[:, :, None]
           & torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1))
    first = sup.to(torch.uint8).argmax(dim=1)
    tested = torch.where(sup.any(dim=1), torch.gather(rank, 1, first),
                         rank - kept)
    return int((tested * valid.long()).sum())


def nms_bound_ms(boxes: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor, iou_thres: float) -> float:
    """Least time for one batch's keep-mask: boxes (B, K, 4) float32
    and valid read once, keep written once, against the IoUs greedy
    needs here (from the reference's candidates and keep) over the fp32
    rate."""
    b, k, _ = boxes.shape
    nbytes = boxes.numel() * 4 + 2 * valid.numel()
    pairs = greedy_pairs(pairwise_iou(boxes, boxes), valid, keep, iou_thres)
    return least_ms(nbytes, pairs * OPS_PER_IOU + 3 * b * k, FP32_FLOPS)


def fcos_gn_shapes(batch: int, size: int, channels: int = 256
                   ) -> list[tuple[int, int, int, int]]:
    """(B, C, H, W) of FCOS's 40 tower GroupNorms: 8 a pyramid level."""
    shapes = []
    for stride in (8, 16, 32, 64, 128):
        side = -(-size // stride)
        shapes += [(batch, channels, side, side)] * 8
    return shapes


def gn_bound_ms(shapes, *, train: bool = False) -> float:
    """Least time for bias + GN + ReLU over bf16 (B, C, H, W) maps: the
    forward reads x and writes y once, reads bias, scale and shift;
    `train` adds its saved (B, G) mean and inv and the fused backward
    (x, y, dy read, dx written, bias, scale, mean, inv read, three (C,)
    gradients written), against OPS_PER_GN_ELEMENT (+ the backward's
    OPS_PER_GN_BWD_ELEMENT) an element over the fp32 rate. Each call is
    bounded alone and the bounds summed."""
    total = 0.0
    for b, c, h, w in shapes:
        n = b * c * h * w
        stats = 2 * b * GN_GROUPS * 4
        total += least_ms(2 * n * BF16 + 3 * c * 4 + (stats if train else 0),
                          OPS_PER_GN_ELEMENT * n, FP32_FLOPS)
        if train:
            total += least_ms(4 * n * BF16 + 5 * c * 4 + stats,
                              OPS_PER_GN_BWD_ELEMENT * n, FP32_FLOPS)
    return total


def resnet_fused_blocks(batch: int, size: int) -> list[tuple[int, ...]]:
    """(B, c_in, H, W, c_mid, c_out, projection) of ResNet-50's stride-1
    bottlenecks of stages 0 and 1 (stage 0's three, stage 1's last
    three): the blocks the fused bottleneck computes."""
    s0, s1 = size // 4, size // 8
    return ([(batch, 64, s0, s0, 64, 256, True)]
            + [(batch, 256, s0, s0, 64, 256, False)] * 2
            + [(batch, 512, s1, s1, 128, 512, False)] * 3)


def bottleneck_bound_ms(blocks) -> float:
    """Least time for these bf16 bottleneck blocks: 2·B·H·W·(c_in·c_mid +
    9·c_mid² + c_mid·c_out [+ c_in·c_out]) over the bf16 tensor rate,
    against x read and the output written once and the BN-folded bf16
    weights and float32 biases read once. Each block is bounded alone
    and the bounds summed."""
    total = 0.0
    for b, c_in, h, w, c_mid, c_out, proj in blocks:
        k = c_in * c_mid + 9 * c_mid * c_mid + c_mid * c_out
        biases = 2 * c_mid + c_out
        if proj:
            k += c_in * c_out
            biases += c_out
        nbytes = (b * h * w * (c_in + c_out) + k) * BF16 + biases * 4
        total += least_ms(nbytes, 2 * b * h * w * k, BF16_FLOPS)
    return total


def flops_per_image(family: ModuleType, num_classes: int, size: int, *,
                    train: bool, batch: int = 2) -> float:
    """Convolution and matmul FLOPs an image of `family`'s reference model
    (families/<family>.py), counted by FlopCounterMode on the meta
    device; `train` counts the loss's forward and the backward too."""
    with torch.device("meta"):
        model = family.build(num_classes)
        images = torch.zeros((batch, size, size, 3), dtype=torch.uint8)
        with FlopCounterMode(display=False) as counter:
            if train:
                model.train()
                m = 4
                boxes = torch.full((batch, m, 4), size / 4.0)
                classes = torch.zeros((batch, m), dtype=torch.int64)
                valid = torch.ones((batch, m), dtype=torch.bool)
                terms = family.loss(model, images, boxes, classes, valid)
                terms["total"].backward()
            else:
                with torch.no_grad():
                    model.eval()(images)
    return counter.get_total_flops() / batch


# -- profiler traces --------------------------------------------------------

def _innermost(host: list[tuple[int, int, str]], points: list[int]
               ) -> list[str]:
    """For each of the sorted `points`, the name of the latest-starting
    host event that spans it (host events of one thread nest), by one
    sweep over the events in order of start."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host event: host code)")
    return out


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def reduce_trace(events) -> dict:
    """The events of a profiled stretch → {"busy_s", "window_s",
    "kernels": {name: (seconds, launches)}, "device_ops": [[name, s]]
    top 10, "idle_gaps": [[host op, s]] top 10}. The window runs from the
    first device activity (kernel, copy, set) to the end of the last,
    busy time is the union of their intervals, and an idle gap is named
    by the innermost host event (on the card, a CUDA runtime call) that
    spans its middle. Annotations
    (`record_function` spans mirrored on the device's timeline) are no
    device activity."""
    dev, host = [], []
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not _annotation(e):
                dev.append((s, s + d, e.name()))
        else:
            host.append((s, s + d, e.name()))
    if not dev:
        return None
    busy = _union([(s, e) for s, e, _ in dev])
    kernels: dict[str, list] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    gaps: dict[str, float] = {}
    edges = [x for iv in busy for x in iv][1:-1]
    spans = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), label in zip(spans, _innermost(host, [(a + b) // 2
                                                      for a, b in spans])):
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    top = sorted(((n, v[0]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (busy[-1][1] - busy[0][0]) / 1e9,
            "kernels": {n: tuple(v) for n, v in kernels.items()},
            "device_ops": [[n[:200], s] for n, s in top[:10]],
            "idle_gaps": [[n[:200], s] for n, s in
                          sorted(gaps.items(), key=lambda x: -x[1])[:10]]}


def _annotation(e) -> bool:
    try:
        if e.is_user_annotation():
            return True
    except AttributeError:
        pass
    return e.name().startswith("portbench.")


def kernel_seconds(trace: dict, *substrings: str) -> tuple[float, int]:
    """Summed device seconds and launches of the kernels whose name holds
    any of `substrings`."""
    secs, n = 0.0, 0
    for name, (s, k) in trace["kernels"].items():
        if any(sub in name for sub in substrings):
            secs += s
            n += k
    return secs, n
