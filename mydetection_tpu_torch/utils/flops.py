"""FLOP accounting and MFU.

The port of `mydetection_tpu/utils/flops.py`. Where the JAX module asks
XLA's cost model, `compiled_flops` runs the function once under
`torch.utils.flop_counter.FlopCounterMode`, which counts the matrix
products and convolutions that actually run, by their shapes. The
card's conv kernels (`mydet::conv3x3_chain`, `mydet::fused_bottleneck`)
count the FLOPs of the convolutions they fuse (`kernels.ops`), so the
count is the same with the kernels as with their plain versions.
Elementwise work, the NMS and the gathers count 0, as there.

MFU = achieved FLOP/s ÷ the card's peak for the dtype, from a table of
published specs keyed by `torch.cuda.get_device_name()`; a card not in
the table gives None rather than a guessed denominator.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

# card name (lowercased substring, the most specific first) -> dense
# peak FLOP/s (int8: OP/s) by dtype, from NVIDIA's H100 and H200 data
# sheets (the sparse rates halved)
_PEAKS: tuple[tuple[str, dict[str, float]], ...] = (
    ("h100 pcie", {"bfloat16": 756.5e12, "float16": 756.5e12,
                   "int8": 1513e12, "float32": 51.2e12}),
    ("h100 nvl", {"bfloat16": 835.5e12, "float16": 835.5e12,
                  "int8": 1670.5e12, "float32": 60e12}),
    ("h100", {"bfloat16": 989.4e12, "float16": 989.4e12,
              "int8": 1978.9e12, "float32": 66.9e12}),
    ("h200", {"bfloat16": 989.4e12, "float16": 989.4e12,
              "int8": 1978.9e12, "float32": 66.9e12}),
)


def compiled_flops(fn: Callable, *args: Any, **kwargs: Any) -> float | None:
    """Total FLOPs of one call of `fn(*args, **kwargs)`, counted by
    `FlopCounterMode` (the call runs once, without gradients), or None
    when nothing it ran is counted."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def device_peak_flops(dtype: str | torch.dtype = "bfloat16") -> float | None:
    """Peak FLOP/s of CUDA device 0 for `dtype`, or None without a card
    or for a card not in the table (never a guessed denominator)."""
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0).lower()
    dtype = str(dtype).replace("torch.", "")
    for key, peaks in _PEAKS:
        if key in name:
            return peaks.get(dtype)
    return None


def mfu(flops_per_item: float | None, items_per_sec: float,
        dtype: str | torch.dtype = "bfloat16") -> float | None:
    """Model-FLOPs utilization in [0, 1], or None when either the FLOPs
    or the peak is unknown."""
    peak = device_peak_flops(dtype)
    if not flops_per_item or not peak:
        return None
    return flops_per_item * items_per_sec / peak
