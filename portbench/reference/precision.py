"""The precision the reference computes in.

The reference is float32 (TF32 off). The control of `correct`, the
step below the bf16 that the configurations state, is the same
reference computed in fp8 as fp8 training stores its tensors: every
conv's input, weight and output and every normalisation's output
rounded to e4m3, and the gradient that reaches each conv's and
normalisation's output to e5m2, each at one scale a tensor from its
largest magnitude.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
_KIND: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "reference_precision", default=None)


@contextlib.contextmanager
def lowered(kind: str | None = "fp8"):
    """Inside, every reference conv rounds its operands to `kind`
    ("fp8"; None: float32)."""
    if kind not in (None, "fp8"):
        raise ValueError(f"unknown reference precision {kind!r}")
    token = _KIND.set(kind)
    try:
        yield
    finally:
        _KIND.reset(token)


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / t.abs().amax().clamp(min=1e-12)
    return (t * scale).to(dtype).float() / scale


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to e4m3 at one scale for the tensor; the gradient
    passes straight through."""
    d = t.detach()
    return t + (_round(d, torch.float8_e4m3fn, E4M3_MAX) - d)


class _Fp8Tensor(torch.autograd.Function):
    """y rounded to e4m3, its gradient to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _round(y, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def round_operands(x: torch.Tensor, w: torch.Tensor):
    if _KIND.get() is None:
        return x, w
    return to_fp8(x), to_fp8(w)


def stored(y: torch.Tensor) -> torch.Tensor:
    """An activation as the precision stores it (and its gradient)."""
    return y if _KIND.get() is None else _Fp8Tensor.apply(y)
