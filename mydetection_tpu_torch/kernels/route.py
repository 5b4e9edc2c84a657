"""Which version of each kernel the model and postprocess call.

By default every call site takes the hand-written kernel's wrapper,
which runs the kernel on a CUDA tensor and its plain version on a CPU
tensor. Inside `plain_versions()` the call sites take the plain versions
on every device instead: the port of the JAX package's
`use_pallas=False`, which restores its oracle path. Only a caller
chooses it (`Detector(use_pallas=False)`, `export --oracle-nms`); no
code path falls back to it. The choice is per thread, so a serving
thread and a training thread do not see each other's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def kernels_enabled() -> bool:
    """False inside `plain_versions()` on this thread."""
    return not getattr(_state, "plain", False)


def takes_kernel(module: torch.nn.Module, x: torch.Tensor) -> bool:
    """Whether `module`'s forward on x takes a hand-written kernel: x on
    the card, eval mode, no gradient needed, and the kernels not routed
    to their plain versions on this thread."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))
    return (x.device.type == "cuda" and not module.training
            and not needs_grad and kernels_enabled())


def pick(kernel, plain):
    """`kernel` unless this thread is inside `plain_versions()`."""
    return kernel if kernels_enabled() else plain


@contextlib.contextmanager
def plain_versions(active: bool = True):
    """Route every kernel call site on this thread to its plain version
    for the duration (no-op when `active` is False)."""
    saved = getattr(_state, "plain", False)
    _state.plain = saved or active
    try:
        yield
    finally:
        _state.plain = saved
