"""Independent streams from one `--seed`: weights, inputs and the
sample that the check reads each get their own generator, so that
adding a draw to one does not move another."""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream`, from any whole-number `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def torch_gen(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, stream))
