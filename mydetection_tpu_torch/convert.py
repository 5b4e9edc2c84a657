"""Weight bridge: a flat JAX parameter tree → the port's state_dict.

The JAX package stores params as a nested dict flattened with
`checkpoint.SEP` (`backbone/stage2/res0/conv1/conv/w`, `head/head3/out/b`,
...). The port's modules are named after that tree, so a key maps by
joining with "." and renaming the leaves `w` → `weight` (HWIO → OIHW)
and `b` → `bias`; BatchNorm's `scale`/`bias`/`mean`/`var` keep their
names. `load_state_dict(strict=True)` then checks the keys both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from mydetection_tpu_torch.checkpoint import SEP


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        *path, leaf = key.split(SEP)
        arr = np.array(arr, np.float32)  # a writable copy
        if leaf == "w":
            if arr.ndim != 4:
                raise ValueError(f"{key}: expected an HWIO conv weight, "
                                 f"got shape {arr.shape}")
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "b":
            leaf = "bias"
        sd[".".join([*path, leaf])] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return sd
