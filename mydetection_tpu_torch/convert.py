"""Weight bridge: a flat JAX parameter tree ↔ the port's state_dict.

The JAX package stores params as a nested dict flattened with
`checkpoint.SEP` (`backbone/stage2/res0/conv1/conv/w`, `head/head3/out/b`,
...). The port's modules are named after that tree, so a key maps by
joining with "." and renaming the leaves `w` → `weight` (HWIO → OIHW)
and `b` → `bias`; BatchNorm's `scale`/`bias`/`mean`/`var` keep their
names. `load_state_dict(strict=True)` then checks the keys both ways.
`to_jax_params` is the inverse map, and `to_jax_opt` writes the train
step's velocity as the JAX optimizer tree.
"""

from __future__ import annotations

import numpy as np
import torch

from mydetection_tpu_torch.checkpoint import SEP, unflatten_tree


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


def to_jax_params(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state_dict (parameters and BN running statistics) →
    the flat JAX tree, float32 numpy; the inverse of `from_jax_params`.
    A conv's OIHW `weight` becomes HWIO `w` and its `bias` (a `bias`
    beside a `weight`) becomes `b`; every other leaf keeps its name."""
    flat: dict[str, np.ndarray] = {}
    for name, t in state.items():
        *path, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{name}: expected an OIHW conv weight, "
                                 f"got shape {arr.shape}")
            leaf, arr = "w", arr.transpose(2, 3, 1, 0)
        elif leaf == "bias" and ".".join([*path, "weight"]) in state:
            leaf = "b"
        flat[SEP.join([*path, leaf])] = np.ascontiguousarray(arr)
    return flat


def to_jax_opt(velocity: dict[str, torch.Tensor],
               state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A train step's velocity → the flat JAX `opt` tree, which has the
    params tree's structure, BN `mean`/`var` included. The port keeps
    no velocity for those buffers, so their leaves are zeros here and
    are ignored when a checkpoint resumes. That loses nothing that
    survives a step: the JAX step's `tree_merge` overwrites `mean`/`var`
    with the batch statistics after every SGD update, so their velocity
    never reaches a parameter."""
    return to_jax_params({k: velocity[k] if k in velocity
                          else torch.zeros_like(t) for k, t in state.items()})


def model_tree(model: torch.nn.Module) -> dict:
    """The model's state as the nested JAX tree: what an importer fills,
    what a checkpoint stores, what `check_params_compatible` expects."""
    return unflatten_tree(to_jax_params(model.state_dict()))
