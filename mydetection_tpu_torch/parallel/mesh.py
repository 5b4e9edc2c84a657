"""Devices and the batch split for data-parallel inference.

The torch counterparts of `mydetection_tpu/parallel/mesh.py`: where
JAX builds a 1-D `Mesh(('data',))`, shards the batch axis and
replicates the parameters, the port keeps a list of CUDA devices
(`make_mesh`), splits a batch along dim 0 into one chunk a device
(`shard_batch`) and holds one copy of the eval model, or of the int8
tree, on each (`replicate`). Inference is independent per image, so the
split is the whole story: `Detector(data_parallel=True)` runs each
chunk's forward and postprocess on its own device and concatenates the
padded outputs in order. Training across devices is not here.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn


def local_devices() -> list[torch.device]:
    """Every CUDA device of this process, in index order (none without
    a GPU)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None) -> list[torch.device]:
    """The first `n_devices` local devices (None: all of them)."""
    devices = local_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, have "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return devices


def shard_batch(x: torch.Tensor, mesh: list[torch.device]
                ) -> list[tuple[torch.device, torch.Tensor]]:
    """x split along dim 0 into one chunk a device, in order, each on
    its device (`torch.tensor_split`: the first chunks take one more row
    where the batch does not divide); devices whose chunk would be empty
    are left out."""
    chunks = torch.tensor_split(x, len(mesh))
    return [(dev, chunk.to(dev, non_blocking=True))
            for dev, chunk in zip(mesh, chunks) if chunk.shape[0]]


def _on(tree, device: torch.device):
    """`tree` (module, tensor, frozen dataclass, dict, list, tuple or a
    leaf kept as it is) with every tensor on `device`; modules are
    copied and, on the card, put in channels_last memory as the
    Detector keeps its model."""
    if isinstance(tree, nn.Module):
        module = copy.deepcopy(tree).to(device)
        if device.type == "cuda":
            module = module.to(memory_format=torch.channels_last)
        return module
    if torch.is_tensor(tree):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _on(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, device) for v in tree)
    return tree


def replicate(tree, mesh: list[torch.device]) -> list:
    """One copy of `tree` (an eval model or an int8 tree) on each
    device of `mesh`, in order."""
    return [_on(tree, device) for device in mesh]
