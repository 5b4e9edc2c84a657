"""Devices, the batch split and the cross-replica reductions for
data-parallel inference and training.

The torch counterparts of `mydetection_tpu/parallel/mesh.py`: where
JAX builds a 1-D `Mesh(('data',))`, shards the batch axis and
replicates the parameters, the port keeps a list of devices
(`make_mesh`), splits a batch along dim 0 into one chunk a device
(`shard_batch`) and holds one copy of a model, or of the int8 tree, on
each (`replicate`). A list may name one device twice: two replicas
then share it, as JAX's virtual devices share a host.

Inference is independent per image, so the split is the whole story:
`Detector(data_parallel=True)` runs each chunk's forward and
postprocess on its own device and concatenates the padded outputs in
order. Training is one global step (`training.DataParallelTrainStep`):
every reduction over the batch spans the replicas, as the reductions
XLA inserts into the JAX step do. `lockstep` runs one function a
replica, one replica at a time, and `ReplicaGroup.all_sum` is where
they meet: each sum is taken once, on the first replica's device in
replica order (`cross_replica_sum`), and every replica gets the same
bits. The sums are tensor ops, so autograd carries the backward pass
across them. `broadcast` copies one replica's tensors to the others
after the update.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import queue
import threading
from typing import Callable, Sequence

import torch
from torch import nn


_state = threading.local()


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


def replica_sum(tensors: Sequence[torch.Tensor],
                device: torch.device) -> torch.Tensor:
    """Σ tensors[r], one per replica, added on `device` in replica
    order."""
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


def cross_replica_sum(tensors: Sequence[torch.Tensor],
                      devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """`replica_sum` on devices[0], then one copy on each of `devices`
    (the same tensor where a device is the first one), so every replica
    sees the same bits. Differentiable: the backward sums the copies'
    gradients and hands each replica its share."""
    total = replica_sum(tensors, devices[0])
    return [total.to(d) for d in devices]


@torch.no_grad()
def broadcast(src: Sequence[torch.Tensor],
              dsts: Sequence[Sequence[torch.Tensor]]) -> None:
    """Copy `src` into each list of `dsts`, entry by entry, in place."""
    for dst in dsts:
        torch._foreach_copy_(list(dst), list(src))


_DIVERGED = "the replicas took different sequences of cross-replica sums"


class _Aborted(Exception):
    """Raised in a replica's thread when another replica failed."""


class ReplicaGroup:
    """The replicas of one data-parallel forward. `lockstep` runs each
    replica's function in a thread of its own; only the replica whose
    turn it is runs, and the turn moves on, in replica order, at each
    `all_sum` and when a replica's function returns. So the replicas
    take their turns as one thread would (no two launch at once, and
    the launch order is fixed), and a sum waits for every replica."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._cond = threading.Condition()
        self._turn = 0
        self._slots: list = [None] * len(self.devices)
        self._result: list = [None] * len(self.devices)
        self._done = [False] * len(self.devices)
        self._sums = 0
        self.error: BaseException | None = None

    def all_sum(self, rank: int, values: list) -> list:
        """Called by every replica with lists of one structure: each
        tensor entry is summed over the replicas by `cross_replica_sum`
        and each number by `sum`. Returns replica `rank`'s copy."""
        n = len(self.devices)
        with self._cond:
            start = self._sums
            self._slots[rank] = values
            if any(self._done) or (rank == n - 1 and len(
                    {len(v) for v in self._slots}) != 1):
                raise RuntimeError(_DIVERGED)
            if rank == n - 1:
                entries = []
                for i, first in enumerate(self._slots[0]):
                    col = [v[i] for v in self._slots]
                    entries.append(cross_replica_sum(col, self.devices)
                                   if torch.is_tensor(first) else [sum(col)] * n)
                self._result = [[e[r] for e in entries] for r in range(n)]
                self._slots = [None] * n
                self._sums += 1
            self._pass(rank)
            self._wait(rank)
            if self._sums == start:     # a later replica returned instead
                raise RuntimeError(_DIVERGED)
            return self._result[rank]

    def _pass(self, rank: int) -> None:
        self._turn = (rank + 1) % len(self.devices)
        self._cond.notify_all()

    def _wait(self, rank: int) -> None:
        while self._turn != rank and self.error is None:
            self._cond.wait()
        if self.error is not None:
            raise _Aborted

    def _run(self, rank: int, fn: Callable, out: list) -> None:
        _state.replica = (self, rank)
        try:
            with self._cond:
                self._wait(rank)
            device = self.devices[rank]
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                out[rank] = fn()
            with self._cond:
                self._done[rank] = True
                self._pass(rank)
        except _Aborted:
            pass
        except BaseException as e:  # noqa: BLE001  handed to lockstep
            with self._cond:
                if self.error is None:
                    self.error = e
                self._cond.notify_all()
        finally:
            _state.replica = None


def replica_group() -> tuple[ReplicaGroup, int] | None:
    """(group, rank) inside a replica's function under `lockstep`, None
    elsewhere."""
    return getattr(_state, "replica", None)


class _Worker(threading.Thread):
    """A thread that runs replica r of every `lockstep` call. It lives
    as long as the process: torch keeps per-thread caches (cuDNN's
    execution plans among them), which a thread made afresh for each
    call would rebuild at every forward."""

    def __init__(self, rank: int):
        super().__init__(name=f"replica-{rank}", daemon=True)
        self.jobs: queue.SimpleQueue = queue.SimpleQueue()
        self.start()

    def run(self) -> None:
        while True:
            job, done = self.jobs.get()
            job()
            done.release()


_workers: list[_Worker] = []
_lockstep_lock = threading.Lock()


def lockstep(devices: Sequence[torch.device],
             fns: Sequence[Callable]) -> list:
    """Run fns[r]() as replica r of one `ReplicaGroup` over `devices`
    (each under its CUDA device, on the r-th of the process's replica
    threads) and return their results in order; the first exception a
    replica raised is raised here. One call runs at a time."""
    if len(fns) != len(devices):
        raise ValueError(f"{len(fns)} functions for {len(devices)} devices")
    group = ReplicaGroup(devices)
    out: list = [None] * len(fns)
    done = threading.Semaphore(0)
    with _lockstep_lock:
        while len(_workers) < len(fns):
            _workers.append(_Worker(len(_workers)))
        for r, fn in enumerate(fns):
            _workers[r].jobs.put((functools.partial(group._run, r, fn, out),
                                  done))
        for _ in fns:
            done.acquire()
    if group.error is not None:
        raise group.error
    return out
