"""Training: SGD with momentum and weight decay, the burn-in schedule,
and the train step.

A port of `mydetection_tpu/training.py`. The JAX step is a pure jitted
function of (params, velocity, batch, lr); here the step owns the model
and its velocity and updates both in place. What it computes is the
same: the family's loss on a uint8 batch with batch-statistics
BatchNorm, its gradients, and `sgd_update` on every parameter (conv
weights and biases, BatchNorm and GroupNorm scales and biases, FCOS's
per-level `scales`). BatchNorm running statistics are buffers: they
get only the batch-statistics update, which the JAX step's
`tree_merge` writes over its SGD update of them, so the values agree.
`TrainStep.save` and `TrainStep.resume` write and read the JAX
package's `.npz` checkpoints (params, the velocity as its `opt` tree,
the step), so a run started in either package resumes in the other.

`make_train_step(..., mesh=devices)` with more than one device is the
JAX step under a mesh (`DataParallelTrainStep`): the parameters on
every device, the batch split along dim 0, and one global step, whose
BatchNorm statistics, loss normalisers and gradients span every
replica (`parallel/mesh.py`).

Under `utils.profiling.recording()` the phases record the spans
`train.batch` (which opens the step's id), `train.forward` (holding
`registry.loss_sums`' `train.model` and `train.loss`),
`train.backward` and `train.update`.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from mydetection_tpu_torch import checkpoint as ckpt_lib
from mydetection_tpu_torch import registry
from mydetection_tpu_torch.convert import (
    from_jax_params,
    model_tree,
    to_jax_opt,
)
from mydetection_tpu_torch.kernels.route import kernels_enabled, plain_versions
from mydetection_tpu_torch.parallel import mesh as mesh_lib
from mydetection_tpu_torch.utils.profiling import span


def sgd_init(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Zero velocity for each parameter."""
    return {k: torch.zeros_like(p) for k, p in params.items()}


@torch.no_grad()
def sgd_update(params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor],
               velocity: dict[str, torch.Tensor], *, lr: float,
               momentum: float = 0.9, weight_decay: float = 5e-4) -> None:
    """In place, for every entry: v ← m·v + g + wd·p, summed left to
    right as the JAX expression is (not m·v + (g + wd·p), as
    `torch.optim.SGD` associates it), then p ← p − lr·v."""
    names = list(params)
    ps = [params[k] for k in names]
    vs = [velocity[k] for k in names]
    torch._foreach_mul_(vs, momentum)
    torch._foreach_add_(vs, [grads[k] for k in names])
    torch._foreach_add_(vs, torch._foreach_mul(ps, weight_decay))
    torch._foreach_sub_(ps, torch._foreach_mul(vs, lr))


def burn_in_lr(step, *, base_lr: float, burn_in: int = 1000,
               milestones: tuple[int, ...] = (), gamma: float = 0.1) -> float:
    """Darknet burn-in: base_lr·(step/burn_in)⁴ during the warm-up, then
    a step decay by `gamma` at each milestone. Host Python: the step
    takes the result as a float."""
    step_f = float(step)
    warm = base_lr * min(step_f / burn_in, 1.0) ** 4
    decay = 1.0
    for m in milestones:
        if step_f >= m:
            decay *= gamma
    return warm * decay


class TrainStep:
    """One SGD step of `model` per call on a batch of `input_size`²
    images. The phases are methods of their own so a caller can time
    them: `batch` (to the device), `forward` (the loss terms),
    `backward` (the gradients), `update` (SGD)."""

    def __init__(self, model: nn.Module, *, input_size: int,
                 momentum: float, weight_decay: float,
                 device: torch.device):
        self.model = model
        self.input_size = input_size
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.device = device
        self.params = dict(model.named_parameters())
        self.velocity = sgd_init(self.params)

    def at_size(self, input_size: int) -> "TrainStep":
        """This step for another input-size bucket, on the same model and
        velocity."""
        registry.check_input_size(input_size)
        step = copy.copy(self)
        step.input_size = input_size
        return step

    def batch(self, images_u8, gt_boxes, gt_classes, gt_valid
              ) -> tuple[torch.Tensor, ...]:
        """uint8 (B, S, S, 3) images with S = input_size and GT padded to
        M boxes (numpy or tensors): boxes (B, M, 4) cxcywh, or (B, M, 5)
        cxcywhθ for a rotated model → tensors on the step's device.
        Opens the step's id (`span`)."""
        with span("train.batch", new_step=True):
            return self._batch(images_u8, gt_boxes, gt_classes, gt_valid)

    def _batch(self, images_u8, gt_boxes, gt_classes, gt_valid):
        images = torch.as_tensor(images_u8).to(self.device)
        s = self.input_size
        if images.dtype != torch.uint8 or tuple(images.shape[1:]) != (s, s, 3):
            raise ValueError(f"expected uint8 (B, {s}, {s}, 3) images, got "
                             f"{tuple(images.shape)} {images.dtype}")
        boxes = torch.as_tensor(gt_boxes, dtype=torch.float32).to(self.device)
        width = 5 if self.model.config.rotated else 4
        if boxes.dim() != 3 or boxes.shape[-1] != width:
            raise ValueError(f"expected (B, M, {width}) GT boxes for "
                             f"{self.model.config.name}, got "
                             f"{tuple(boxes.shape)}")
        return (images, boxes,
                torch.as_tensor(gt_classes).to(self.device, torch.int64),
                torch.as_tensor(gt_valid).to(self.device, torch.bool))

    def forward(self, images, gt_boxes, gt_classes, gt_valid) -> dict:
        """The loss terms, with the darknet box weight at the step's
        input size."""
        with span("train.forward"):
            return registry.loss(self.model, images, gt_boxes, gt_classes,
                                 gt_valid, input_size=self.input_size)

    def backward(self, terms: dict) -> dict[str, torch.Tensor]:
        """d total / d parameter for every parameter (zero where one
        takes no part, as `jax.grad` gives)."""
        with span("train.backward"):
            grads = torch.autograd.grad(terms["total"],
                                        list(self.params.values()),
                                        allow_unused=True)
            return {k: torch.zeros_like(p) if g is None else g
                    for (k, p), g in zip(self.params.items(), grads)}

    def update(self, grads: dict[str, torch.Tensor], lr: float) -> None:
        with span("train.update"):
            self._update(grads, lr)

    def _update(self, grads: dict[str, torch.Tensor], lr: float) -> None:
        sgd_update(self.params, grads, self.velocity, lr=lr,
                   momentum=self.momentum, weight_decay=self.weight_decay)

    def __call__(self, images_u8, gt_boxes, gt_classes, gt_valid,
                 lr: float) -> dict[str, torch.Tensor]:
        """One step; returns the loss terms before the update (detached,
        on the device)."""
        terms = self.forward(*self.batch(images_u8, gt_boxes, gt_classes,
                                         gt_valid))
        self.update(self.backward(terms), lr)
        return {k: v.detach() for k, v in terms.items()}

    def save(self, path: str, *, step: int | None = None,
             extra: dict | None = None) -> None:
        """Write the model's parameters and BN statistics, the velocity
        (`convert.to_jax_opt`) and `step` as a JAX-format checkpoint,
        atomically."""
        opt = to_jax_opt(self.velocity, self.model.state_dict())
        ckpt_lib.save_checkpoint(path, model_tree(self.model), step=step,
                                 opt_state=ckpt_lib.unflatten_tree(opt),
                                 extra=extra)

    def resume(self, path: str) -> dict:
        """Load a checkpoint of either package into the model and, when it
        has an optimizer state, the velocity (its BN `mean`/`var` leaves
        are ignored, see `convert.to_jax_opt`). The parameters are
        checked against the model's geometry first. Returns the rest:
        {"step", "extra", "format_version"}."""
        ckpt = ckpt_lib.load_checkpoint(path)
        if ckpt["params"] is None:
            raise ValueError(f"checkpoint {path} has no params")
        expected = model_tree(self.model)
        ckpt_lib.check_params_compatible(expected, ckpt["params"],
                                         context=f" '{self.model.config.name}'")
        self.model.load_state_dict(from_jax_params(
            ckpt_lib.flatten_tree(ckpt["params"])), strict=True)
        if ckpt["opt"] is not None:
            ckpt_lib.check_params_compatible(expected, ckpt["opt"],
                                             context=" (optimizer state)")
            opt = from_jax_params(ckpt_lib.flatten_tree(ckpt["opt"]))
            with torch.no_grad():
                for k, v in self.velocity.items():
                    v.copy_(opt[k])
        return {k: ckpt[k] for k in ("step", "extra", "format_version")}


class DataParallelTrainStep:
    """`TrainStep` over replicas, the JAX step under a 1-D mesh: replica
    r is a copy of the train-mode model on `devices[r]` (a device may
    hold two), each takes its chunk of the batch (`mesh.shard_batch`),
    and the step is the global one:

      * `forward` runs the replicas in `mesh.lockstep`; each
        BatchNorm's sums span them (`layers.BatchNorm`), and the
        family's loss sums and normalisers (`registry.loss_sums`) are
        summed over them before `registry.loss_from_sums`, so the terms
        are the whole batch's;
      * `backward` takes one gradient of that total with respect to
        every replica's parameters and sums each parameter's over the
        replicas, in replica order, on the first device;
      * `update` runs `sgd_update` once, on replica 0 and its velocity,
        and copies replica 0's parameters and buffers to the others, so
        the replicas stay bit-equal.

    Replica 0 is the model `make_train_step` was given: `save`, `resume`
    and a caller's `state_dict` see it, and `resume` reaches every
    replica. The phases are `TrainStep`'s, so a caller times them the
    same way."""

    def __init__(self, primary: TrainStep, replicas: list[nn.Module],
                 devices: list[torch.device]):
        self.primary = primary
        self.replicas = replicas
        self.devices = devices
        self._params = [list(m.parameters()) for m in replicas]
        self._state = [list(m.state_dict().values()) for m in replicas]

    model = property(lambda self: self.primary.model)
    params = property(lambda self: self.primary.params)
    velocity = property(lambda self: self.primary.velocity)
    input_size = property(lambda self: self.primary.input_size)

    def at_size(self, input_size: int) -> "DataParallelTrainStep":
        """This step for another input-size bucket, on the same replicas
        and velocity."""
        step = copy.copy(self)
        step.primary = self.primary.at_size(input_size)
        return step

    def batch(self, images_u8, gt_boxes, gt_classes, gt_valid
              ) -> list[tuple[torch.Tensor, ...]]:
        """`TrainStep.batch`'s checks and tensors, split along dim 0 into
        one chunk a replica, each on its device (the first chunks one
        image larger where the batch does not divide; replicas whose
        chunk would be empty sit the step out)."""
        with span("train.batch", new_step=True):
            whole = self.primary._batch(images_u8, gt_boxes, gt_classes,
                                        gt_valid)
            cols = [mesh_lib.shard_batch(t, self.devices) for t in whole]
            return [tuple(col[r][1] for col in cols)
                    for r in range(len(cols[0]))]

    def forward(self, *shards: tuple[torch.Tensor, ...]) -> dict:
        """The loss terms of the whole batch, on the first device, from
        `batch`'s chunks (`step.forward(*step.batch(...))`, as for
        `TrainStep`)."""
        plain, grad = not kernels_enabled(), torch.is_grad_enabled()
        size = self.primary.input_size

        def replica(r, model, shard):
            def run():
                with plain_versions(plain), torch.set_grad_enabled(grad), \
                        span("train.forward", replica=r):
                    return registry.loss_sums(model, *shard, input_size=size)
            return run

        k = len(shards)
        with span("train.forward"):
            sums = mesh_lib.lockstep(self.devices[:k], [
                replica(r, m, s) for r, (m, s) in
                enumerate(zip(self.replicas, shards))])
            total = {key: (mesh_lib.replica_sum([s[key] for s in sums],
                                                self.devices[0])
                           if torch.is_tensor(first) else
                           sum(s[key] for s in sums))
                     for key, first in sums[0].items()}
            return registry.loss_from_sums(self.model.config, total)

    def backward(self, terms: dict) -> dict[str, torch.Tensor]:
        """d total / d parameter, summed over the replicas on the first
        device (zero where a parameter takes no part)."""
        with span("train.backward"):
            flat = [p for ps in self._params for p in ps]
            grads = torch.autograd.grad(terms["total"], flat,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            n, d0 = len(self._params[0]), self.devices[0]
            total = [g.to(d0) for g in grads[:n]]
            for r in range(1, len(self.replicas)):
                total = torch._foreach_add(
                    total, [g.to(d0) for g in grads[r * n:(r + 1) * n]])
            return dict(zip(self.primary.params, total))

    def update(self, grads: dict[str, torch.Tensor], lr: float) -> None:
        with span("train.update"):
            self.primary._update(grads, lr)
            self.sync()

    def sync(self) -> None:
        """Copy replica 0's parameters and buffers to the others."""
        mesh_lib.broadcast(self._state[0], self._state[1:])

    def __call__(self, images_u8, gt_boxes, gt_classes, gt_valid,
                 lr: float) -> dict[str, torch.Tensor]:
        """One global step; returns the loss terms before the update
        (detached, on the first device)."""
        terms = self.forward(*self.batch(images_u8, gt_boxes, gt_classes,
                                         gt_valid))
        self.update(self.backward(terms), lr)
        return {k: v.detach() for k, v in terms.items()}

    def save(self, path: str, *, step: int | None = None,
             extra: dict | None = None) -> None:
        """`TrainStep.save` of replica 0 and the velocity."""
        self.primary.save(path, step=step, extra=extra)

    def resume(self, path: str) -> dict:
        """`TrainStep.resume` into replica 0 and the velocity, then every
        replica."""
        out = self.primary.resume(path)
        self.sync()
        return out


def make_train_step(model: nn.Module, *, input_size: int,
                    momentum: float = 0.9, weight_decay: float = 5e-4,
                    device: str | torch.device | None = None,
                    donate: bool | None = None,
                    mesh: list[torch.device] | None = None
                    ) -> TrainStep | DataParallelTrainStep:
    """The train step for one input-size bucket:
    `step(images_u8, gt_boxes, gt_classes, gt_valid, lr) -> metrics`,
    which updates `model`'s parameters and the step's velocity
    (`step.velocity`) in place. The model moves to `device` (None: the
    GPU, and an error when none is visible; channels_last there, as the
    detect path has it) in train mode. `donate` (the JAX step's buffer
    donation) is accepted and ignored: the update is in place.

    `mesh` (`parallel.mesh.make_mesh()`) of more than one device gives
    the `DataParallelTrainStep` over them, `model` its replica 0 on
    mesh[0] (`device` must then be None or mesh[0]); a mesh of one
    device is that device's `TrainStep`. Use `step.at_size` for the
    other buckets, so that they share the model (or replicas) and the
    velocity."""
    del donate
    if mesh:
        if device is not None and torch.device(device) != mesh[0]:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {mesh[0]}")
        device = mesh[0]
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step runs on CUDA by default and no "
                           "GPU is visible; pass device='cpu' to train on "
                           "the CPU")
    registry.check_input_size(input_size)
    model.to(device).train().requires_grad_(True)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    step = TrainStep(model, input_size=input_size, momentum=momentum,
                     weight_decay=weight_decay, device=device)
    if not mesh or len(mesh) == 1:
        return step
    replicas = [model] + [m.train().requires_grad_(True)
                          for m in mesh_lib.replicate(model, mesh[1:])]
    return DataParallelTrainStep(step, replicas, list(mesh))
