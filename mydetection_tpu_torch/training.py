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
"""

from __future__ import annotations

import torch
from torch import nn

from mydetection_tpu_torch import checkpoint as ckpt_lib
from mydetection_tpu_torch import registry
from mydetection_tpu_torch.convert import (
    from_jax_params,
    model_tree,
    to_jax_opt,
)


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

    def batch(self, images_u8, gt_boxes, gt_classes, gt_valid
              ) -> tuple[torch.Tensor, ...]:
        """uint8 (B, S, S, 3) images with S = input_size and GT padded to
        M boxes (numpy or tensors): boxes (B, M, 4) cxcywh, or (B, M, 5)
        cxcywhθ for a rotated model → tensors on the step's device."""
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
        return registry.loss(self.model, images, gt_boxes, gt_classes,
                             gt_valid, input_size=self.input_size)

    def backward(self, terms: dict) -> dict[str, torch.Tensor]:
        """d total / d parameter for every parameter (zero where one
        takes no part, as `jax.grad` gives)."""
        grads = torch.autograd.grad(terms["total"], list(self.params.values()),
                                    allow_unused=True)
        return {k: torch.zeros_like(p) if g is None else g
                for (k, p), g in zip(self.params.items(), grads)}

    def update(self, grads: dict[str, torch.Tensor], lr: float) -> None:
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


def make_train_step(model: nn.Module, *, input_size: int,
                    momentum: float = 0.9, weight_decay: float = 5e-4,
                    device: str | torch.device | None = None,
                    donate: bool | None = None) -> TrainStep:
    """The train step for one input-size bucket:
    `step(images_u8, gt_boxes, gt_classes, gt_valid, lr) -> metrics`,
    which updates `model`'s parameters and the step's velocity
    (`step.velocity`) in place. The model moves to `device` (None: the
    GPU, and an error when none is visible; channels_last there, as the
    detect path has it) in train mode. `donate` (the JAX step's buffer
    donation) is accepted and ignored: the update is in place."""
    del donate
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_train_step runs on CUDA by default and no "
                           "GPU is visible; pass device='cpu' to train on "
                           "the CPU")
    registry.check_input_size(input_size)
    model.to(device).train().requires_grad_(True)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return TrainStep(model, input_size=input_size, momentum=momentum,
                     weight_decay=weight_decay, device=device)
