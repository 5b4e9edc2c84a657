"""Shared loss functions: BCE, focal, smooth-L1, IoU losses, periodic
angle loss.

A port of `mydetection_tpu/losses.py`, elementwise with the JAX
expressions' order of operations; reductions are the caller's job.
`onehot_gather` there, an exact one-hot contraction that avoids the
TPU's serialized dynamic gather, is `torch.gather` here
(`take_along_dim`): the same values bit for bit.
"""

from __future__ import annotations

import math

import torch

from mydetection_tpu_torch.ops.boxes import elementwise_giou, elementwise_iou


def take_along_dim(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, M, ...) table + (B, N) idx → (B, N, ...): table[b, idx[b, n]]."""
    b, m = table.shape[:2]
    flat = table.reshape(b, m, -1)
    out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))
    return out.reshape(*idx.shape, *table.shape[2:])


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid binary cross-entropy, elementwise. |x|
    is written as JAX differentiates `abs` (slope +1 at ±0), so the
    gradient at a logit of exactly 0 is JAX's too."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-abs_logits)))


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Sigmoid focal loss (RetinaNet), elementwise; targets in {0, 1}."""
    ce = bce_with_logits(logits, targets)   # = -log p_t
    p_t = torch.exp(-ce)
    alpha_t = torch.where(targets > 0.5, alpha, 1.0 - alpha)
    return alpha_t * (1.0 - p_t) ** gamma * ce


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, *,
              beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise."""
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)


def iou_loss(pred_xyxy: torch.Tensor, target_xyxy: torch.Tensor) -> torch.Tensor:
    """-log IoU (UnitBox), per box pair (...)."""
    iou = elementwise_iou(pred_xyxy, target_xyxy)
    # jnp.clip: maximum, then minimum (half the gradient at a tie)
    return -torch.log(torch.minimum(torch.maximum(iou, iou.new_tensor(1e-8)),
                                    iou.new_tensor(1.0)))


def giou_loss(pred_xyxy: torch.Tensor, target_xyxy: torch.Tensor) -> torch.Tensor:
    """1 - GIoU, per box pair (...)."""
    return 1.0 - elementwise_giou(pred_xyxy, target_xyxy)


def _period_diff(pred, target, period):
    # jnp.mod is a floor modulo, the sign of the divisor: torch.remainder
    return torch.remainder(pred - target + period / 2.0, period) - period / 2.0


def period_l1(pred: torch.Tensor, target: torch.Tensor,
              period: float = math.pi) -> torch.Tensor:
    """Periodic L1, the distance on the circle of the given period:
    |((pred - target + p/2) mod p) - p/2| (RAPiD's angle loss)."""
    return torch.abs(_period_diff(pred, target, period))


def period_l2(pred: torch.Tensor, target: torch.Tensor,
              period: float = math.pi) -> torch.Tensor:
    """Periodic squared error (see period_l1)."""
    return 0.5 * _period_diff(pred, target, period) ** 2
