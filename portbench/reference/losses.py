"""The losses' elementwise terms (BCE, focal, GIoU) and the gather of
matched targets; reductions are the caller's job."""

from __future__ import annotations

import torch

from portbench.reference.boxes import elementwise_giou


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


def giou_loss(pred_xyxy: torch.Tensor, target_xyxy: torch.Tensor) -> torch.Tensor:
    """1 - GIoU, per box pair (...)."""
    return 1.0 - elementwise_giou(pred_xyxy, target_xyxy)
