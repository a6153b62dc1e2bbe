"""Segmentation losses (counterpart of ``recognizer3d_tpu/training/losses.py``).

Every loss takes ``logits (B, C, N)`` and integer ``labels (B, N)`` and
returns a scalar tensor:

- ``cross_entropy``  — mean softmax cross-entropy over all points
- ``focal``          — focal loss (gamma 2): one-hot clamped to [eps, 1−eps],
  summed and divided by B·N
- ``dice``           — focal Tversky with alpha 0.5, gamma 1 (= Dice)
- ``tversky``        — focal Tversky with alpha 0.7, gamma 1
- ``focal_tversky``  — focal Tversky with alpha 0.7, gamma 4/3

The Tversky variants leave class 0 (the background) out.

Inside ``parallel/collectives.whole_batch()`` (data-parallel or
point-sharded training) each rank holds its block of the batch, and every
loss is that of the whole batch, as under a JAX mesh: the per-class sums of
the Tversky variants and the sums over points of the others are summed over
the ranks (``collectives.batch_sum``), the divisor is the whole batch's
B·N (every rank's block the same size), and the loss is the same on every
rank. Outside it, or on one rank, nothing changes.
"""

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

from recognizer3d_tpu_torch.parallel import collectives

EPS = 1e-7


def _one_hot(labels: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    """(B, N) -> (B, C, N) one-hot."""
    return F.one_hot(labels.long(), n_classes).to(dtype).transpose(-1, -2)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy (torch.nn.CrossEntropyLoss semantics)."""
    log_probs = torch.log_softmax(logits, dim=-2)
    picked = torch.gather(log_probs, -2, labels.long()[..., None, :])
    ranks = collectives.batch_ranks()
    if ranks == 1:
        return -picked.mean()
    return -collectives.batch_sum(picked.sum()) / (picked.numel() * ranks)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss: CE·(1−p)^γ summed, divided by B·N."""
    y_true = _one_hot(labels, logits.shape[-2], logits.dtype).clamp(EPS, 1.0 - EPS)
    y_pred = torch.softmax(logits, dim=-2).clamp(EPS, 1.0 - EPS)
    focal = -y_true * torch.log(y_pred) * (1.0 - y_pred) ** gamma
    b, _, n = logits.shape
    return collectives.batch_sum(focal.sum()) / (b * n * collectives.batch_ranks())


def focal_tversky_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    alpha: float = 0.7,
    gamma: float = 4.0 / 3.0,
    neglect_background: bool = True,
) -> torch.Tensor:
    """Focal Tversky loss: Dice at alpha 0.5, gamma 1; Tversky at gamma 1.
    TP/FN/FP are summed per class over every point of the batch."""
    n_classes = logits.shape[-2]
    y_true = _one_hot(labels, n_classes, logits.dtype)
    y_pred = torch.softmax(logits, dim=-2)
    y_true = y_true.transpose(0, 1).reshape(n_classes, -1)  # (C, B·N)
    y_pred = y_pred.transpose(0, 1).reshape(n_classes, -1)
    if neglect_background:
        y_true, y_pred = y_true[1:], y_pred[1:]
    true_pos = (y_true * y_pred).sum(dim=1)
    false_neg = (y_true * (1.0 - y_pred)).sum(dim=1)
    false_pos = ((1.0 - y_true) * y_pred).sum(dim=1)
    true_pos, false_neg, false_pos = collectives.batch_sum(true_pos, false_neg, false_pos)
    tversky_index = (true_pos + EPS) / (
        true_pos + alpha * false_neg + (1.0 - alpha) * false_pos + EPS
    )
    return ((1.0 - tversky_index) ** gamma).mean()


def get_loss(loss_function: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The loss of that name, with the JAX package's parameters."""
    if loss_function == "cross_entropy":
        return cross_entropy_loss
    if loss_function == "focal":
        return partial(focal_loss, gamma=2.0)
    if loss_function == "dice":
        return partial(focal_tversky_loss, alpha=0.5, gamma=1.0, neglect_background=True)
    if loss_function == "tversky":
        return partial(focal_tversky_loss, alpha=0.7, gamma=1.0, neglect_background=True)
    if loss_function == "focal_tversky":
        return partial(focal_tversky_loss, alpha=0.7, gamma=4.0 / 3.0, neglect_background=True)
    raise ValueError(f"Loss function {loss_function} not known!")
