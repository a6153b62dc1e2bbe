"""Segmentation metrics (counterpart of ``recognizer3d_tpu/training/metrics.py``).

- predictions are the argmax over the class dim (axis −2);
- per-class accuracy: a class with no labels scores 1.0 when no point was
  predicted correctly for it, else 0.0 (the reference's fallback);
- per-class IoU: 1.0 where the union is empty;
- mIoU: the mean of the per-class IoUs.

:func:`accuracy_array` and :func:`iou_array` return tensors on the logits'
device, so a training loop keeps them there and reads them once per epoch;
``MetricCollector`` and ``MetricCollectorBag`` average them on the host.
"""

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.parallel import collectives


def _masks(logits: torch.Tensor, labels: torch.Tensor):
    """(C, 1…) class ids broadcastable against (…, N) predictions."""
    n_classes = logits.shape[-2]
    predictions = torch.argmax(logits, dim=-2)
    class_ids = torch.arange(n_classes, device=logits.device).view(
        (n_classes,) + (1,) * labels.dim()
    )
    return predictions, class_ids


def _counts(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The counts behind the metrics, float32 (exact below 2^24): correct
    points, points, then per class correct points, labelled points,
    intersection and union, (2 + 4C,)."""
    predictions, class_ids = _masks(logits, labels)
    correct = predictions == labels
    label_mask = labels[None] == class_ids  # (C, ..., N)
    pred_mask = predictions[None] == class_ids
    reduce = tuple(range(1, label_mask.dim()))
    return torch.cat([
        correct.float().sum()[None],
        torch.full((1,), float(labels.numel()), device=logits.device),
        (correct[None] & label_mask).float().sum(reduce),
        label_mask.float().sum(reduce),
        (pred_mask & label_mask).float().sum(reduce),
        (pred_mask | label_mask).float().sum(reduce),
    ])


def _from_counts(counts: torch.Tensor, n_classes: int):
    """(overall accuracy, per-class accuracies, mIoU, per-class IoUs) of
    :func:`_counts`."""
    n_correct_all, n_all, n_correct, n_labels, intersection, union = counts.split(
        [1, 1] + [n_classes] * 4)
    per_class_acc = torch.where(
        n_labels == 0,
        (n_correct == 0).float(),
        n_correct / torch.clamp(n_labels, min=1.0),
    )
    per_class_iou = torch.where(
        union == 0, torch.ones_like(union), intersection / torch.clamp(union, min=1.0)
    )
    return n_correct_all[0] / n_all[0], per_class_acc, per_class_iou.mean(), per_class_iou


def accuracy_array(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Overall and per-class accuracy as tensors.

    :param logits: (..., C, N) network output before softmax.
    :param labels: (..., N) integer class labels.
    :return: (scalar overall accuracy, (C,) per-class accuracies)
    """
    return _from_counts(_counts(logits, labels), logits.shape[-2])[:2]


def iou_array(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mIoU and per-class IoU as tensors.

    :param logits: (..., C, N) network output before softmax.
    :param labels: (..., N) integer class labels.
    :return: (scalar mIoU, (C,) per-class IoUs)
    """
    return _from_counts(_counts(logits, labels), logits.shape[-2])[2:]


def batch_metric_arrays(logits: torch.Tensor, labels: torch.Tensor):
    """(overall accuracy, per-class accuracies, mIoU, per-class IoUs) of a
    step's batch: :func:`accuracy_array` and :func:`iou_array` from one
    count. Inside ``parallel/collectives.whole_batch()`` each rank holds its
    block of the batch and these are the whole batch's, the same on every
    rank: the counts are summed over the ranks (in float64) before the
    division."""
    counts = _counts(logits, labels)
    if collectives.batch_ranks() > 1:
        counts = collectives.all_reduce_sum(counts.double()).float()
    return _from_counts(counts, logits.shape[-2])


def _metric_dict(prefix: str, loss, oa, macc, miou, per_class_ious, class_names) -> OrderedDict:
    dct = OrderedDict(
        {f"{prefix}loss": loss, f"{prefix}OA": oa, f"{prefix}mAcc": macc, f"{prefix}mIoU": miou}
    )
    for class_idx, class_iou in enumerate(per_class_ious):
        key = prefix + class_names[class_idx] if class_names else f"class {class_idx}"
        dct[key + " IoU"] = class_iou
    return dct


class MetricCollector:
    """Collects the metrics of one evaluation pass over a dataset."""

    def __init__(self, class_names: Optional[List[str]] = None):
        self._class_names = class_names
        self.reset()

    def reset(self):
        self._losses: List[float] = []
        self._overall_accuracies: List[float] = []
        self._per_class_accuracies: List[np.ndarray] = []
        self._mious: List[float] = []
        self._per_class_ious: List[np.ndarray] = []

    def push(self, loss, overall_accuracy, per_class_accuracies, miou, per_class_ious) -> None:
        self._losses.append(float(loss))
        self._overall_accuracies.append(float(overall_accuracy))
        self._per_class_accuracies.append(np.asarray(per_class_accuracies, dtype=np.float64))
        self._mious.append(float(miou))
        self._per_class_ious.append(np.asarray(per_class_ious, dtype=np.float64))

    def as_dict(self, tag: str = "") -> OrderedDict:
        prefix = "" if tag == "" else f"{tag}_"
        return _metric_dict(prefix, self.loss, self.overall_accuracy,
                            self.mean_class_accuracy, self.miou, self.per_class_ious,
                            self._class_names)

    @property
    def loss(self) -> float:
        return float(np.mean(self._losses))

    @property
    def overall_accuracy(self) -> float:
        return float(np.nanmean(self._overall_accuracies))

    @property
    def per_class_accuracies(self) -> List[float]:
        return list(np.nanmean(self._per_class_accuracies, axis=0))

    @property
    def mean_class_accuracy(self) -> float:
        return float(np.mean(self.per_class_accuracies))

    @property
    def miou(self) -> float:
        return float(np.nanmean(self._mious))

    @property
    def per_class_ious(self) -> List[float]:
        return list(np.nanmean(self._per_class_ious, axis=0))


def _mean_std(values) -> Tuple[float, float]:
    return float(np.mean(values)), float(np.std(values))


class MetricCollectorBag:
    """MetricCollectors of several seeded evaluation passes, reported as
    mean ± standard deviation."""

    def __init__(self, metric_collectors: List[MetricCollector],
                 class_names: Optional[List[str]] = None):
        self._class_names = class_names
        self._mcs = metric_collectors

    def as_dict(self, tag: str = "", include_stdev: bool = False) -> OrderedDict:
        prefix = "" if tag == "" else f"{tag}_"
        dct = _metric_dict(prefix, self.loss, self.overall_accuracy,
                           self.mean_class_accuracy, self.miou, self.per_class_ious,
                           self._class_names)
        if not include_stdev:
            return OrderedDict((k, v[0]) for k, v in dct.items())
        return dct

    @property
    def loss(self) -> Tuple[float, float]:
        return _mean_std([mc.loss for mc in self._mcs])

    @property
    def overall_accuracy(self) -> Tuple[float, float]:
        return _mean_std([mc.overall_accuracy for mc in self._mcs])

    @property
    def mean_class_accuracy(self) -> Tuple[float, float]:
        return _mean_std([mc.mean_class_accuracy for mc in self._mcs])

    def _per_class(self, per) -> List[Tuple[float, float]]:
        if len(per) == 0:
            return []
        arr = np.asarray(per)  # (runs, C)
        return [(float(m), float(s)) for m, s in zip(arr.mean(0), arr.std(0))]

    @property
    def per_class_accuracies(self) -> List[Tuple[float, float]]:
        return self._per_class([mc.per_class_accuracies for mc in self._mcs])

    @property
    def miou(self) -> Tuple[float, float]:
        return _mean_std([mc.miou for mc in self._mcs])

    @property
    def per_class_ious(self) -> List[Tuple[float, float]]:
        return self._per_class([mc.per_class_ious for mc in self._mcs])
