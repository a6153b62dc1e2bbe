"""Early stopping and best-weight snapshots (counterpart of
``recognizer3d_tpu/training/early_stopper.py``).

Watches one metric (the trainer passes ``val_mIoU``, maximised), snapshots
the weights whenever it ties or beats the best so far, and asks training to
stop once ``patience`` epochs in a row bring no such improvement. An
unknown metric name never stops training. The snapshot is a clone of the
module's ``state_dict`` (parameters and BatchNorm buffers) on the module's
device: one extra copy of the weights, under 10 MB for this model family.
"""

import logging
import operator
from typing import Dict, Optional

import torch

log = logging.getLogger("early stopper")


class EarlyStopper:
    """Stateful stop-or-continue decision, one ``check()`` per epoch."""

    def __init__(self, patience: int, metric: str, mode: str = "max"):
        """
        :param patience: epochs without improvement before stopping.
        :param metric: key into the epoch metrics dict to watch.
        :param mode: "max" (higher is better) or "min".
        """
        if mode not in ("max", "min"):
            raise AssertionError("mode should be max or min!")
        # ties count as improvement: the last of equally good epochs is kept
        self._better = operator.ge if mode == "max" else operator.le
        self._patience = patience
        self._metric = metric
        self._best: Optional[float] = None
        self._best_state: Optional[Dict[str, torch.Tensor]] = None
        self._stale_epochs = 0

    def check(self, metrics: Dict[str, float], state_dict: Dict[str, torch.Tensor]) -> bool:
        """Record one epoch's metrics; return True to keep training."""
        value = metrics.get(self._metric)
        if value is None:
            log.warning(f"Metric {self._metric} not known!")
            return True
        if self._best is None or self._better(value, self._best):
            self._best = value
            self._best_state = {k: v.detach().clone() for k, v in state_dict.items()}
            self._stale_epochs = 0
            return True
        self._stale_epochs += 1
        log.info(
            f"{self._metric} has not improved on {self._best:.3f} for "
            f"{self._stale_epochs} of {self._patience} allowed epochs."
        )
        if self._stale_epochs < self._patience:
            return True
        log.info(f"Early stop: {self._metric} stalled for {self._patience} consecutive evaluations.")
        return False

    @property
    def best_state(self) -> Optional[Dict[str, torch.Tensor]]:
        """Clone of the state_dict from the best epoch (None if no epoch
        reported the watched metric)."""
        if self._best_state is not None:
            log.info(f"Returning model with {self._metric}: {self._best:.3f}")
        return self._best_state
