"""Per-epoch scalar logging (counterpart of ``recognizer3d_tpu/utils/tb.py``).

torch's SummaryWriter where the ``tensorboard`` package is installed, else
a JSONL log (``scalars.jsonl`` in the log dir) with the same
``add_scalar`` / ``close`` surface, so training needs no tensorboard.
"""

import json
import time
from pathlib import Path


class JsonlSummaryWriter:
    """Minimal SummaryWriter stand-in: one JSON line per scalar."""

    def __init__(self, log_dir: str):
        self._dir = Path(log_dir)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._f = (self._dir / "scalars.jsonl").open("a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        self._f.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step),
                        "wall_time": time.time()})
            + "\n"
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def make_summary_writer(log_dir):
    """torch's SummaryWriter when tensorboard is installed, else the JSONL
    writer."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return JsonlSummaryWriter(str(log_dir))
    return SummaryWriter(str(log_dir))
