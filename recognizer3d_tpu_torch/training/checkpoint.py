"""Training checkpoints and resume (counterpart of
``recognizer3d_tpu/training/checkpoint.py``), in the JAX package's layout,
so that a checkpoint written by either package resumes in the other.

Layout: ``<dir>/ckpt_<epoch:05d>.msgpack`` and a JSON ``latest`` marker
(``{"epoch": e, "file": name}``); the newest ``keep`` files are kept. A
blob is flax's msgpack (``flax.serialization.to_bytes``) of the training
state ``{"params", "batch_stats", "opt_state", "epoch", "step"}``: the
weights as the JAX package's variables (``models/weights.to_flax_variables``),
``opt_state`` as optax's ``ScaleByAdamState`` (``{"count", "mu", "nu"}``,
``models/weights.adam_state_to_optax``), written and read by
``utils/msgpack_lite``.
"""

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.models.weights import (
    adam_state_from_optax,
    adam_state_to_optax,
    from_flax_variables,
    to_flax_variables,
)
from recognizer3d_tpu_torch.utils import msgpack_lite


def save_checkpoint(directory: Path, epoch: int, state: Dict, keep: int = 3) -> Path:
    """Write the training-state tree for ``epoch`` and prune all but the
    newest ``keep`` checkpoints."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"ckpt_{epoch:05d}.msgpack"
    path.write_bytes(msgpack_lite.packb(state))
    (directory / "latest").write_text(json.dumps({"epoch": epoch, "file": path.name}))
    for old in sorted(directory.glob("ckpt_*.msgpack"))[:-keep]:
        old.unlink()
    return path


def latest_checkpoint(directory: Path) -> Optional[int]:
    """Epoch of the newest checkpoint in ``directory``, or None."""
    directory = Path(directory)
    marker = directory / "latest"
    if not marker.exists():
        return None
    meta = json.loads(marker.read_text())
    if not (directory / meta["file"]).exists():
        return None
    return int(meta["epoch"])


def restore_checkpoint(directory: Path, epoch: Optional[int] = None) -> Dict:
    """The training-state tree of ``epoch`` (the newest by default), as
    nested dicts of numpy arrays."""
    directory = Path(directory)
    if epoch is None:
        epoch = latest_checkpoint(directory)
        assert epoch is not None, f"no checkpoint found in {directory}"
    return msgpack_lite.msgpack_restore((directory / f"ckpt_{epoch:05d}.msgpack").read_bytes())


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else np.array(v) for k, v in tree.items()}


def training_state(module: torch.nn.Module, optimizer: torch.optim.Adam, epoch: int,
                   step: int) -> Dict:
    """The training state of ``module`` and its Adam in the JAX trainer's
    layout, as numpy copies (on the CPU a tensor's ``.numpy()`` would share
    its memory, and the next step would change it)."""
    variables = to_flax_variables(module.state_dict())
    return {
        "params": _copy(variables["params"]),
        "batch_stats": _copy(variables["batch_stats"]),
        "opt_state": _copy(adam_state_to_optax(optimizer, module)),
        "epoch": int(epoch),
        "step": int(step),
    }


def load_training_state(state: Dict, module: torch.nn.Module,
                        optimizer: torch.optim.Adam) -> Tuple[int, int]:
    """Load a restored training-state tree into ``module`` and its Adam, in
    place; returns its (epoch, step)."""
    weights = from_flax_variables({"params": state["params"],
                                   "batch_stats": state["batch_stats"]})
    module.load_state_dict(weights)
    adam_state_from_optax(optimizer, module, state["opt_state"])
    return int(np.asarray(state["epoch"])), int(np.asarray(state.get("step", 0)))
