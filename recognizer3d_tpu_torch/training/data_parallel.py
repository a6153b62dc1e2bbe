"""Training over a group of ranks: what each rank runs (the port's
counterpart of the JAX trainer's mesh branch, ``recognizer3d_tpu/training/
trainer.py:104-125``, ``:182-186``, ``:239-247``, ``:348-383``).

Under a JAX mesh one program takes each step on the global batch, sharded
over the "data" axis, and XLA inserts the sums. Here every rank is a process
of a ``parallel/mesh.RankPool`` holding one replica of the model and its
Adam (:class:`RankTrainer`), and ``Trainer.train`` drives them through
``RankPool.run`` with the functions below, which every rank calls in
lockstep:

- each step, each rank trains on its block of the very batch one device
  would train on: the device pipeline's tables (``DeviceDatasetCache``) are
  replicated, every rank draws the whole batch's numbers from a generator
  seeded alike (shuffle, sampler, augmentation, permutation, dropout mask)
  and assembles only its block's clouds; the host loader's batches are
  drawn on rank 0 (the global numpy RNG) and scattered;
- train-mode BatchNorm, the loss and the batch metrics reduce over the whole
  batch (``parallel/collectives.py``), the parameter gradients are summed in
  one exchange, and Adam runs on every rank, so the replicas stay
  bit-identical (:func:`digest` checks it);
- a batch that does not divide over the ranks is dropped, as JAX drops it.

Between epochs the workers wait on their pipes while rank 0 validates,
logs and checkpoints. On one rank (the trainer's one-device run, a pool of
one) the same epoch is the one-device epoch: the whole batch, the
remainder kept. :func:`step` runs one ``trainer.train_step`` on a batch
handed to every rank, sharded over the batch or, with ``axis=1``, over the
points of clouds already permuted (the point-sharded train step,
``SPBackend``). Each of these runs its steps inside
``collectives.whole_batch()``.
"""

import hashlib
import itertools
import logging
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from recognizer3d_tpu_torch.parallel import collectives, mesh
from recognizer3d_tpu_torch.training.metrics import batch_metric_arrays

logger = logging.getLogger("trainer")


@dataclass
class RankTrainer:
    """One rank's replica: its module (train mode), Adam and loss; for
    :func:`run_epoch`, the generator, the device tables (or None: the host
    loader's batches) and the batch size."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    criterion: object
    generator: Optional[torch.Generator] = None
    cache: object = None
    batch_size: int = 0


def payload(model, loss_function: str, optimizer=None, seed: Optional[int] = None,
            cache_spec=None, batch_size: int = 0, dtype: Optional[torch.dtype] = None) -> Dict:
    """What the workers build their replicas from (host copies): ``model``'s
    settings, weights and running statistics, Adam's state (None: fresh),
    the loss, the generator's seed (None: no generator) and the device
    tables' ``(dataset, n_points, augmentation settings)`` (None: none), the
    batch size, and the dtype of the module (None: as built)."""
    return dict(
        settings=asdict(model.settings),
        state={k: v.detach().cpu() for k, v in model.module.state_dict().items()},
        optimizer=None if optimizer is None else _host_tree(optimizer.state_dict()),
        loss_function=loss_function,
        seed=seed,
        cache=cache_spec,
        batch_size=batch_size,
        dtype=dtype,
    )


def _host_tree(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    return tree


def _build(spec: Dict) -> RankTrainer:
    """A worker's replica from rank 0's :func:`payload`."""
    from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache
    from recognizer3d_tpu_torch.models.randlanet import RandLANet
    from recognizer3d_tpu_torch.models.settings import RandLANetSettings
    from recognizer3d_tpu_torch.training.losses import get_loss
    from recognizer3d_tpu_torch.training.trainer import make_optimizer

    dev = mesh.device()
    module = RandLANet(RandLANetSettings(**spec["settings"]))
    module.load_state_dict(spec["state"])
    module = module.to(dev)
    if spec["dtype"] is not None:
        module = module.to(spec["dtype"])
    module.train()
    optimizer = make_optimizer(module, 0.0)
    if spec["optimizer"] is not None:
        optimizer.load_state_dict(spec["optimizer"])
    generator = None
    if spec["seed"] is not None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(spec["seed"])
    cache = None
    if spec["cache"] is not None:
        dataset, n_points, augmentation = spec["cache"]
        cache = DeviceDatasetCache(dataset, n_points, augmentation_settings=augmentation,
                                   device=dev)
    return RankTrainer(module, optimizer, get_loss(spec["loss_function"]), generator, cache,
                       spec["batch_size"])


def adopt(key: str, spec: Dict, root: Optional[RankTrainer] = None) -> None:
    """Every rank keeps a replica under ``key``: rank 0 the caller's live
    objects (``root``) where it passes them, every other one a replica
    built from ``spec`` (:func:`payload`)."""
    mesh.local()[key] = root if root is not None else _build(spec)


def _block(n: int) -> slice:
    """This rank's rows of a batch of ``n`` (which the ranks divide)."""
    per = n // mesh.world()
    return slice(mesh.rank() * per, (mesh.rank() + 1) * per)


def _keep_block(generator: torch.Generator, inputs: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the whole batch's keep mask, drawn as
    ``trainer.dropout_mask`` draws it for the whole batch."""
    b = inputs.shape[0] * mesh.world()
    keep = torch.rand((b, inputs.shape[1], 32), generator=generator, device=inputs.device) < 0.5
    return keep[_block(b)]


def _device_batches(st: RankTrainer):
    """This rank's blocks (inputs, labels, permutation, keep mask) of one
    epoch's batches from the replicated tables, every draw the one device's
    in its order (shuffle, samples, permutation, mask); under a group the
    ragged remainder is dropped before it is drawn."""
    gen, cache = st.generator, st.cache
    d = mesh.world()
    for inputs, labels in cache.epoch_batches(st.batch_size, gen, block=(mesh.rank(), d),
                                              drop_remainder=d > 1):
        perm = torch.randperm(inputs.shape[1], generator=gen, device=cache.device)
        yield inputs, labels, perm, _keep_block(gen, inputs)


def _host_batches(st: RankTrainer, loader):
    """This rank's blocks of the host loader's batches: rank 0 iterates the
    loader (``loader``; None on the workers) and draws each permutation from
    the global numpy RNG, as one device does, and sends each rank its
    block; each rank draws the whole keep mask and keeps its rows. Under a
    group a batch that does not divide over the ranks is dropped before its
    permutation is drawn."""
    dev = mesh.device()
    d = mesh.world()

    def batches():
        for inputs, labels, _ in loader:
            if inputs.shape[0] % d:
                logger.debug(f"dropping ragged batch of {inputs.shape[0]} ({d} ranks)")
                continue
            perm = np.random.permutation(inputs.shape[1])
            yield torch.from_numpy(inputs), torch.from_numpy(labels), perm

    source = batches() if mesh.rank() == 0 else None
    while True:
        item = next(source, None) if source is not None else None
        head = mesh.replicate(None if item is None else (
            tuple(item[0].shape), item[0].dtype, item[1].dtype, item[2]))
        if head is None:
            return
        shape, in_dtype, lab_dtype, perm = head
        inputs = mesh.scatter_blocks(None if item is None else item[0], 0, shape, in_dtype)
        labels = mesh.scatter_blocks(None if item is None else item[1], 0, shape[:2], lab_dtype)
        inputs = inputs.to(dev)
        yield inputs, labels.to(dev), torch.from_numpy(perm).to(dev), _keep_block(st.generator,
                                                                                   inputs)


def run_epoch(key: str, lr: float, root=None) -> Optional[List[tuple]]:
    """One epoch of steps on every rank at learning rate ``lr`` (on one
    rank, the one-device epoch); ``root`` (rank 0 only) is the host loader,
    or None on the device pipeline. Returns, on rank 0, each step's (loss,
    overall accuracy, per-class accuracies, mIoU, per-class IoUs) of the
    whole batch, on the device; None on the workers."""
    from recognizer3d_tpu_torch.training.trainer import train_step

    st = mesh.local()[key]
    for group in st.optimizer.param_groups:
        group["lr"] = lr
    st.module.train()
    blocks = _device_batches(st) if st.cache is not None else _host_batches(st, root)
    pending = []
    with collectives.whole_batch():
        for inputs, labels, perm, keep in blocks:
            loss, logits = train_step(st.module, st.optimizer, st.criterion, inputs, labels,
                                      perm, keep)
            pending.append((loss,) + batch_metric_arrays(logits, labels))
    return pending if mesh.rank() == 0 else None


def time_steps(key: str, n: int) -> List[float]:
    """``n`` steps on every rank from the device pipeline's draws at the
    default learning rate, each timed on the host clock between two
    synchronisations of this rank's device; returns the walls (ms). No
    batch is assembled beyond the n-th."""
    from recognizer3d_tpu_torch.training.settings import TrainingSettings
    from recognizer3d_tpu_torch.training.trainer import train_step

    st = mesh.local()[key]
    for group in st.optimizer.param_groups:
        group["lr"] = TrainingSettings.learning_rate
    st.module.train()
    dev = mesh.device()
    walls: List[float] = []
    with collectives.whole_batch():
        while len(walls) < n:
            for inputs, labels, perm, keep in itertools.islice(_device_batches(st),
                                                               n - len(walls)):
                _sync(dev)
                t = time.perf_counter()
                train_step(st.module, st.optimizer, st.criterion, inputs, labels, perm, keep)
                _sync(dev)
                walls.append((time.perf_counter() - t) * 1e3)
    return walls


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step(key: str, inputs: torch.Tensor, labels: torch.Tensor,
         permutation: Optional[torch.Tensor], keep_mask: torch.Tensor, axis: int = 0):
    """One ``trainer.train_step`` on every rank on its block of a batch
    every rank is handed (host tensors): ``axis=0`` shards the batch (data
    parallel), ``axis=1`` the points of clouds already in their
    random-sampling permutation (``permutation`` None; the point-sharded
    train step, through ``SPBackend``). Returns (loss, {parameter: summed
    gradient}, {buffer: running statistic}, the step's wall ms between two
    synchronisations of this rank's device) on the host; the gradients are
    the whole batch's on every rank. A replica built by :func:`payload`
    without Adam's state steps at learning rate 0, so its parameters stay
    as they were."""
    from recognizer3d_tpu_torch.parallel.sp_model import SPBackend
    from recognizer3d_tpu_torch.training.trainer import train_step

    st = mesh.local()[key]
    dev = mesh.device()
    module = st.module
    module.train()
    dtype = next(module.parameters()).dtype

    def mine(t, dim):
        return mesh.block_of(t, mesh.rank(), dim).to(dev)

    x = mine(inputs, axis).to(dtype if inputs.is_floating_point() else inputs.dtype)
    y, keep = mine(labels, axis), mine(keep_mask, axis)
    perm = None if permutation is None else permutation.to(dev)
    _sync(dev)
    t = time.perf_counter()
    with collectives.whole_batch():
        loss, _ = train_step(module, st.optimizer, st.criterion, x, y, perm, keep,
                             backend=SPBackend() if axis == 1 else None)
    _sync(dev)
    ms = (time.perf_counter() - t) * 1e3
    # copies: on the CPU, .cpu() would hand back the live tensors
    return (float(loss),
            {n: p.grad.detach().cpu().clone() for n, p in module.named_parameters()},
            {n: b.detach().cpu().clone() for n, b in module.named_buffers()}, ms)


def digest(key: str) -> str:
    """SHA-256 of this rank's parameters and running statistics, bytes in
    ``state_dict`` order."""
    h = hashlib.sha256()
    for name, t in mesh.local()[key].module.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()

