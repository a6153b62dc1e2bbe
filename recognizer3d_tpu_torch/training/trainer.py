"""Training engine (counterpart of ``recognizer3d_tpu/training/trainer.py``).

The JAX trainer's protocol, in PyTorch idiom:

- Adam (b1 0.9, b2 0.999, eps 1e-8; ``torch.optim.Adam``) with the StepLR
  schedule lr = lr0 · decay^((epoch − 1) // 10), set by hand each epoch;
- each epoch: every batch through :func:`train_step` (train-mode forward,
  loss, backward, Adam update), then the 10-seed validation
  (:meth:`Trainer.evaluate`), the early-stopping check on ``val_mIoU``,
  console and TensorBoard logging, the callbacks; the best weights are
  restored at the end;
- the batch metrics stay on the device and are read once per epoch;
- validation runs ``module.eval()`` under ``torch.inference_mode()``, so it
  takes the fused LFA kernels as predict does; TF32 stays off (the model
  sets it so), so the step's matmuls are full float32.

Random draws. The global numpy RNG is drawn in the JAX trainer's order:
the seed of the trainer's own generator, then per epoch the loader's
shuffle and per batch its samples, augmentation and forward permutation.
So under one numpy seed the host-loader path hands both packages the same
batches and permutations. What the JAX trainer draws from threefry keys
(dropout masks; on the device pipeline, the whole batch and permutation)
comes here from a ``torch.Generator`` on the model's device, seeded from
that first draw.

With ``TrainingSettings.device_pipeline`` the training set lives on the
device (``data/pipeline.DeviceDatasetCache``) and each step assembles its
batch there, with no host preprocessing. The JAX package runs that epoch
as one ``lax.scan``; here it is a loop of steps.

In the bfloat16 compute mode the step runs the model's bfloat16 train
forward (``models/randlanet.py``) and its backward; the parameters, their
gradients, Adam's state and the running statistics stay float32, as in the
JAX package (float32 master weights).

Checkpoints (``TrainingSettings.checkpoint_every``, ``resume``) are the JAX
trainer's (``training/checkpoint.py``): with a ``log_dir``, the state is
written to ``<log_dir>/checkpoints`` after every ``checkpoint_every``-th
epoch's callbacks; ``resume`` loads the newest one (weights, running
statistics, Adam's state, the step counter) and goes on at the epoch after
it, with that epoch's learning rate. Neither package restores the early
stopper or the random generators, so a resumed run draws other batches
than an uninterrupted one.

With ``TrainingSettings.data_parallel_devices`` N > 1 the steps run over
ranks, as the JAX trainer's steps run over a "data" mesh: the rank count is
clamped to ``gcd(N, batch_size)`` with JAX's warning (1: one device); the
ranks are the first of the cards (``parallel/mesh.devices_for``; on a model
on the CPU, CPU ranks), or the ranks of a ``RankPool`` the caller passes
(ranks may share a card). Each rank trains on its block of the batch one
device would train on, with whole-batch BatchNorm, loss and metrics, the
gradients summed over the ranks and Adam on every rank; batches that do not
divide over the ranks are dropped (``training/data_parallel.py``). Rank 0 is
this process: it validates (unsharded, as JAX does), logs, snapshots the
best weights and checkpoints between epochs while the other ranks wait, and
at the end checks that every rank holds the same parameters and statistics
bit for bit. One device is a pool of one rank, this process: every epoch,
sharded or not, is ``data_parallel.run_epoch``.
"""

import logging
import math
import time
import uuid
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from recognizer3d_tpu_torch.parallel import collectives, mesh
from recognizer3d_tpu_torch.training import checkpoint as ckpt
from recognizer3d_tpu_torch.training import data_parallel
from recognizer3d_tpu_torch.training.early_stopper import EarlyStopper
from recognizer3d_tpu_torch.training.losses import get_loss
from recognizer3d_tpu_torch.training.metrics import (
    MetricCollector,
    MetricCollectorBag,
    batch_metric_arrays,
)
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from recognizer3d_tpu_torch.utils.tb import make_summary_writer

logger = logging.getLogger("trainer")

#: Adam's constants, as optax.scale_by_adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def step_lr(settings: TrainingSettings, epoch: int) -> float:
    """StepLR: lr0 · decay^((epoch − 1) // 10)."""
    return settings.learning_rate * settings.learning_rate_decay ** ((epoch - 1) // 10)


def make_optimizer(module: torch.nn.Module, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(module.parameters(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)


def dropout_mask(generator: torch.Generator, inputs: torch.Tensor) -> torch.Tensor:
    """A train-mode keep mask (B, N, 32) for ``inputs`` (B, N, 3+F)."""
    b, n = inputs.shape[:2]
    return torch.rand((b, n, 32), generator=generator, device=inputs.device) < 0.5


def train_step(module, optimizer, criterion, inputs, labels, permutation, keep_mask,
               backend=None):
    """One optimisation step: train-mode forward, loss, backward, Adam. With
    a ``backend`` (``parallel/sp_model.SPBackend``) the forward runs
    point-sharded. Inside ``parallel/collectives.whole_batch()`` (the steps
    of ``training/data_parallel.py``) each rank holds its block of the
    batch, and the parameter gradients are summed over the ranks before
    Adam, in one exchange. The gradients stay in ``.grad`` until the next
    step. Returns the detached (loss, logits)."""
    optimizer.zero_grad(set_to_none=True)
    logits = module(inputs, permutation, keep_mask, backend=backend)
    loss = criterion(logits, labels)
    loss.backward()
    if collectives.batch_ranks() > 1:
        collectives.all_reduce_grads(module.parameters())
    optimizer.step()
    return loss.detach(), logits.detach()


def _drain(pending) -> List[tuple]:
    """Per-batch tuples of device tensors -> per-batch tuples of numpy
    values, in one read per field."""
    if not pending:
        return []
    columns = [torch.stack(col).cpu().numpy() for col in zip(*pending)]
    return list(zip(*columns))


class Trainer:
    def __init__(
        self,
        train_dataloader,
        validation_dataloader,
        log_dir: Optional[Path] = None,
        class_names: Optional[List[str]] = None,
    ):
        """
        :param train_dataloader: ``data/loader.DataLoader`` of training data.
        :param validation_dataloader: DataLoader of validation data.
        :param log_dir: Optional directory for the TensorBoard scalars.
        :param class_names: Optional class names (logging).
        """
        self._train_dataloader = train_dataloader
        self._validation_dataloader = validation_dataloader
        self._log_dir = log_dir
        self._class_names = class_names
        #: per epoch: {"epoch", "steps", "train_s", "validate_s", "metrics",
        #: "step_losses"} (host clock; each phase ends in a read of its
        #: results; the metrics the callbacks get; each step's loss)
        self.history: List[Dict] = []
        #: after a data-parallel run, each rank's SHA-256 of its parameters
        #: and running statistics (``data_parallel.digest``), rank 0's first
        self.rank_digests: List[str] = []

    # ------------------------------------------------------------------

    def _device_cache(self, device):
        """The training set on the device and what it was built from
        (dataset, n_points, augmentation settings), or (None, None) where
        the device pipeline does not apply (normalized clouds, extra point
        features)."""
        from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache

        preproc = self._train_dataloader.dataset
        if preproc._normalization is not None:
            logger.warning(
                "device_pipeline requested but the loader uses normalization="
                f"{preproc._normalization!r}; using the host loader."
            )
            return None, None
        if preproc._dataset[0][1].shape[1] != 0:
            logger.warning(
                "device_pipeline requested but the dataset has extra point "
                "features; using the host loader."
            )
            return None, None
        t0 = time.monotonic()
        spec = ([preproc._dataset[i] for i in range(len(preproc._dataset))],
                preproc._n_sample_points, preproc._augmentation_settings)
        cache = DeviceDatasetCache(spec[0], spec[1], augmentation_settings=spec[2],
                                   device=device)
        logger.info(f"device pipeline: dataset on {device} in {time.monotonic() - t0:.1f}s")
        return cache, spec

    def _ranks(self, model, settings: TrainingSettings, pool):
        """The pool of ranks the steps run on and whether this trainer
        started it: the JAX trainer's ``gcd(data_parallel_devices,
        batch_size)`` clamp, with its warning; a given ``pool`` must hold
        exactly the clamped count. Where the clamp leaves one device, a pool
        of one rank: this process, on the model's device."""
        requested = settings.data_parallel_devices if pool is None else pool.n_ranks
        if pool is not None and settings.data_parallel_devices not in (1, requested):
            raise ValueError(f"data_parallel_devices {settings.data_parallel_devices} with a "
                             f"pool of {requested} ranks")
        n_dp = math.gcd(requested, settings.batch_size)
        if n_dp != requested:
            logger.warning(
                f"batch_size {settings.batch_size} is not divisible by "
                f"data_parallel_devices {requested}; "
                + (f"using a {n_dp}-device data-parallel mesh instead." if n_dp > 1
                   else "running without data-parallel sharding.")
            )
        if n_dp == 1:
            return mesh.RankPool([model.device]), True
        if pool is not None:
            if n_dp != pool.n_ranks:
                raise ValueError(f"a pool of {pool.n_ranks} ranks cannot train on {n_dp}")
            if mesh.normalize_device(pool.devices[0]) != mesh.normalize_device(model.device):
                raise ValueError(f"rank 0 trains the model on {model.device}; the pool's "
                                 f"ranks start with {pool.devices[0]}")
            return pool, False
        devices = mesh.devices_for(n_dp, torch.device(model.device).type)
        if mesh.normalize_device(devices[0]) != mesh.normalize_device(model.device):
            raise ValueError(f"data-parallel ranks run on {devices}; the model is on "
                             f"{model.device}")
        return mesh.RankPool(devices), True

    def train(
        self,
        model,
        settings: TrainingSettings,
        callbacks: List[Callable[[int, Dict[str, float]], None]] = [],
        pool: Optional[mesh.RankPool] = None,
    ):
        """Train the given facade Model in place; returns it with the best
        (``val_mIoU``) weights loaded. ``pool``: the data-parallel ranks to
        train on (rank 0 on the model's device), in place of the first
        ``data_parallel_devices`` cards; the caller closes it."""
        module = model.module
        device = model.device
        criterion = get_loss(settings.loss_function)
        optimizer = make_optimizer(module, settings.learning_rate)
        patience = settings.early_stopping_patience if settings.early_stopping else settings.epochs
        early_stopper = EarlyStopper(patience=patience, metric="val_mIoU")

        n_train = len(self._train_dataloader.dataset)
        n_val = len(self._validation_dataloader.dataset)
        logger.info(f"Training on {n_train} training samples and {n_val} validation samples.")
        writer = make_summary_writer(str(self._log_dir)) if self._log_dir is not None else None

        # the JAX trainer's first draw from the global numpy RNG seeds its
        # host generator; here it seeds the device generator
        seed = int(np.random.randint(0, 2**31 - 1))
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        device_cache, cache_spec = (self._device_cache(device) if settings.device_pipeline
                                    else (None, None))

        ckpt_dir, start_epoch, step_counter = None, 1, 0
        if self._log_dir is not None and (settings.checkpoint_every > 0 or settings.resume):
            ckpt_dir = Path(self._log_dir) / "checkpoints"
            latest = ckpt.latest_checkpoint(ckpt_dir) if settings.resume else None
            if latest is not None:
                epoch, step_counter = ckpt.load_training_state(
                    ckpt.restore_checkpoint(ckpt_dir, latest), module, optimizer
                )
                start_epoch = epoch + 1
                logger.info(f"Resumed from checkpoint epoch {latest} in {ckpt_dir}")

        ranks, owns_pool = None, False
        key = f"trainer-{uuid.uuid4().hex}"
        try:
            ranks, owns_pool = self._ranks(model, settings, pool)
            spec = None  # what the workers build their replicas from
            if ranks.n_ranks > 1:
                logger.info(f"data-parallel training on {ranks.n_ranks} ranks: "
                            f"{[str(d) for d in ranks.devices]}")
                spec = data_parallel.payload(model, settings.loss_function, optimizer, seed,
                                             cache_spec, settings.batch_size)
            ranks.run(data_parallel.adopt, key, spec, root=data_parallel.RankTrainer(
                module, optimizer, criterion, generator, device_cache, settings.batch_size))
            spec = cache_spec = None  # the host copies of the training set
            for epoch in range(start_epoch, settings.epochs + 1):
                t_epoch = time.monotonic()
                lr = step_lr(settings, epoch)
                loader = self._train_dataloader if device_cache is None else None
                pending = ranks.run(data_parallel.run_epoch, key, lr, root=loader)[0]
                step_counter += len(pending)
                train_metrics = MetricCollector(self._class_names)
                rows = _drain(pending)  # one read per epoch
                for row in rows:
                    train_metrics.push(*row)
                t_train = time.monotonic()

                validation_metrics = Trainer.evaluate(
                    model, self._validation_dataloader, class_names=self._class_names,
                    loss_function=settings.loss_function,
                )
                t_done = time.monotonic()
                logger.info(f"epoch {epoch} timing: train {t_train - t_epoch:.1f}s, "
                            f"validate {t_done - t_train:.1f}s")
                metrics = train_metrics.as_dict()
                metrics.update(validation_metrics.as_dict("val"))
                self.history.append(dict(epoch=epoch, steps=len(pending),
                                         train_s=t_train - t_epoch,
                                         validate_s=t_done - t_train, metrics=metrics,
                                         step_losses=[float(row[0]) for row in rows]))
                continue_training = early_stopper.check(metrics, module.state_dict())
                self._log(epoch, settings.epochs, lr, train_metrics.as_dict(),
                          validation_metrics.as_dict(include_stdev=True), writer)
                for callback in callbacks:
                    callback(epoch, metrics)
                if (ckpt_dir is not None and settings.checkpoint_every > 0
                        and epoch % settings.checkpoint_every == 0):
                    ckpt.save_checkpoint(
                        ckpt_dir, epoch, ckpt.training_state(module, optimizer, epoch, step_counter)
                    )
                if not continue_training:
                    break
            if ranks.n_ranks > 1:
                self.rank_digests = ranks.run(data_parallel.digest, key)
                if len(set(self.rank_digests)) != 1:
                    raise RuntimeError(f"the ranks' parameters and statistics differ after "
                                       f"training: {self.rank_digests}")
        finally:
            module.eval()
            if writer is not None:
                writer.close()
            mesh.forget(key)  # rank 0's replica: the caller's own objects
            if owns_pool:
                ranks.close()
            elif ranks is not None and not ranks.closed:
                ranks.run(mesh.forget, key)
        best = early_stopper.best_state
        if best is None:
            logger.warning("Model did not improve during training!")
        else:
            module.load_state_dict(best)
        return model

    # ------------------------------------------------------------------

    def _log(self, epoch: int, total_epochs: int, lr: float, train_metrics: OrderedDict,
             validation_metrics: OrderedDict, writer) -> None:
        """Console and TensorBoard logging."""
        log_line = f"Epoch {epoch:3d}/{total_epochs:3d} - "
        log_line += "%s: %.4f - val_%s: %.4f (s: %.4f) - " % (
            "loss", train_metrics["loss"], "loss", validation_metrics["loss"][0],
            validation_metrics["loss"][1],
        )
        for key in ["mAcc", "mIoU"]:
            log_line += "%s: %.2f%% - val_%s: %.2f%% (s: %.2f%%) - " % (
                key, train_metrics[key] * 100, key, validation_metrics[key][0] * 100,
                validation_metrics[key][1] * 100,
            )
        logger.info(log_line[:-2])
        for mode, metrics in {"Training": train_metrics, "Validation": validation_metrics}.items():
            log_line = f"{'':15s} {mode + ' IoU:':16s}"
            keys = [k for k in metrics.keys() if k.endswith(" IoU")]
            for key in keys:
                log_line += key.split(" IoU")[0]
                metric = metrics[key]
                if isinstance(metric, tuple):
                    log_line += ": %5.2f%% (s: %5.2f%%)" % (metric[0] * 100, metric[1] * 100)
                else:
                    log_line += ": %5.2f%% %11s" % (metric * 100, "")
                if key != keys[-1]:
                    log_line += " - "
            logger.info(log_line)
        if writer is not None:
            writer.add_scalar("Learning rate", lr, epoch)
            for mode, metric_set in {"Train": train_metrics, "Validation": validation_metrics}.items():
                for key, metric in metric_set.items():
                    writer.add_scalar(f"{key}/{mode}",
                                      metric[0] if isinstance(metric, tuple) else metric, epoch)

    # ------------------------------------------------------------------

    @staticmethod
    def _device_eval_batches(data_loader, n_evaluations: int, device):
        """The seed-independent validation sweep's batches and per-(seed,
        batch) permutations, on the device, cached on the loader: one host
        pass, drawn in the per-batch loop's order."""
        cache = getattr(data_loader, "_device_eval_cache", None)
        key = (n_evaluations, str(device))
        if cache is not None and key in cache:
            return cache[key]
        batches = [(inputs, labels) for inputs, labels, _ in data_loader]
        rnd_state = np.random.get_state()
        perms = [[None] * len(batches) for _ in range(n_evaluations)]
        for si in range(n_evaluations):
            np.random.seed(100 * si)
            for bi, (inputs, _) in enumerate(batches):
                perms[si][bi] = np.random.permutation(inputs.shape[1])
        np.random.set_state(rnd_state)
        out = [
            (torch.from_numpy(inputs).to(device), torch.from_numpy(labels).to(device),
             [torch.from_numpy(perms[si][bi]).to(device) for si in range(n_evaluations)])
            for bi, (inputs, labels) in enumerate(batches)
        ]
        if cache is None:
            cache = data_loader._device_eval_cache = {}
        cache[key] = out
        return out

    @staticmethod
    def evaluate(
        model,
        data_loader,
        class_names: Optional[List[str]] = None,
        loss_function: str = "dice",
        postprocess: bool = False,
        n_evaluations: int = 10,
    ) -> MetricCollectorBag:
        """The seeded repeated evaluation: ``n_evaluations`` passes over the
        loader, pass i under numpy seed 100·i (the seed drives each
        forward's permutation), the global numpy RNG restored afterwards.

        When the loader's data does not depend on the seed (consistent
        sampling, no augmentation, no shuffle: the validation loader) its
        batches and permutations are made once and kept on the device, as
        the JAX package's fused sweep keeps them. With ``postprocess`` the
        predictions are upsampled onto the raw cloud and scored against
        its labels (batch size 1)."""
        criterion = get_loss(loss_function)
        module, device = model.module, model.device
        was_training = module.training
        module.eval()
        pending: List[List[tuple]] = [[] for _ in range(n_evaluations)]
        fast = (not postprocess and getattr(data_loader.dataset, "_cacheable", False)
                and not getattr(data_loader, "_shuffle", True))
        if postprocess:
            assert data_loader.batch_size == 1, (
                "Batch size 1 required when evaluating with postprocessing!"
            )
        try:
            with torch.inference_mode():
                if fast:
                    for inputs, labels, perms in Trainer._device_eval_batches(
                        data_loader, n_evaluations, device
                    ):
                        for si in range(n_evaluations):
                            logits = module(inputs, perms[si])
                            pending[si].append(
                                (criterion(logits, labels),) + batch_metric_arrays(logits, labels)
                            )
                else:
                    rnd_state = np.random.get_state()
                    for si in range(n_evaluations):
                        np.random.seed(100 * si)
                        for inputs, labels, indices in data_loader:
                            permutation = np.random.permutation(inputs.shape[1])
                            inputs_d = torch.from_numpy(inputs).to(device)
                            labels_d = torch.from_numpy(labels).to(device)
                            logits = module(inputs_d, torch.from_numpy(permutation).to(device))
                            loss = criterion(logits, labels_d)
                            metrics = batch_metric_arrays(logits, labels_d)
                            if postprocess:
                                raw_inputs, raw_labels, _ = data_loader.dataset.__getitem__(
                                    int(indices[0]), preprocess=False
                                )
                                confidences = model.upsample(
                                    logits, inputs[:, :, :3], raw_inputs[None, :, :3]
                                )
                                metrics = batch_metric_arrays(
                                    torch.from_numpy(confidences[0]).to(device),
                                    torch.from_numpy(raw_labels.astype(np.int64)).to(device),
                                )
                            pending[si].append((loss,) + metrics)
                    np.random.set_state(rnd_state)
        finally:
            module.train(was_training)
        collectors = []
        for seed_pending in pending:
            collector = MetricCollector()
            for row in _drain(seed_pending):
                collector.push(*row)
            collectors.append(collector)
        return MetricCollectorBag(collectors, class_names)
