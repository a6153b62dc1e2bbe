"""Training entry point of the port (counterpart of the repository's
``train.py``): the app's training recipe on the GPU.

    python -m recognizer3d_tpu_torch.train -d data/dataset1 [data/dataset2 ...] \
        [--compute-dtype {float32,bfloat16}]

The recipe: every dataset directory loaded with broadened annotations,
merged, split 80/20 under numpy seed 3; the app's model config trained
from a fresh init with the app's training config and augmentation; the
model saved to ``models/<timestamp>`` (an archive both packages load);
per-epoch scalars under ``training_log/<timestamp>``. The run happens in a
spawned process that reports its progress as int percentages over a queue
(clamped to 99 while it lives, 100 once it has exited), and that serves
``training_log/`` with a TensorBoard server for as long as it trains, where
the ``tensorboard`` package is installed. Dataset paths are taken relative
to the working directory. ``--compute-dtype bfloat16`` trains with a
bfloat16 activation chain and float32 master weights, as the JAX
package's flag does.
"""

import dataclasses
import queue as queue_mod
from datetime import datetime
from multiprocessing import get_context
from pathlib import Path
from typing import List, Optional

CLASS_NAMES = ["background", "fingerpoint"]
MODELS_DIR = Path("models")
LOG_ROOT = Path("training_log")


def app_model_config(compute_dtype: str = "float32"):
    """The app's model config: 2 classes, ``knn="naive"``, 2,500 points,
    K = 32, decimation 4, the default layer sizes, in ``compute_dtype``."""
    from recognizer3d_tpu_torch.models.settings import RandLANetSettings

    return RandLANetSettings(
        n_classes=2, n_features=0, knn="naive", n_points=2500, n_neighbors=32, decimation=4,
        compute_dtype=compute_dtype,
    )


def app_training_config():
    """The app's training recipe: 50 epochs, batch 4, lr 1e-2 (StepLR 10,
    0.9), dice, no early stopping, batches assembled on the device."""
    from recognizer3d_tpu_torch.training.settings import TrainingSettings

    return TrainingSettings(
        epochs=50, batch_size=4, learning_rate=1e-2, early_stopping=False, device_pipeline=True,
    )


def app_augmentation():
    from recognizer3d_tpu_torch.data.augmentation import AugmentationSettings

    return AugmentationSettings(
        jitter_variance=0.01, jitter_limit=0.05, scale_limit=0.2, shift_limit=0.1,
        rotation_angle_variances=(0.06, 0.06, 0.06), rotation_angle_limits=(0.18, 0.18, 0.18),
    )


def run_training(
    dataset_dirs: List[Path],
    progress_queue=None,
    training=None,
    models_dir: Path = MODELS_DIR,
    log_root: Path = LOG_ROOT,
    device="cuda",
    compute_dtype: str = "float32",
):
    """The app's training recipe; returns (saved model path, Model, Trainer).

    :param training: TrainingSettings in place of :func:`app_training_config`.
    :param device: "cuda" (the default) or "cpu".
    :param compute_dtype: the model's compute dtype, "float32" or "bfloat16".
    """
    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged
    from recognizer3d_tpu_torch.models.facade import Model

    merged = DatasetMerged([Dataset(d, broaden_annotations=True) for d in dataset_dirs])
    train_split, val_split = merged.split()
    training = app_training_config() if training is None else training
    augmentation = app_augmentation()

    run_name = Dataset.timestamp(datetime.now())
    log_dir = Path(log_root) / run_name
    print(f"\nStarting training and logging at {log_dir} ...")
    print(f"Training settings are: {training}")
    print(f"Augmentation settings are: {augmentation}\n")

    def report_progress(epoch: int, metrics) -> None:
        if progress_queue is not None:
            progress_queue.put(int(100 * epoch / training.epochs))

    settings = dataclasses.replace(app_model_config(), compute_dtype=compute_dtype)
    model = Model(settings, device=device)
    trainer = model.train(train_split, val_split, training, augmentation, log_dir, CLASS_NAMES,
                          callbacks=[report_progress])
    model_path = Path(models_dir) / run_name
    model.save(model_path)
    print(f"\nModel saved to {model_path}")
    return model_path, model, trainer


def _start_tensorboard_server(logdir: Path):
    """Serve ``logdir`` with TensorBoard in a subprocess at the lowest CPU
    priority, or return None where the ``tensorboard`` package is missing
    or the process does not start. Returns the Popen, which the training
    worker terminates when it ends."""
    import importlib.util
    import os
    import subprocess
    import sys

    if importlib.util.find_spec("tensorboard") is None:
        return None

    def _demoted_child() -> None:
        os.nice(19)
        # die with the training worker even when it is killed (the app's
        # Escape): a server that outlived it would hold the port
        try:
            import ctypes
            import signal

            pr_set_pdeathsig = 1
            ctypes.CDLL("libc.so.6", use_errno=True).prctl(pr_set_pdeathsig, signal.SIGTERM)
        except OSError:
            pass  # no glibc: the worker's finally-block terminates it

    try:
        return subprocess.Popen(
            [sys.executable, "-m", "tensorboard", "--logdir", str(logdir)],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            preexec_fn=_demoted_child,
        )
    except OSError:
        return None


def _run_training_job(dataset_dirs, progress_queue, device, compute_dtype="float32") -> None:
    tb_server = _start_tensorboard_server(LOG_ROOT)
    try:
        run_training(dataset_dirs, progress_queue, device=device, compute_dtype=compute_dtype)
    finally:
        if tb_server is not None:
            tb_server.terminate()


class TrainingJob:
    """A training run in a spawned process, observable via ``poll()``.

    The child pushes int percentages into a queue; ``poll()`` drains it and
    reports the latest value, never 100 while the child lives (the model is
    saved after the last epoch) and always 100 once it has exited.
    """

    def __init__(self, process=None, progress_queue=None):
        self._process = process
        self._queue = progress_queue
        self._latest = 1

    @classmethod
    def launch(cls, dataset_dirs: List[Path], device="cuda",
               compute_dtype: str = "float32") -> "TrainingJob":
        """Start training ``dataset_dirs`` on ``device`` in ``compute_dtype``
        in a fresh spawned process."""
        ctx = get_context("spawn")
        progress_queue = ctx.Queue()
        process = ctx.Process(target=_run_training_job,
                              args=(dataset_dirs, progress_queue, device, compute_dtype))
        process.start()
        return cls(process, progress_queue)

    def poll(self) -> int:
        """Latest progress percentage in [1, 100]; 100 means finished."""
        if self._queue is not None:
            while True:
                try:
                    self._latest = self._queue.get_nowait()
                except queue_mod.Empty:
                    break
        if self._process is None or not self._process.is_alive():
            return 100
        return min(self._latest, 99)

    @property
    def succeeded(self) -> Optional[bool]:
        """None while running; afterwards whether the child exited cleanly."""
        if self._process is None:
            return True
        if self._process.is_alive():
            return None
        return self._process.exitcode == 0

    def kill(self) -> None:
        """Hard-stop the training process."""
        if self._process is not None and self._process.is_alive():
            self._process.kill()
            self._process.join()


def _cli() -> None:
    from argparse import ArgumentParser
    from time import sleep, time

    parser = ArgumentParser(
        "Trainer",
        description="Train the app's model on the GPU without the UI, on one or "
        "more datasets combined into one.",
        usage="python -m recognizer3d_tpu_torch.train -d data/dataset1 data/dataset2",
    )
    parser.add_argument("-d", "--dataset", nargs="+", required=True,
                        help="One or more dataset directories to train on.")
    parser.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                        help="Activation dtype of the model's dense and attention chain; "
                        "bfloat16 trains with float32 master weights.")
    args = parser.parse_args()
    started = time()
    job = TrainingJob.launch([Path(d).absolute() for d in args.dataset],
                             compute_dtype=args.compute_dtype)
    while True:
        percent = job.poll()
        print(percent, flush=True)
        if percent == 100:
            break
        sleep(1)
    if job.succeeded is False:
        print("training process crashed — see its output above")
        raise SystemExit(1)
    print(f"training took {(time() - started) / 60} minutes")


if __name__ == "__main__":
    _cli()
