"""Training configuration (counterpart of
``recognizer3d_tpu/training/settings.py``): the same dataclass, fields and
defaults, so a recipe reads the same in both packages.

This package trains on one device: ``data_parallel_devices > 1`` (ROADMAP
A9b) raises in ``Trainer.train``.
"""

from dataclasses import dataclass


@dataclass
class TrainingSettings:
    #: Number of epochs to train
    epochs: int = 150
    #: Size of minibatches used during training
    batch_size: int = 8
    #: Base learning rate
    learning_rate: float = 1e-2
    #: Exponential decay for learning rate, applied every 10 epochs
    #: (StepLR(step_size=10))
    learning_rate_decay: float = 0.9
    #: Loss function: "cross_entropy" | "focal" | "dice" | "tversky" | "focal_tversky"
    loss_function: str = "dice"
    #: Early stopping
    early_stopping: bool = True
    #: Patience for early stopping
    early_stopping_patience: int = 20
    #: Number of data-parallel devices (only 1 is ported; ROADMAP A9b)
    data_parallel_devices: int = 1
    #: Save a training-state checkpoint every N epochs (0: never); needs a log_dir
    checkpoint_every: int = 0
    #: Resume from the latest checkpoint under the log_dir
    resume: bool = False
    #: Keep the training set on the device and assemble every batch there
    #: (subsample and augmentation; ``data/pipeline.DeviceDatasetCache``),
    #: with no per-step host preprocessing. Falls back to the host loader
    #: for datasets with extra per-point features or a normalization.
    device_pipeline: bool = False
