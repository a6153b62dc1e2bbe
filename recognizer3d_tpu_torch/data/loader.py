"""Host-side batching (counterpart of ``recognizer3d_tpu/data/loader.py``).

Per sample: random subsample, optional normalization, optional
augmentation, then stacking into fixed-shape numpy batches. Every draw
comes from the global numpy RNG in the JAX package's order, so both
packages' loaders give the same batches under one seed. The device-resident
alternative is ``data/pipeline.DeviceDatasetCache``.
"""

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from recognizer3d_tpu_torch.data import preprocessing
from recognizer3d_tpu_torch.data.augmentation import AugmentationSettings, perturbate_point_cloud


class PointCloudPreprocessor:
    """Dataset adapter: sample, normalize and augment one cloud."""

    def __init__(
        self,
        dataset: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_sample_points: int,
        consistent_sampling: bool = True,
        augmentation_settings: Optional[AugmentationSettings] = None,
        normalization: Optional[str] = None,
    ) -> None:
        self._dataset = dataset
        self._n_sample_points = n_sample_points
        self._consistent_sampling = consistent_sampling
        self._augmentation_settings = augmentation_settings
        self._normalization = normalization
        # consistent sampling without augmentation is a pure function of the
        # sample: cache it (the 10-seed evaluation reads every sample 10 times)
        self._cacheable = consistent_sampling and augmentation_settings is None
        self._cache = {}

    def __len__(self) -> int:
        return len(self._dataset)

    def __getitem__(self, idx: int, preprocess: bool = True) -> Tuple[np.ndarray, np.ndarray, int]:
        """(input (n, 3+F) float32, labels (n,) int32, idx); with
        ``preprocess=False`` the raw full-resolution cloud (postprocess
        evaluation)."""
        if preprocess and self._cacheable and idx in self._cache:
            inputs, labels = self._cache[idx]
            return inputs, labels, idx
        if preprocess:
            xyz, features, labels = self.preprocess(*self._dataset[idx])
        else:
            xyz, features, labels = self._dataset[idx]
        inputs = np.concatenate([xyz.astype(np.float32), features.astype(np.float32)], axis=1)
        labels = labels.astype(np.int32)
        if preprocess and self._cacheable:
            self._cache[idx] = (inputs, labels)
        return inputs, labels, idx

    def preprocess(self, xyz: np.ndarray, features: np.ndarray, labels: np.ndarray):
        n = xyz.shape[0]
        assert xyz.shape[1] == 3, "Point coordinates should have shape (N, 3)!"
        assert features.shape[0] == n, "Features should have shape (N, F)!"
        assert labels.shape == (n,), "Labels should have shape (N,)!"
        sample_indices = preprocessing.sample_points(
            n, self._n_sample_points, consistent=self._consistent_sampling
        )
        sampled_xyz = preprocessing.normalize_cloud(xyz[sample_indices], self._normalization)
        if self._augmentation_settings:
            sampled_xyz = perturbate_point_cloud(sampled_xyz, self._augmentation_settings)
        return sampled_xyz, features[sample_indices], labels[sample_indices]


class DataLoader:
    """Minimal batching iterator: batch_size, shuffle, stacking of
    equal-size samples."""

    def __init__(self, dataset: PointCloudPreprocessor, batch_size: int, shuffle: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self._shuffle = shuffle

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self._shuffle:
            np.random.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            chunk = order[start : start + self.batch_size]
            inputs, labels, indices = zip(*(self.dataset[int(i)] for i in chunk))
            yield (
                np.stack(inputs).astype(np.float32),
                np.stack(labels).astype(np.int32),
                np.asarray(indices, dtype=np.int64),
            )


def get_data_loader(
    dataset: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    n_sample_points: int,
    batch_size: int,
    shuffle: bool = False,
    consistent_sampling: bool = True,
    augmentation_settings: Optional[AugmentationSettings] = None,
    normalization: Optional[str] = None,
) -> DataLoader:
    """A DataLoader over a PointCloudPreprocessor of ``dataset``."""
    return DataLoader(
        PointCloudPreprocessor(
            dataset,
            n_sample_points,
            consistent_sampling=consistent_sampling,
            augmentation_settings=augmentation_settings,
            normalization=normalization,
        ),
        batch_size,
        shuffle=shuffle,
    )
