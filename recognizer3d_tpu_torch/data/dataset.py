"""On-disk dataset layer (counterpart of ``recognizer3d_tpu/data/dataset.py``).

- one sample = ``<timestamp>_data.npy`` (float32 (N, 3) xyz) + optional
  ``<timestamp>_annotation.npy`` (uint8 (N,) mask); timestamps read
  ``YYYY_MM_DD__HH_MM_SS_<micro>000``;
- int indexing skips samples without annotations when ``only_annotated``;
  datetime indexing resolves through the timestamp string;
- features are always an empty (N, 0) array;
- a deterministic 80/20 split under numpy seed 3;
- ``broaden_annotation`` marks every point within 1 cm of an annotated
  point.

The same files, the same samples and the same split as the JAX package.
"""

from datetime import datetime
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

# from this many annotated points on, the JAX package measures with its
# native kd-tree (recognizer3d_tpu/native/kdtree.cpp) when it is built
_TREE_MIN_ANNOTATED = 32


def broaden_annotation(
    point_cloud: np.ndarray, annotation: np.ndarray, radius: float = 0.01
) -> np.ndarray:
    """Mark every point within ``radius`` of any annotated point as positive
    (zeros when no point is annotated).

    Two routes, as in the JAX package, so the labels equal its labels:

    - from 32 annotated points on, the squared distance to the nearest
      annotated point as its kd-tree computes it, ``dx·dx + dy·dy + dz·dz``
      in float32 from left to right, below ``radius²``;
    - below, the blocked expanded form ``‖a‖² + ‖p‖² − 2a·p``, any of them
      below ``radius²``.
    """
    annotation_cloud = np.ascontiguousarray(
        point_cloud[annotation.astype(bool)], dtype=np.float32
    )
    a = annotation_cloud.shape[0]
    if a == 0:
        return np.zeros((point_cloud.shape[0],), dtype=np.uint8)

    if a >= _TREE_MIN_ANNOTATED:
        points = np.ascontiguousarray(point_cloud, np.float32)
        d2 = np.empty(points.shape[0], np.float32)
        block = max(256, (1 << 22) // a)  # about 16 MB of distances a block
        for start in range(0, points.shape[0], block):
            chunk = points[start : start + block]
            dx = annotation_cloud[:, None, 0] - chunk[None, :, 0]
            dy = annotation_cloud[:, None, 1] - chunk[None, :, 1]
            dz = annotation_cloud[:, None, 2] - chunk[None, :, 2]
            d2[start : start + block] = (dx * dx + dy * dy + dz * dz).min(axis=0)
        return (d2 < radius * radius).astype(np.uint8)

    # (A, N) pairwise distances, blocked so the buffer stays cache-friendly
    out = np.zeros((point_cloud.shape[0],), dtype=bool)
    block = max(1024, (1 << 25) // max(a, 1))  # ≤ ~128 MB per block
    for start in range(0, point_cloud.shape[0], block):
        chunk = point_cloud[start : start + block]  # (n, 3)
        d2 = (
            np.sum(annotation_cloud**2, axis=1)[:, None]
            + np.sum(chunk**2, axis=1)[None, :]
            - 2.0 * annotation_cloud @ chunk.T
        )
        out[start : start + block] = np.any(d2 < radius * radius, axis=0)
    return out.astype(np.uint8)


class Dataset(Sequence):
    """Lazy sequence over a directory of ``*_data.npy`` / ``*_annotation.npy``
    pairs."""

    def __init__(
        self,
        root_path: Path,
        only_annotated: bool = True,
        selection: Optional[List[int]] = None,
        broaden_annotations: bool = False,
    ):
        self._root_path = Path(root_path)
        self._only_annotated = only_annotated
        self._selection = selection
        self._broaden_annotations = broaden_annotations
        # per-sample cache: training iterates the dataset once per epoch,
        # and broaden_annotation is O(A·N) host work per load — with region
        # annotations that dominates the whole epoch if recomputed (the
        # reference reloads every epoch, but its annotations are single
        # points). FIFO-bounded by BYTES (large-scene clouds are MBs each);
        # hits revalidate against the npy mtimes so writes from OTHER
        # Dataset instances or processes are seen (stat is ~µs vs an
        # MB-scale load); reads return copies so callers mutating a
        # sample in place cannot corrupt later epochs.
        self._cache: "dict" = {}
        self._cache_bytes = 0
        self._cache_limit_bytes = 512 << 20
        # sorted *_data* listing, revalidated against the directory mtime
        # (int indexing re-listed the whole directory per access otherwise;
        # adds/removes bump the dir mtime, rewrites of existing npys are
        # covered by the per-sample stamps above)
        self._listing: Optional[Tuple[Optional[int], List[Path]]] = None

    def _data_listing(self) -> List[Path]:
        try:
            token: Optional[int] = self._root_path.stat().st_mtime_ns
        except OSError:
            token = None
        if self._listing is None or self._listing[0] != token:
            self._listing = (token, sorted(self._root_path.glob("*_data*")))
        return self._listing[1]

    def _listing_entry(self, index: int) -> Path:
        """Indexed access into the cached listing; an out-of-range index
        forces ONE re-list first — directory mtimes can be too coarse to
        catch a sample added within the same mtime tick as the cached scan
        (so the cache alone could under-report and raise IndexError for a
        file that exists)."""
        data = self._data_listing()
        if not -len(data) <= index < len(data):
            self._listing = None
            data = self._data_listing()
        return data[index]

    def __len__(self):
        if self._selection is not None:
            return len(self._selection)
        if self._only_annotated:
            return len(
                [a for a in self._root_path.glob("*_annotation*") if a.is_file()]
            )
        return len([a for a in self._root_path.glob("*_data*") if a.is_file()])

    def _get_item_index(
        self, index: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        while True:
            if self._selection is not None:
                selected_sample_path = self._listing_entry(self._selection[index])
            else:
                selected_sample_path = self._listing_entry(index)
            selected_sample = selected_sample_path.name.split("_data")[0]
            try:
                return self._get_item_str(selected_sample)
            except Exception as e:
                # skip unannotated samples, like the JAX package
                if str(e) != "No annotation":
                    raise
                index += 1

    def _get_item_datetime(
        self, timestamp: datetime
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._get_item_str(Dataset.timestamp(timestamp))

    def _disk_stamp(self, index: str):
        """(mtime_ns, size) of the data + annotation npys — the cache
        validity token (size too: coarse-mtime filesystems can reuse a
        timestamp across quick successive rewrites)."""

        def _stamp(path: Path):
            try:
                st = path.stat()
            except OSError:
                return None
            return (st.st_mtime_ns, st.st_size)

        return (
            _stamp(self._root_path / (index + "_data.npy")),
            _stamp(self._root_path / (index + "_annotation.npy")),
        )

    def _get_item_str(
        self, index: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        stamp = self._disk_stamp(index)
        cached = self._cache.get(index)
        if cached is not None:
            if cached[0] == stamp:
                return tuple(a.copy() for a in cached[1])
            self._cache_evict(index)
        item = self._load_item_str(index)
        size = sum(a.nbytes for a in item)
        if size <= self._cache_limit_bytes:
            while (
                self._cache
                and self._cache_bytes + size > self._cache_limit_bytes
            ):
                evicted = self._cache.pop(next(iter(self._cache)))
                self._cache_bytes -= sum(a.nbytes for a in evicted[1])
            self._cache[index] = (stamp, item)
            self._cache_bytes += size
            return tuple(a.copy() for a in item)
        return item

    def _load_item_str(
        self, index: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        item_path = self._root_path / (index + "_data.npy")
        if not item_path.exists():
            raise Exception(f"index {index} doesn't exist in dataset.")
        point_cloud = np.load(str(item_path))
        annotation_path = self._root_path / (index + "_annotation.npy")
        if annotation_path.exists():
            annotation_cloud = np.load(str(annotation_path))
            if self._broaden_annotations:
                annotation_cloud = broaden_annotation(point_cloud, annotation_cloud)
        else:
            if self._only_annotated:
                raise Exception("No annotation")
            annotation_cloud = np.zeros([point_cloud.shape[0]], dtype=np.uint8)
        return (
            point_cloud,
            np.zeros((point_cloud.shape[0], 0)),
            annotation_cloud,
        )

    def __getitem__(
        self, index: Union[int, datetime]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if isinstance(index, datetime):
            return self._get_item_datetime(index)
        elif isinstance(index, int):
            return self._get_item_index(index)
        else:
            raise Exception("invalid key!")

    def __setitem__(self, index: datetime, value: np.ndarray) -> None:
        root = self._root_path / Dataset.timestamp(index)
        self._root_path.mkdir(parents=True, exist_ok=True)
        np.save(str(root) + "_data", value)
        self._cache_evict(Dataset.timestamp(index))

    def set_annotation(self, index: datetime, value: np.ndarray) -> None:
        root = self._root_path / Dataset.timestamp(index)
        self._root_path.mkdir(parents=True, exist_ok=True)
        np.save(str(root) + "_annotation", value)
        self._cache_evict(Dataset.timestamp(index))

    def _cache_evict(self, key: str) -> None:
        entry = self._cache.pop(key, None)
        if entry is not None:
            self._cache_bytes -= sum(a.nbytes for a in entry[1])

    @classmethod
    def timestamp(cls, time: Optional[datetime]) -> str:
        """Timestamp string format."""
        input_datetime: datetime = datetime.now() if time is None else time
        return "%04.i_%02.i_%02.i__%02.i_%02.i_%02.i_%06.i000" % (
            input_datetime.year,
            input_datetime.month,
            input_datetime.day,
            input_datetime.hour,
            input_datetime.minute,
            input_datetime.second,
            input_datetime.microsecond,
        )

    def split(self, percentage: float = 0.8) -> "Tuple[Dataset, Dataset]":
        """Deterministic shuffled split with seed 3."""
        indices = list(range(len(self)))
        np.random.seed(3)
        np.random.shuffle(indices)
        split_index = int(percentage * len(indices))
        return (
            Dataset(
                self._root_path,
                self._only_annotated,
                selection=indices[:split_index],
                broaden_annotations=self._broaden_annotations,
            ),
            Dataset(
                self._root_path,
                self._only_annotated,
                selection=indices[split_index:],
                broaden_annotations=self._broaden_annotations,
            ),
        )


class DatasetMerged(Sequence):
    """Concatenation of multiple Datasets."""

    def __init__(
        self, datasets: List[Dataset], selection: Optional[List[int]] = None
    ):
        self._datasets = datasets
        self._selection = selection

    def __len__(self):
        if self._selection is not None:
            return len(self._selection)
        return sum(len(s) for s in self._datasets)

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._selection is not None:
            item = self._selection[item]
        for dataset in self._datasets:
            if item >= len(dataset):
                item -= len(dataset)
            else:
                return dataset[item]
        raise IndexError(item)

    def split(
        self, percentage: float = 0.8
    ) -> "Tuple[DatasetMerged, DatasetMerged]":
        indices = list(range(len(self)))
        np.random.seed(3)
        np.random.shuffle(indices)
        split_index = int(percentage * len(indices))
        return (
            DatasetMerged(self._datasets, selection=indices[:split_index]),
            DatasetMerged(self._datasets, selection=indices[split_index:]),
        )
