"""Preprocessing on the device (counterpart of
``recognizer3d_tpu/data/pipeline.py``): depth frames for the live path,
and the training set for the device-resident training pipeline.

- :func:`depth_to_cloud`: raw z16 depth image -> (H·W, 3) float32 cloud by
  the pinhole dewarp;
- :func:`z_filter_subsample`: z-band filter + a fixed-size uniform random
  subsample of the valid points, with its selection :func:`subsample_order`;
- :func:`cloud_to_depth`: the inverse projection on the host (numpy), to
  make depth frames from stored clouds.

Numerics, held against the JAX package in the tests:

- The dewarp keeps the JAX package's operation order, ``(u - cx) / fx * z``
  in float32. The per-column and per-row factors ``(u - cx) / fx`` are
  divided by a tensor, never by a Python scalar, because PyTorch's CUDA
  division by a scalar multiplies with its reciprocal; so the cloud is the
  same, bit for bit, on the CPU, on the card and in eager JAX. (The jitted
  JAX dewarp differs from it by up to 2.4e-7 relative: XLA rewrites the
  constant division.)
- The selection is exact and stable: the ``n_out`` smallest priorities,
  ties to the lower index, which is what ``lax.top_k(-priority, n_out)``
  returns (the JAX package's branch off the TPU; on the TPU it takes
  ``lax.approx_min_k``). ``torch.topk`` orders ties otherwise. Both
  selections here go through ``ops/select_kernels.select_smallest``: a
  stable sort on the CPU, the selection kernel B8 on the card.
- The uniform draw is an argument, so a caller can hand both packages the
  same numbers (``jax.random.uniform`` as numpy in the tests, a seeded
  ``torch.Generator`` in ``LivePredictor``).

:class:`DeviceDatasetCache` keeps a training set on the device and
assembles each batch there (selection, duplicates for short clouds,
augmentation); its draws come from a ``torch.Generator`` or, through
:meth:`DeviceDatasetCache.assemble`, from the caller.
:func:`normalize_cloud_device` is ``data/preprocessing.normalize_cloud``
batched on tensors (the trainer itself takes the host loader when the
clouds are normalized, as the JAX trainer does).
"""

import functools
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.data.augmentation import (
    AugmentationDraws,
    AugmentationSettings,
    draw_augmentation,
    perturbate_point_cloud_device,
)
from recognizer3d_tpu_torch.ops.select_kernels import select_smallest

Z_MIN, Z_MAX = 0.05, 0.6  # the camera's z band in metres


@dataclass
class DepthIntrinsics:
    """Pinhole intrinsics for a rectified depth stream. Defaults are the
    L515's 1024×768 mode."""

    width: int = 1024
    height: int = 768
    fx: float = 735.0
    fy: float = 735.0
    cx: float = 512.0
    cy: float = 384.0
    depth_scale: float = 0.00025  # metres per z16 unit (L515 native)


@functools.lru_cache(maxsize=16)
def _pixel_rays(n: int, c: float, f: float, device: torch.device) -> torch.Tensor:
    """(n,) float32 ``(arange(n) - c) / f``, the true quotient (the divisor
    is a tensor, so CUDA divides instead of multiplying by 1/f)."""
    coords = torch.arange(n, dtype=torch.float32, device=device)
    return (coords - c) / torch.full((n,), f, dtype=torch.float32, device=device)


def depth_to_cloud(depth: torch.Tensor, intr: DepthIntrinsics) -> torch.Tensor:
    """(H, W) z16 depth image (uint16) -> (H·W, 3) float32 cloud on the
    depth's device: X = (u−cx)/fx·Z, Y = (v−cy)/fy·Z, Z = depth·depth_scale.
    Zero-depth pixels become (0, 0, 0), which the z-band filter drops."""
    z = depth.to(torch.float32) * intr.depth_scale
    dev = depth.device
    x = _pixel_rays(intr.width, intr.cx, intr.fx, dev)[None, :] * z
    y = _pixel_rays(intr.height, intr.cy, intr.fy, dev)[:, None] * z
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def cloud_to_depth(cloud: np.ndarray, intr: DepthIntrinsics) -> np.ndarray:
    """Inverse pinhole projection on the host: (N, 3) xyz -> (H, W) uint16
    depth image, the nearest point per pixel (a z-buffer). Stored captures
    hold dewarped clouds; this makes raw frames from them so the depth path
    can run with no sensor attached."""
    cloud = np.asarray(cloud, np.float32)
    z = cloud[:, 2]
    ok = z > 0
    u = np.round(cloud[ok, 0] / z[ok] * intr.fx + intr.cx).astype(np.int64)
    v = np.round(cloud[ok, 1] / z[ok] * intr.fy + intr.cy).astype(np.int64)
    inb = (u >= 0) & (u < intr.width) & (v >= 0) & (v < intr.height)
    zbuf = np.full(intr.height * intr.width, np.inf, np.float32)
    np.minimum.at(zbuf, v[inb] * intr.width + u[inb], z[ok][inb])
    zbuf[~np.isfinite(zbuf)] = 0.0
    z16 = np.round(zbuf / intr.depth_scale).clip(0, 65535).astype(np.uint16)
    return z16.reshape(intr.height, intr.width)


def normalize_cloud_device(xyz: torch.Tensor, normalization: Optional[str]) -> torch.Tensor:
    """Center and radius normalization of (..., N, 3) clouds, each cloud on
    its own: ``normalization`` in {None, "mean", "max", "stdev"} (the
    population standard deviation of the radii); any other string centers
    without scaling."""
    if normalization is None:
        return xyz
    xyz = xyz - xyz.mean(dim=-2, keepdim=True)
    norms = torch.linalg.vector_norm(xyz, dim=-1)
    if normalization == "mean":
        radius = norms.mean(dim=-1)
    elif normalization == "max":
        radius = norms.amax(dim=-1)
    elif normalization == "stdev":
        radius = norms.std(dim=-1, correction=0)
    else:
        radius = torch.ones(norms.shape[:-1], dtype=xyz.dtype, device=xyz.device)
    return xyz / radius[..., None, None]


def subsample_order(
    uniform: torch.Tensor, z: torch.Tensor, n_out: int,
    z_min: float = Z_MIN, z_max: float = Z_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selection of :func:`z_filter_subsample`: valid points
    (z_min < z < z_max, compared in float32) get their uniform priority,
    the others +inf, and the ``n_out`` smallest priorities are taken, ties
    to the lower index.

    :param uniform: (B, N_raw) float32 draw in [0, 1).
    :param z: (B, N_raw) float32 depths.
    :return: (order (B, n_out) int64, valid (B, N_raw) bool).
    """
    valid = (z > z_min) & (z < z_max)
    priority = torch.where(valid, uniform, torch.full_like(uniform, float("inf")))
    return select_smallest(priority, n_out), valid


def z_filter_subsample(
    uniform: torch.Tensor,
    raw: torch.Tensor,
    n_out: int,
    z_min: float = Z_MIN,
    z_max: float = Z_MAX,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter a raw frame to the z band and subsample it uniformly at random
    to a fixed size, on the frame's device. When fewer than ``n_out`` points
    are valid, the rest of the output is zero points with ``valid=False``.

    :param uniform: the uniform draw of the priorities, (B, N_raw), or
        (N_raw,) / (1, N_raw) with an unbatched frame (JAX draws
        ``jax.random.uniform(key, (B, N_raw))``).
    :param raw: (N_raw, 3) or (B, N_raw, 3) points (zeros are invalid).
    :param n_out: output size.
    :return: (points (..., n_out, 3), valid (..., n_out) bool).
    """
    batched = raw.dim() == 3
    if not batched:
        raw = raw[None]
    b, n_raw, _ = raw.shape
    order, valid = subsample_order(
        uniform.reshape(b, n_raw), raw[..., 2], n_out, z_min, z_max
    )
    points = torch.gather(raw, 1, order[..., None].expand(b, n_out, 3))
    valid_out = torch.gather(valid, 1, order)
    points = torch.where(valid_out[..., None], points, torch.zeros_like(points))
    if not batched:
        return points[0], valid_out[0]
    return points, valid_out


@dataclass
class SampleDraws:
    """The random numbers one batch of :class:`DeviceDatasetCache` consumes,
    per cloud: the JAX sampler's ``uniform(k_sel, (n_max,))`` priorities,
    ``randint(k_dup, (n_points,), 0, n_real)`` duplicate positions and the
    augmentation's draws."""

    uniform: torch.Tensor  # (B, n_max) float32 in [0, 1)
    dup_pos: torch.Tensor  # (B, n_points) int64 in [0, n_real)
    augmentation: Optional[AugmentationDraws] = None

    def rows(self, rows: slice) -> "SampleDraws":
        """The draws of the clouds ``rows`` only (a rank's block of a batch:
        each cloud's draws are its own)."""
        aug = self.augmentation
        return SampleDraws(self.uniform[rows], self.dup_pos[rows], None if aug is None else
                           AugmentationDraws(aug.jitter[rows], aug.scale[rows],
                                             aug.angles[rows], aug.shift[rows]))


class DeviceDatasetCache:
    """A training set on the device, with each batch assembled there.

    The clouds are loaded and zero-padded once into (n_samples, n_max)
    tables; afterwards a batch costs no host work. Per cloud, the
    ``n_points`` valid rows of lowest uniform priority are taken (ties to
    the lower index, as ``lax.top_k(-priority, n)``: ``select_smallest``); a cloud
    shorter than ``n_points`` fills the rest with random duplicates of its
    selected points; then the optional augmentation runs.
    """

    def __init__(
        self,
        dataset: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        n_points: int,
        augmentation_settings: Optional[AugmentationSettings] = None,
        device="cuda",
    ):
        clouds, labels = [], []
        for i in range(len(dataset)):
            xyz, _feats, lab = dataset[i]
            if xyz.shape[0] == 0:
                # a zero-point cloud would become n_points copies of a padded row
                raise ValueError(
                    f"dataset sample {i} has zero points; remove or re-capture "
                    "it before training"
                )
            clouds.append(np.asarray(xyz, dtype=np.float32))
            labels.append(np.asarray(lab, dtype=np.int64))
        self.n_samples = len(clouds)
        self.n_points = n_points
        self.device = torch.device(device)
        self._augmentation = augmentation_settings
        # at least n_points wide, so the selection is defined when every
        # cloud is shorter
        n_max = max([len(c) for c in clouds] + [n_points])
        xyz_pad = np.zeros((self.n_samples, n_max, 3), np.float32)
        lab_pad = np.zeros((self.n_samples, n_max), np.int64)
        for i, (c, l) in enumerate(zip(clouds, labels)):
            xyz_pad[i, : len(c)] = c
            lab_pad[i, : len(l)] = l
        n_valid = np.array([len(c) for c in clouds], np.int64)
        self.n_max = n_max
        self._xyz = torch.from_numpy(xyz_pad).to(self.device)
        self._labels = torch.from_numpy(lab_pad).to(self.device)
        self._n_valid = torch.from_numpy(n_valid).to(self.device)
        self._arange = torch.arange(n_max, device=self.device)

    def draw(self, sample_ids: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> SampleDraws:
        """One batch's draws from ``generator`` (on the cache's device)."""
        b = sample_ids.shape[0]
        n_real = torch.clamp(torch.clamp(self._n_valid[sample_ids], max=self.n_points), min=1)
        u = torch.rand((b, self.n_points), generator=generator, device=self.device)
        dup_pos = torch.minimum((u * n_real[:, None]).long(), n_real[:, None] - 1)
        return SampleDraws(
            uniform=torch.rand((b, self.n_max), generator=generator, device=self.device),
            dup_pos=dup_pos,
            augmentation=None if self._augmentation is None else draw_augmentation(
                self._augmentation, b, self.n_points, self.device, generator
            ),
        )

    def assemble(self, sample_ids: torch.Tensor,
                 draws: SampleDraws) -> Tuple[torch.Tensor, torch.Tensor]:
        """(inputs (B, n_points, 3) float32, labels (B, n_points) int64) of
        the clouds ``sample_ids`` under ``draws``."""
        n_valid = self._n_valid[sample_ids]
        valid = self._arange[None, :] < n_valid[:, None]
        priority = torch.where(valid, draws.uniform, torch.full_like(draws.uniform, float("inf")))
        order = select_smallest(priority, self.n_points)
        pos = self._arange[None, : self.n_points]
        order = torch.where(pos < n_valid[:, None], order, torch.gather(order, 1, draws.dup_pos))
        pts = torch.gather(self._xyz[sample_ids], 1, order[..., None].expand(-1, -1, 3))
        labs = torch.gather(self._labels[sample_ids], 1, order)
        if self._augmentation is not None:
            pts = perturbate_point_cloud_device(pts, self._augmentation, draws.augmentation)
        return pts, labs

    def sample_batch(self, sample_ids: torch.Tensor,
                     generator: Optional[torch.Generator] = None):
        """:meth:`assemble` under fresh draws from ``generator``."""
        return self.assemble(sample_ids, self.draw(sample_ids, generator))

    def epoch_batches(self, batch_size: int, generator: Optional[torch.Generator] = None,
                      block: Tuple[int, int] = (0, 1), drop_remainder: bool = False
                      ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Shuffled batches covering the dataset once, the shuffle drawn on
        the device; the remainder batch included unless ``drop_remainder``.
        With ``block`` (i, D), block i of D equal blocks of each batch's
        clouds, drawn as the whole batch is drawn (a rank's block of a
        data-parallel batch: each cloud's draws are its own)."""
        stop = self.n_samples - self.n_samples % batch_size if drop_remainder else self.n_samples
        if drop_remainder and not stop:
            raise ValueError(f"{self.n_samples} samples make no full batch of {batch_size}")
        i, d = block
        order = torch.randperm(self.n_samples, generator=generator, device=self.device)
        for start in range(0, stop, batch_size):
            ids = order[start : start + batch_size]
            rows = slice(i * len(ids) // d, (i + 1) * len(ids) // d)
            yield self.assemble(ids[rows], self.draw(ids, generator).rows(rows))
