"""Depth-frame preprocessing on the device (counterpart of
``recognizer3d_tpu/data/pipeline.py:31-123``).

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
  ``lax.approx_min_k``). ``torch.topk`` orders ties otherwise, so the port
  takes a stable sort.
- The uniform draw is an argument, so a caller can hand both packages the
  same numbers (``jax.random.uniform`` as numpy in the tests, a seeded
  ``torch.Generator`` in ``LivePredictor``).

``normalize_cloud_device`` and ``DeviceDatasetCache`` come with training
(ROADMAP A6).
"""

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

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
    order = torch.sort(priority, dim=-1, stable=True).indices[..., :n_out]
    return order, valid


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
