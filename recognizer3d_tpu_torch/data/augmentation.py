"""Point-cloud augmentation (counterpart of
``recognizer3d_tpu/data/augmentation.py``).

Jitter (scaled by the mean cloud radius, clipped), then a random scale
about the centroid, a small random Rz·Ry·Rx rotation about the centroid
and a random shift scaled by the radius, in that order.

- The numpy functions draw from the global numpy RNG in the JAX package's
  order, so the host loader's batches equal the JAX package's under one
  seed.
- :func:`perturbate_point_cloud_device` augments a batch of clouds on
  their device. It takes its random draws as an :class:`AugmentationDraws`
  (the JAX version splits a threefry key, which torch cannot reproduce), so
  a test can hand it JAX's draws; :func:`draw_augmentation` makes them
  from a ``torch.Generator``.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class AugmentationSettings:
    #: Variance of random perturbation of single points
    jitter_variance: float = 0.01
    #: Clip value of random perturbation of single points
    jitter_limit: float = 0.05
    #: Maximum scale for random scaling of the point cloud.
    #: Scale will be randomly selected from [1 - scale_limit, 1 + scale_limit]
    scale_limit: float = 0.2
    #: Maximum translation for random shifting the point cloud
    shift_limit: float = 0.1
    #: Variances of random rotation around x, y and z axes respectively (rad)
    rotation_angle_variances: Tuple[float, float, float] = (0.06, 0.06, 0.06)
    #: Clip values of random rotation around x, y and z axes respectively (rad)
    rotation_angle_limits: Tuple[float, float, float] = (0.18, 0.18, 0.18)


def get_mean_radius(xyz: np.ndarray) -> float:
    """Mean distance to the cloud center."""
    center = np.mean(xyz, axis=0, keepdims=True)
    return float(np.mean(np.linalg.norm(xyz - center, axis=1)))


def jitter_point_cloud(xyz: np.ndarray, variance: float = 0.01, limit: float = 0.05) -> np.ndarray:
    """Per-point gaussian jitter scaled by the mean radius, clipped."""
    radius = get_mean_radius(xyz)
    perturbation = np.clip(
        radius * variance * np.random.randn(xyz.shape[0], xyz.shape[1]), -limit, limit
    )
    return xyz + perturbation


def random_scale_point_cloud(xyz: np.ndarray, scale_limit: float = 0.2) -> np.ndarray:
    """Uniform random scale about the centroid."""
    scale = np.random.uniform(1 - scale_limit, 1 + scale_limit)
    center = np.mean(xyz, axis=0, keepdims=True)
    return (xyz - center) * scale + center


def _rotation_matrix(angles) -> np.ndarray:
    """R = Rz @ Ry @ Rx for the given xyz euler angles."""
    ax, ay, az = angles
    Rx = np.array([[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]])
    Ry = np.array([[np.cos(ay), 0, np.sin(ay)], [0, 1, 0], [-np.sin(ay), 0, np.cos(ay)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def random_rotate_point_cloud(
    xyz: np.ndarray,
    angle_variances: Tuple[float, float, float] = (0.06, 0.06, 0.06),
    angle_limits: Tuple[float, float, float] = (0.18, 0.18, 0.18),
) -> np.ndarray:
    """Small random rotation about the centroid."""
    assert len(angle_variances) == 3, "angle variances should have length 3"
    assert len(angle_limits) == 3, "angle limits should have length 3"
    angles = [
        np.clip(sigma * np.random.randn(), -limit, limit)
        for sigma, limit in zip(angle_variances, angle_limits)
    ]
    R = _rotation_matrix(angles)
    center = np.mean(xyz, axis=0, keepdims=True)
    return (xyz - center) @ R.T + center


def random_shift_point_cloud(xyz: np.ndarray, shift_limit: float = 0.1) -> np.ndarray:
    """Uniform random shift scaled by the mean radius."""
    radius = get_mean_radius(xyz)
    shifts = radius * np.random.uniform(-shift_limit, shift_limit, 3)
    return xyz + shifts


def perturbate_point_cloud(xyz: np.ndarray, settings: AugmentationSettings) -> np.ndarray:
    """The whole augmentation, on the host."""
    xyz = jitter_point_cloud(xyz, settings.jitter_variance, settings.jitter_limit)
    xyz = random_scale_point_cloud(xyz, settings.scale_limit)
    xyz = random_rotate_point_cloud(
        xyz, settings.rotation_angle_variances, settings.rotation_angle_limits
    )
    xyz = random_shift_point_cloud(xyz, settings.shift_limit)
    return xyz


# --------------------------------------------------------------------------
# On the device
# --------------------------------------------------------------------------


@dataclass
class AugmentationDraws:
    """The random numbers one batch's augmentation consumes, per cloud:
    the JAX version's ``normal(k_jit, (N, 3))``, ``uniform(k_scale, (),
    1 − scale_limit, 1 + scale_limit)``, ``normal(k_rot, (3,))`` and
    ``uniform(k_shift, (3,), −shift_limit, shift_limit)``."""

    jitter: torch.Tensor  # (B, N, 3) standard normals
    scale: torch.Tensor  # (B,) scales
    angles: torch.Tensor  # (B, 3) standard normals
    shift: torch.Tensor  # (B, 3) shifts, before the radius


def draw_augmentation(settings: AugmentationSettings, b: int, n: int, device,
                      generator: Optional[torch.Generator] = None) -> AugmentationDraws:
    """One batch's draws from ``generator`` on ``device``."""

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return u * (hi - lo) + lo

    return AugmentationDraws(
        jitter=torch.randn((b, n, 3), generator=generator, device=device),
        scale=uniform((b,), 1 - settings.scale_limit, 1 + settings.scale_limit),
        angles=torch.randn((b, 3), generator=generator, device=device),
        shift=uniform((b, 3), -settings.shift_limit, settings.shift_limit),
    )


def _center_radius(xyz: torch.Tensor):
    center = xyz.mean(dim=1, keepdim=True)
    d = xyz - center
    return center, torch.sqrt((d * d).sum(-1)).mean(dim=1)


def perturbate_point_cloud_device(
    xyz: torch.Tensor, settings: AugmentationSettings, draws: AugmentationDraws
) -> torch.Tensor:
    """Augment a batch (B, N, 3) on its device with the given draws, in the
    JAX version's order of operations."""
    # jitter, scaled by the radius of the input cloud
    _, radius = _center_radius(xyz)
    noise = torch.clamp(
        radius[:, None, None] * settings.jitter_variance * draws.jitter,
        -settings.jitter_limit, settings.jitter_limit,
    )
    xyz = xyz + noise
    # scale about the centroid
    center = xyz.mean(dim=1, keepdim=True)
    xyz = (xyz - center) * draws.scale[:, None, None] + center
    # rotation about the centroid
    sigmas = torch.tensor(settings.rotation_angle_variances, dtype=xyz.dtype, device=xyz.device)
    limits = torch.tensor(settings.rotation_angle_limits, dtype=xyz.dtype, device=xyz.device)
    angles = torch.minimum(torch.maximum(sigmas * draws.angles, -limits), limits)
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[:, 0]), torch.zeros_like(c[:, 0])
    Rx = torch.stack([one, zero, zero, zero, c[:, 0], -s[:, 0], zero, s[:, 0], c[:, 0]], -1)
    Ry = torch.stack([c[:, 1], zero, s[:, 1], zero, one, zero, -s[:, 1], zero, c[:, 1]], -1)
    Rz = torch.stack([c[:, 2], -s[:, 2], zero, s[:, 2], c[:, 2], zero, zero, zero, one], -1)
    R = Rz.view(-1, 3, 3) @ Ry.view(-1, 3, 3) @ Rx.view(-1, 3, 3)
    center = xyz.mean(dim=1, keepdim=True)
    xyz = (xyz - center) @ R.transpose(-1, -2) + center
    # shift, scaled by the radius after the rotation
    _, radius = _center_radius(xyz)
    return xyz + radius[:, None, None] * draws.shift[:, None, :]
