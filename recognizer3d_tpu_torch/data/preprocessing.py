"""Point sampling (numpy copy of ``recognizer3d_tpu/data/preprocessing.py``).

The "consistent sampling" contract: a consistent draw reseeds the global
numpy RNG to 0 and restores its state afterwards, so the indices depend
only on ``(n_points, n_sample_points)`` and equal the JAX package's
exactly. Callers may cache them. The other draws come from the global
numpy RNG too, as in the JAX package, so under one seed both packages draw
the same samples.

The balanced, per-class and fractional samplers are not ported: nothing in
either package calls them.
"""

from functools import lru_cache
from typing import Optional

import numpy as np


def random_choice(
    a: int,
    size: int,
    replace: bool = True,
    p: Optional[np.ndarray] = None,
    consistent: bool = False,
) -> np.ndarray:
    """``np.random.choice``; with ``consistent`` the global RNG is reseeded
    to 0 for the draw and restored afterwards."""
    if consistent:
        rnd_state = np.random.get_state()
        np.random.seed(0)
    value = np.random.choice(a, size, replace, p)
    if consistent:
        np.random.set_state(rnd_state)
    return value


def sample_points(
    n_points: int, n_sample_points: int, consistent: bool = False
) -> np.ndarray:
    """Random sub- or upsample point indices: without replacement while
    possible, padded with random duplicates when more points are asked
    for than exist."""
    sample_indices = random_choice(
        n_points,
        min(n_sample_points, n_points),
        replace=False,
        consistent=consistent,
    )
    if n_sample_points > n_points:
        n_points_dupl = n_sample_points - n_points
        sample_indices_dupl = random_choice(
            n_points, n_points_dupl, replace=True, consistent=consistent
        )
        sample_indices = np.r_[sample_indices, sample_indices_dupl]
    return sample_indices


@lru_cache(maxsize=64)
def consistent_sample_indices(n_points: int, n_sample_points: int) -> np.ndarray:
    """Cached consistent (seed-0) sample indices, read-only."""
    out = sample_points(n_points, n_sample_points, consistent=True)
    out.setflags(write=False)
    return out


def normalize_cloud(xyz: np.ndarray, normalization: Optional[str]) -> np.ndarray:
    """Center and radius normalization. ``normalization`` in {None, "mean",
    "max", "stdev"}; any other string centers without scaling."""
    if normalization is None:
        return xyz
    center = np.mean(xyz, axis=0, keepdims=True)
    xyz = xyz - center
    norms = np.linalg.norm(xyz, axis=1)
    if normalization == "mean":
        radius = np.mean(norms)
    elif normalization == "max":
        radius = np.max(norms)
    elif normalization == "stdev":
        radius = np.std(norms)
    else:
        radius = 1.0
    return xyz / radius
