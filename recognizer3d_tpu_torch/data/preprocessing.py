"""Point sampling (numpy copy of ``recognizer3d_tpu/data/preprocessing.py``).

The "consistent sampling" contract: a consistent draw reseeds the global
numpy RNG to 0 and restores its state afterwards, so the indices depend
only on ``(n_points, n_sample_points)`` and equal the JAX package's
exactly. Callers may cache them. The other draws come from the global
numpy RNG too, as in the JAX package, so under one seed both packages draw
the same samples.

The balanced, per-class and fractional samplers are the JAX package's numpy
code, so they draw the same indices under the same numpy seed.
:func:`sample_points_device` draws on the device from a ``torch.Generator``
(the JAX package's from a ``jax.random`` key): the same contract, other
draws.
"""

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


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


def sample_points_balanced(
    labels, n_sample_points: int, consistent: bool = False
) -> np.ndarray:
    """Sampling weighted toward under-represented classes: each point draws
    (with replacement) with probability proportional to the number of
    points not in its class. With a single class present it is uniform."""
    labels = np.asarray(labels).ravel()
    n_points = labels.size
    _, class_of, counts = np.unique(labels, return_inverse=True, return_counts=True)
    weight_per_class = (n_points - counts).astype(np.float64)
    if not weight_per_class.all():  # a single class: uniform
        return random_choice(n_points, n_sample_points, consistent=consistent)
    weights = weight_per_class[class_of]
    return random_choice(
        n_points, n_sample_points, p=weights / weights.sum(), consistent=consistent
    )


def sample_points_equal(
    labels, n_sample_points: int, ratio: float = 1.0, consistent: bool = False
) -> np.ndarray:
    """Per-class quota sampling: each class's quota blends an equal share
    (``ratio=1``) with its proportional share (``ratio=0``); the rounding
    drift lands on the largest quota. Within a class, indices draw without
    replacement, padded with duplicates when the quota exceeds the class."""
    labels = np.asarray(labels).ravel()
    classes, counts = np.unique(labels, return_counts=True)
    equal_share = int(np.round(n_sample_points / classes.size))
    prop_share = np.round(counts * (n_sample_points / labels.size)).astype(np.int64)
    quota = np.round(ratio * equal_share + (1.0 - ratio) * prop_share).astype(np.int64)
    quota[np.argmax(quota)] += n_sample_points - quota.sum()

    picks = []
    for cls, n_cls, want in zip(classes, counts, quota):
        pool = np.flatnonzero(labels == cls)
        ind = random_choice(n_cls, min(want, n_cls), replace=False, consistent=consistent)
        if want > n_cls:
            extra = random_choice(n_cls, want - n_cls, replace=True, consistent=consistent)
            ind = np.concatenate([ind, extra])
        picks.append(pool[ind])
    return np.concatenate(picks)


def sample_points_factor(
    n_points: int, factor: float = 0.25, consistent: bool = False
) -> np.ndarray:
    """``int(n_points · factor)`` indices by :func:`sample_points`."""
    return sample_points(n_points, int(n_points * factor), consistent=consistent)


def sample_points_device(
    generator: torch.Generator, n_points: int, n_sample_points: int
) -> torch.Tensor:
    """Random sample indices on the generator's device (int32, shape
    ``(n_sample_points,)``): a prefix of a random permutation (without
    replacement), padded, when more points are asked for than exist, with
    uniform duplicates."""
    device = generator.device
    n_base = min(n_sample_points, n_points)
    idx = torch.randperm(n_points, generator=generator, device=device)[:n_base]
    if n_sample_points > n_points:
        dupl = torch.randint(0, n_points, (n_sample_points - n_points,), generator=generator,
                             device=device)
        idx = torch.cat([idx, dupl])
    return idx.to(torch.int32)


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
