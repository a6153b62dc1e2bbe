"""Annotation picking without vispy (counterpart of
``recognizer3d_tpu/ui/annotation.py``).

A screen click defines a ray (p0, p1) in scene coordinates; the distance of
each cloud point to that ray is the norm of a cross product. A click within
``remove_threshold`` of an annotated point removes it, else the point
nearest the ray is annotated.
"""

from typing import Optional, Tuple

import numpy as np

REMOVE_THRESHOLD = 0.01  # scene units

#: the most points a panel draws of one cloud or overlay
MAX_DISPLAY_POINTS = 10000


def ray_point_distances(p0: np.ndarray, p1: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Distance of each point to the (p0, p1) ray: ‖(p1−p0) × (p0−points)‖
    (p1−p0 of unit length, as the projective transform gives it)."""
    return np.linalg.norm(np.cross(p1 - p0, p0 - points), axis=1)


def pick_annotation(
    p0: np.ndarray,
    p1: np.ndarray,
    cloud: np.ndarray,
    annotation: Optional[np.ndarray],
    remove_threshold: float = REMOVE_THRESHOLD,
) -> Tuple[str, np.ndarray]:
    """Resolve a click ray into an annotation update.

    :param p0, p1: two points on the click ray in scene coordinates.
    :param cloud: (N, 3) point cloud.
    :param annotation: (N,) bool mask or None.
    :return: ("remove" or "add", the new (N,) bool mask).
    """
    if annotation is not None and annotation.any():
        annotated = annotation.astype(bool)
        lookup = np.where(annotated)[0]
        d = ray_point_distances(p0, p1, cloud[annotated])
        nearest = int(np.argmin(d))
        if d[nearest] < remove_threshold:
            new_annotation = annotated.copy()
            new_annotation[lookup[nearest]] = False
            return "remove", new_annotation

    nearest = int(np.argmin(ray_point_distances(p0, p1, cloud)))
    new_annotation = (
        np.zeros(len(cloud), dtype=bool) if annotation is None else annotation.astype(bool).copy()
    )
    new_annotation[nearest] = True
    return "add", new_annotation


def display_subsample(
    pos: Optional[np.ndarray], rng: np.random.Generator, max_points: int = MAX_DISPLAY_POINTS
) -> Optional[np.ndarray]:
    """At most ``max_points`` of ``pos`` to draw: all of them, in order,
    when they fit, else a draw without replacement from ``rng`` (the
    caller's seeded generator, so a panel draws the same points for the
    same clouds in every run)."""
    if pos is None or len(pos) <= max_points:
        return pos
    return pos[rng.choice(len(pos), size=max_points, replace=False), :]
