"""The exactness argument of the exact KNN kernel's selection, on the CPU.

``csrc/knn.cu::knn_cull_kernel`` starts each query warm from the tiles
around its curve position, then walks the other support tiles culling by
bounding box, and must still return the first k of a stable sort by
distance, the plain version's order. The CUDA kernel runs only on a card,
so ``recognizer3d_tpu_torch/benchmarks/knn_cull.py`` models it step by step
in numpy (its boxes and rounded bound, warm start, visit order, strict cull
and lexicographic insertion), and these tests hold the model against
``knn_topk_plain`` on tie-heavy, unsorted and k = N inputs: indices in order
and distances, bit for bit.
"""

import numpy as np
import pytest
import torch

from recognizer3d_tpu_torch.benchmarks import knn_cull as model
from recognizer3d_tpu_torch.benchmarks.window_select import count_increasing, sq_dists
from recognizer3d_tpu_torch.ops import knn_kernels, morton


def _cloud(seed, n, grid=None, sort=True):
    x = np.random.RandomState(seed).rand(1, n, 3)
    if grid:  # snap to a coarse grid: many exactly tied distances
        x = np.round(x * grid) / grid
    x = torch.tensor(x, dtype=torch.float32)
    return morton.sort_rows(x, morton.morton_order(x)) if sort else x


def _check(s, q, k, **flags):
    idx, d2, counts = model.select(s[0].numpy(), q[0].numpy(), k, **flags)
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, k)
    same = np.array_equal(d2, ref_d[0].numpy()) and np.array_equal(idx, ref_i[0].numpy())
    return same, counts


@pytest.mark.parametrize(
    "n,m,k,grid,layout,group",
    [
        (1200, None, 32, None, "self", 1),   # the encoder's self-KNN, Morton-sorted
        (1200, None, 32, None, "self", 2),
        (700, None, 8, 8, "self", 2),        # heavy ties
        (700, None, 8, 8, "self", 1),
        (500, None, 64, 12, "self", 2),      # two list registers a lane
        (39, None, 32, None, "self", 1),     # level 3: k close to N, all warm
        (64, None, 64, 10, "self", 2),       # k = N
        (301, None, 1, 8, "self", 2),        # k = 1, an odd M: a short last group
        (301, None, 100, 10, "self", 2),     # four list registers, a short last group
        (1000, 333, 64, None, "sorted_support", 1),
        (900, 300, 33, 10, "sorted_support", 2),  # unsorted queries, sorted support
        (900, 300, 33, 10, "sorted_support", 1),
        (600, 200, 128, 20, "unsorted", 2),  # both unsorted, the widest list
        (40, 40, 40, None, "unsorted", 1),   # k = N, unsorted
    ],
)
def test_model_selection_equals_stable_sort(n, m, k, grid, layout, group):
    s = _cloud(n + k, n, grid, sort=layout != "unsorted")
    q = s if layout == "self" else _cloud(m + 1, m, grid, sort=False)
    same, counts = _check(s, q, k, group=group)
    assert same
    assert counts["distances"].max() <= n


@pytest.mark.parametrize("flag", ["strict_cull", "lexicographic"])
def test_either_tie_rule_is_needed(flag):
    """On a tie grid, culling a tile whose bound equals theta's distance, or
    filtering and placing candidates by distance alone, departs from the
    stable sort: the kernel needs both rules as they are."""
    s = _cloud(708, 700, grid=8)
    assert _check(s, s, 8, group=2)[0]
    assert not _check(s, s, 8, group=2, **{flag: False})[0]


def test_box_bound_never_exceeds_a_rounded_distance():
    """The rounded bound of a query to a tile's box is at most the rounded
    distance to each point of the tile, and on a grid it is often equal,
    which is why the cull must be strict."""
    rng = np.random.RandomState(0)
    pts = (np.round(rng.rand(64 * 32, 3) * 7) / 7 * 1.3 - 0.4).astype(np.float32)
    lo, hi = model.tile_boxes(pts)
    q = (np.round(rng.rand(200, 3) * 7) / 7 * 1.3 - 0.4).astype(np.float32)
    bound = model.box_bound(q[:, None], lo[None], hi[None])  # (200, 64)
    d = sq_dists(q, pts).reshape(200, 64, 32).min(-1)
    assert (bound <= d).all()
    assert ((bound == d) & (bound > 0)).sum() > 0


def test_tile_boxes_cover_a_ragged_last_tile():
    pts = np.random.RandomState(1).rand(70, 3).astype(np.float32)
    lo, hi = model.tile_boxes(pts)
    assert lo.shape == hi.shape == (3, 3)
    np.testing.assert_array_equal(lo[2], pts[64:].min(0))
    np.testing.assert_array_equal(hi[2], pts[64:].max(0))


def test_culling_cuts_distances_and_insertions():
    """The diagnosis at a small size: on a Morton-sorted self-KNN the warm
    start and the cull leave a fraction of the streaming kernel's distances
    (every support point) and insertions (theta = +inf at the start)."""
    n, k = 2000, 32
    x = _cloud(3, n)[0].numpy()
    _, _, counts = model.select(x, x, k, group=1)
    old = count_increasing(x, x, k, np.zeros(1, np.int32), n, n, np.arange(0, n, 8))
    assert counts["distances"].mean() * 3 < n
    assert counts["insertions"].mean() * 4 < old.mean()
    assert counts["tiles"].mean() * 3 < -(-n // model.TILE)
