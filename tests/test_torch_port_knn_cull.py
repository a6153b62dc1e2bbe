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


def _with_duplicates(x):
    """Every seventh point repeated in place of its neighbour: exact ties
    at distance 0 and between equal points."""
    x = x.clone()
    idx = np.arange(0, x.shape[1] - 1, 7)
    x[:, idx + 1] = x[:, idx]
    return x


@pytest.mark.parametrize(
    "b,n,k,grid,dups,group",
    [
        (1, 20_000, 32, None, False, 2),  # the encoder's self-KNN shape
        (1, 20_000, 16, 40, False, 2),    # heavy ties
        (1, 19_999, 1, 30, True, 1),      # k = 1, a ragged last tile, duplicates
        (2, 19_000, 32, 25, True, 2),     # a batch: one set of boxes a cloud
    ],
)
def test_selection_at_20000_points_equals_stable_sort(b, n, k, grid, dups, group):
    """At about 20,000 points (many super tiles, boxes from the box pass) the
    walk returns the first k of the stable sort, indices in order, on every
    cloud of a batch; queries are every ninth point of the Morton-sorted
    support, so the walk sees a self-search's geometry at a tenth of the
    plain version's cost."""
    for c in range(b):
        s = _cloud(n + c, n, grid)
        if dups:
            s = _with_duplicates(s)
        q = s[:, ::9].contiguous()
        same, _ = _check(s, q, k, group=group)
        assert same


def test_box_pass_equals_boxes_reduced_from_tiles():
    """The box pass reduces each super tile's box straight from its points;
    reduced from its tiles' boxes instead, it is the same: min and max are
    exact. On a ragged support with duplicates and ties."""
    s = _with_duplicates(_cloud(5, 33 * 1024 + 17, grid=12, sort=False))[0].numpy()
    lo, hi, slo, shi = model.box_pass(s)
    ref_lo, ref_hi = model.tile_boxes(s)
    nt, ns = ref_lo.shape[0], slo.shape[0]
    pad = np.full((ns * model.TILE - nt, 3), np.inf, np.float32)
    ref_slo = np.concatenate([ref_lo, pad]).reshape(ns, model.TILE, 3).min(1)
    ref_shi = np.concatenate([ref_hi, -pad]).reshape(ns, model.TILE, 3).max(1)
    for got, ref in ((lo, ref_lo), (hi, ref_hi), (slo, ref_slo), (shi, ref_shi)):
        np.testing.assert_array_equal(got, ref)
    assert slo.shape == (34, 3)


@pytest.mark.parametrize("group", [1, 2])
def test_sampled_rows_walk_as_in_the_whole_launch(group):
    """``select(rows=...)`` walks the sampled rows (and the other queries of
    their groups) warm-started at their positions in the whole launch: the
    same lists and the same counts as those rows of the whole walk."""
    n, k = 3000, 32
    s = _cloud(11, n, grid=40)[0].numpy()
    idx, d2, counts = model.select(s, s, k, group)
    rows = np.random.RandomState(group).choice(n, 60, replace=False)
    walked = model.query_rows(n, group, rows)
    assert set(rows) <= set(walked) and len(walked) <= group * len(rows)
    s_idx, s_d2, s_counts = model.select(s, s, k, group, rows=rows)
    np.testing.assert_array_equal(s_idx, idx[walked])
    np.testing.assert_array_equal(s_d2, d2[walked])
    for key in ("distances", "tiles", "insertions"):
        np.testing.assert_array_equal(s_counts[key], counts[key][walked])
