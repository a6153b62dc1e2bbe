"""The exactness argument of the exact 1-NN kernel's walk, on the CPU.

``csrc/knn.cu::argmin_cull_kernel`` orders the support into a grid of
cells, walks each query's cells in growing shells, culls a cell by the
rounded bound of its slab box and ends the walk by the rounded bound of
everything beyond the shells. It must still return the first entry of a
stable sort by distance, the plain version's order. The CUDA kernel runs
only on a card, so ``recognizer3d_tpu_torch/benchmarks/argmin_cull.py``
models it step by step in numpy (grid, bins, slabs, shells, strict cull,
lexicographic compare), and these tests hold the model against
``knn_topk_plain(support, query, 1)`` on tie-heavy, duplicated, sorted and
unsorted inputs: index and distance, bit for bit.
"""

import numpy as np
import pytest
import torch

from recognizer3d_tpu_torch.benchmarks import argmin_cull as model
from recognizer3d_tpu_torch.benchmarks.knn_cull import box_bound
from recognizer3d_tpu_torch.benchmarks.window_select import sq_dists
from recognizer3d_tpu_torch.ops import knn_kernels, morton


def _cloud(seed, b, n, grid=None, sort=False):
    x = np.random.RandomState(seed).rand(b, n, 3)
    if grid:  # snap to a coarse grid: many exactly tied distances
        x = np.round(x * grid) / grid
    x = torch.tensor(x, dtype=torch.float32)
    return morton.sort_rows(x, morton.morton_order(x)) if sort else x


def _same(s, q, **flags):
    """The model equals the stable sort's first entry on every batch item."""
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, 1)
    same, counts = True, []
    for b in range(s.shape[0]):
        idx, d2, c = model.select(s[b].numpy(), q[b].numpy(), **flags)
        same &= np.array_equal(d2, ref_d[b, :, 0].numpy())
        same &= np.array_equal(idx, ref_i[b, :, 0].numpy())
        counts.append(c)
    return same, counts


@pytest.mark.parametrize(
    "b,n,m,grid,layout",
    [
        (2, 1000, 700, None, "unsorted"),   # a batch, N not a multiple of 32
        (2, 997, 333, 8, "unsorted"),       # heavy ties
        (1, 1500, 1001, 5, "sorted"),       # Morton-sorted, as approx64k's decoder
        (2, 613, 400, 12, "sorted"),
        (1, 800, 500, 6, "duplicates"),     # every point twice, far apart in index
        (1, 1, 50, None, "unsorted"),       # one support point: one cell
        (1, 33, 200, 3, "unsorted"),
        (1, 600, 300, None, "far"),         # queries far outside the support's box
        (1, 600, 300, 7, "flat"),           # a support one cell thick
    ],
)
def test_model_walk_equals_stable_sort(b, n, m, grid, layout):
    s = _cloud(n, b, n, grid, sort=layout == "sorted")
    q = _cloud(m + 1, b, m, grid, sort=layout == "sorted")
    if layout == "duplicates":
        s = torch.cat([s[:, : n // 2], s[:, : n - n // 2].flip(1)], 1).contiguous()
    elif layout == "far":
        q = q * 40 - 20
    elif layout == "flat":
        s[..., 2] = 0.25
    same, counts = _same(s, q)
    assert same
    assert all(c["distances"].max() <= n for c in counts)


@pytest.mark.parametrize("flag", ["strict_cull", "lexicographic"])
def test_either_tie_rule_is_needed(flag):
    """On a tie grid, culling a cell (or ending the walk) on a bound equal
    to the best distance, or comparing distances alone, departs from the
    stable sort: the kernel needs both rules as they are."""
    s = _cloud(3, 1, 1200, grid=6)
    q = _cloud(4, 1, 1500, grid=6)
    assert _same(s, q)[0]
    assert not _same(s, q, **{flag: False})[0]


def test_bounds_never_exceed_a_rounded_distance():
    """The rounded bound of a query to a cell's slab box, and the bound of
    everything beyond a cube of shells, are at most the rounded distance
    of each point they cover; on a grid they are often equal, which is why
    the tests on them must be strict."""
    rng = np.random.RandomState(0)
    pts = (np.round(rng.rand(3000, 3) * 9) / 9 * 1.3 - 0.4).astype(np.float32)
    q = (np.round(rng.rand(300, 3) * 9) / 9 * 2.0 - 0.7).astype(np.float32)
    grid = model.Grid(pts)
    d = sq_dists(q, pts)  # (300, 3000)
    bins = grid.bins(pts)
    lo = np.stack([grid.slab_lo[a][bins[:, a]] for a in range(3)], -1)
    hi = np.stack([grid.slab_hi[a][bins[:, a]] for a in range(3)], -1)
    cell_bound = box_bound(q[:, None], lo[None], hi[None])  # each point's cell
    assert (cell_bound <= d).all()
    assert ((cell_bound == d) & (d > 0)).any()
    c = grid.bins(q)
    for r in range(4):
        beyond = (np.abs(bins[None] - c[:, None]) > r).any(-1)  # (300, 3000)
        bound = grid.outside_bound(q, c, r)
        assert (np.where(beyond, d, np.inf) >= bound[:, None]).all()
        assert ((np.where(beyond, d, -1) == bound[:, None]).any(1)).any()


def test_bins_are_monotone_and_cover_the_grid():
    """A point of a higher bin never has a smaller coordinate (what makes
    the slab bounds exact), and the grid's extreme points take its first
    and last bins."""
    pts = np.random.RandomState(2).rand(5000, 3).astype(np.float32) * [1.0, 0.5, 0.1]
    grid = model.Grid(pts)
    assert grid.dims.tolist() == [22, 11, 3]  # cubic cells, 22 along the longest side
    bins = grid.bins(pts)
    for a in range(3):
        order = np.argsort(pts[:, a], kind="stable")
        assert (np.diff(bins[order, a]) >= 0).all()
        assert bins[:, a].min() == 0 and bins[:, a].max() == grid.dims[a] - 1
    np.testing.assert_array_equal(np.diff(grid.start) >= 0, True)
    assert grid.start[-1] == 5000


def test_walk_cuts_the_distances_at_the_live_shape():
    """At the live frame's upsample (2,500 support points, 16,384 queries,
    both in no spatial order) the walk evaluates under a tenth of the
    brute-force distances."""
    frame = _cloud(5, 1, 16_384)[0].numpy()
    support = frame[np.random.RandomState(6).permutation(16_384)[:2500]]
    _, _, counts = model.select(support, frame)
    assert counts["distances"].sum() * 10 < 2500 * 16_384
    assert counts["shells"].max() <= model.MAX_CELLS_PER_AXIS
