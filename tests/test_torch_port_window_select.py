"""The exactness argument of the window kernel's selection, on the CPU.

``csrc/knn.cu::knn_window_kernel`` scans each window out of index order
(a warm-start sort around the query group's curve position, then tiles
outward) and must still return the first k of a stable sort by distance,
the plain version's order. The CUDA kernel runs only on a card, so
``recognizer3d_tpu_torch/benchmarks/window_select.py`` models it step by
step in numpy (its groups, warm start, scan order, lexicographic filter
and insertion), and these tests hold the model against
``knn_window_topk_plain`` on tie-heavy inputs: indices in order and
distances, bit for bit.
"""

import numpy as np
import pytest
import torch

from recognizer3d_tpu_torch.benchmarks import window_select as model
from recognizer3d_tpu_torch.ops import knn_kernels, morton
from recognizer3d_tpu_torch.ops.knn import window_starts


def _sorted_cloud(seed, n, grid=None):
    x = np.random.RandomState(seed).rand(1, n, 3)
    if grid:  # snap to a coarse grid: many exactly tied distances
        x = np.round(x * grid) / grid
    x = torch.tensor(x, dtype=torch.float32)
    return morton.sort_rows(x, morton.morton_order(x))


@pytest.mark.parametrize(
    "n,m,w,k,qb,grid",
    [
        (3000, 3000, 256, 8, 512, 8),      # self-KNN, heavy ties
        (3000, 3000, 1024, 32, 512, 16),   # the encoder's k, ties
        (3000, 3000, 1024, 8, 96, None),   # qb not a multiple of the block's 64
        (3000, 2000, 256, 32, 136, 10),    # M < N: the curve position is mapped
        (2500, 2500, 1024, 64, 128, 12),   # two list registers a lane
        (700, 700, 48, 8, 64, 5),          # the warm range is the whole window
    ],
)
def test_model_selection_equals_stable_sort(n, m, w, k, qb, grid):
    s = _sorted_cloud(n + k, n, grid)
    q = s if m == n else _sorted_cloud(m + 1, m, grid)
    starts = window_starts(n, m, w, qb)
    idx, d2, _ = model.select(s[0].numpy(), q[0].numpy(), k, starts, w, qb)
    ref_i, ref_d = knn_kernels.knn_window_topk_plain(
        s, q, k, torch.from_numpy(starts), w, qb
    )
    np.testing.assert_array_equal(d2, ref_d[0].numpy())
    np.testing.assert_array_equal(idx, ref_i[0].numpy())


@pytest.mark.parametrize("c,w,k", [(0, 1024, 32), (500, 1024, 32), (1023, 1024, 8),
                                   (40, 48, 8), (300, 333, 64), (-5, 256, 128)])
def test_scan_order_visits_each_window_point_once(c, w, k):
    order, n_warm = model.scan_order(c, w, k)
    assert sorted(order.tolist()) == list(range(w))
    assert n_warm == min(64 * model.list_registers(k), w)


def test_outward_scan_cuts_insertions():
    """The diagnosis at a small size: on a Morton-sorted cloud the warm
    start and the outward scan leave far fewer insertions than the scan in
    increasing index from the window start."""
    n, w, k, qb = 8192, 1024, 32, 512
    x = _sorted_cloud(3, n)[0].numpy()
    starts = window_starts(n, n, w, qb)
    queries = np.linspace(0, n - 1, 64).astype(np.int64)
    old = model.count_increasing(x, x, k, starts, w, qb, queries)
    _, _, new = model.select(x, x, k, starts, w, qb, queries)
    assert old.min() >= k
    assert new.mean() * 4 < old.mean()
