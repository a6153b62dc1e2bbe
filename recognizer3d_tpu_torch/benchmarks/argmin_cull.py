"""A numpy model of the exact 1-NN kernel's walk (``csrc/knn.cu``,
``argmin_cull_kernel``), and its work counts.

    python -m recognizer3d_tpu_torch.benchmarks.argmin_cull

The CUDA kernel cannot run without a card, so this model follows it step by
step on the CPU: the same grid, the same bins, the same slab bounds, the
same walk in growing shells of cells, the same strict cull and the same
lexicographic compare. ``tests/test_torch_port_argmin_cull.py`` holds its
result against ``ops/knn_kernels.knn_topk_plain(support, query, 1)`` (the
first entry of a stable sort by distance), which is the kernel's contract.

The kernel, per support cloud (N points in any order) and query:

1. the grid: the support's bounding box ``[lo, hi]``; ``g`` cells along its
   longest side, the least integer with ``g³ >= 2N`` (at most
   :data:`MAX_CELLS_PER_AXIS`); one scale ``inv = g / ext_max`` for all
   three axes, so cells are cubes, and ``G_a = min(int(ext_a · inv) + 1, g)``
   cells along axis ``a``;
2. a point's bin along axis ``a`` is ``int(clamp((x_a − lo_a) · inv, 0,
   G_a − 1))`` in float32, one rounding per operation. Every step is
   monotone in ``x_a``, so a point of a higher bin never has a smaller
   coordinate: the slab bounds below hold exactly, whatever the rounding;
3. the support is counting-sorted by cell (in shared memory, per CUDA
   block, where it fits; else once, by an order launch, into global
   memory); the order within a cell is arbitrary, so the model takes the
   worst one for ties, decreasing index. For each axis and bin, the least
   and the largest coordinate of its points (``slab_lo``, ``slab_hi``);
   their suffix minima and prefix maxima bound every point beyond a bin;
4. a query walks the cells in growing shells around its own (clamped) cell:
   shell ``r`` holds the cells at Chebyshev distance ``r``, visited plane
   by plane (z), row by row (y), cell by cell (x). A plane, a row or a
   non-empty cell is skipped when the bound of its slab gaps (B1's rounded
   bound: the plane's z gap alone, the row's y and z gaps, the cell's
   three) is strictly greater than the best distance of that moment; a
   point replaces the best when ``(d, j) < (best_d, best_j)``
   lexicographically. (The kernel splits a cell's points among a few lanes
   and merges their bests after the cell, so that every decision sees the
   best this sequential walk has; the counts are the same);
5. after shell ``r``, every point not yet scanned lies beyond the cube of
   shells ``0..r`` along some axis, so its rounded distance is at least the
   least, over the six sides, of ``((gx² + gy²) + gz²)``: the side's gap to
   the suffix minimum (or prefix maximum) beyond the cube, the other two
   axes' gaps to the bounding box. The walk ends when that bound is
   strictly greater than the best distance, or when the cube covers the
   grid.

A bound equal to the best distance can hide a point at that distance with
a smaller index, which the stable sort puts first; hence the strict tests.
The flags ``strict_cull=False`` (skip a cell, and stop, on a bound equal to
the best) and ``lexicographic=False`` (compare distances alone) exist to
show, in the tests, that either change breaks the stable sort's order on
tied distances. The kernel has no such flags.
"""

import numpy as np

from recognizer3d_tpu_torch.benchmarks.knn_cull import box_bound

#: cells along the longest side of the support's box, at most
MAX_CELLS_PER_AXIS = 32
#: a longest side below this takes one cell (no division by ~0)
MIN_EXTENT = np.float32(1e-30)
_F = np.float32


def cells_per_axis(n: int) -> int:
    """``g``, the least integer with ``g³ >= 2n``, at most
    :data:`MAX_CELLS_PER_AXIS`."""
    g = 1
    while g < MAX_CELLS_PER_AXIS and g * g * g < 2 * n:
        g += 1
    return g


class Grid:
    """The kernel's grid over a support cloud (N, 3) float32."""

    def __init__(self, support: np.ndarray):
        support = np.asarray(support, np.float32)
        n = support.shape[0]
        self.lo = support.min(0)
        self.hi = support.max(0)
        ext = self.hi - self.lo
        ext_max = ext.max()
        g = cells_per_axis(n)
        self.inv = _F(g) / ext_max if ext_max >= MIN_EXTENT else _F(0)
        self.dims = np.minimum((ext * self.inv).astype(np.int32) + 1, g)
        bins = self.bins(support)
        self.cell = self.cell_of(bins)
        # counting sort by cell; inside a cell, decreasing index
        self.order = np.lexsort((-np.arange(n), self.cell))
        self.points = support[self.order]
        n_cells = int(np.prod(self.dims))
        counts = np.bincount(self.cell, minlength=n_cells)
        self.start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.slab_lo, self.slab_hi, self.sfx_lo, self.pfx_hi = [], [], [], []
        for a in range(3):
            lo = np.full(self.dims[a], np.inf, np.float32)
            hi = np.full(self.dims[a], -np.inf, np.float32)
            np.minimum.at(lo, bins[:, a], support[:, a])
            np.maximum.at(hi, bins[:, a], support[:, a])
            self.slab_lo.append(lo)
            self.slab_hi.append(hi)
            # sfx_lo[j]: least coordinate in bins >= j (inf at j = G);
            # pfx_hi[j]: largest coordinate in bins <= j
            self.sfx_lo.append(np.append(np.minimum.accumulate(lo[::-1])[::-1], np.inf)
                               .astype(np.float32))
            self.pfx_hi.append(np.maximum.accumulate(hi))

    def bins(self, x: np.ndarray) -> np.ndarray:
        """(..., 3) int32 bins of (..., 3) points, clamped to the grid."""
        t = (np.asarray(x, np.float32) - self.lo) * self.inv
        t = np.fmax(np.fmin(t, (self.dims - 1).astype(np.float32)), _F(0))
        return t.astype(np.int32)

    def slab_gap(self, q: np.ndarray, bins: np.ndarray, a: int) -> np.ndarray:
        """(M,) gap along axis ``a`` of each query to its slab ``bins``
        (infinite for an empty slab)."""
        zero = _F(0)
        return (np.maximum(self.slab_lo[a][bins] - q[:, a], zero)
                + np.maximum(q[:, a] - self.slab_hi[a][bins], zero))

    def cell_of(self, bins: np.ndarray) -> np.ndarray:
        gx, gy, _ = self.dims
        return (bins[..., 2] * gy + bins[..., 1]) * gx + bins[..., 0]

    def outside_bound(self, q: np.ndarray, c: np.ndarray, r: int) -> np.ndarray:
        """(M,) lower bound of the rounded distance of each query to every
        point outside the cube of bins ``c ± r``: the least over the six
        sides, each the side's gap beyond the cube with the other axes'
        gaps to the bounding box."""
        zero = _F(0)
        box_gap = np.maximum(self.lo - q, zero) + np.maximum(q - self.hi, zero)  # (M, 3)
        best = np.full(q.shape[0], np.inf, np.float32)
        for a in range(3):
            up = c[:, a] + r + 1
            sfx = self.sfx_lo[a][np.minimum(up, self.dims[a])]
            gap_up = np.where(up < self.dims[a], np.maximum(sfx - q[:, a], zero), np.inf)
            down = c[:, a] - r - 1
            pfx = self.pfx_hi[a][np.maximum(down, 0)]
            gap_down = np.where(down >= 0, np.maximum(q[:, a] - pfx, zero), np.inf)
            for gap in (gap_up, gap_down):
                g = box_gap.copy()
                g[:, a] = gap
                sq = (g * g).astype(np.float32)
                bound = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
                best = np.minimum(best, bound)
        return best


def _bound(gx, gy, gz):
    """((gx² + gy²) + gz²) in float32, one rounding per operation."""
    return (gx * gx + gy * gy) + gz * gz


def _shell(r: int):
    """The (dx, dy, dz) offsets at Chebyshev distance r, in the kernel's
    order: z outer, y, x inner."""
    rng = range(-r, r + 1)
    return [(dx, dy, dz) for dz in rng for dy in rng for dx in rng
            if max(abs(dx), abs(dy), abs(dz)) == r]


def select(support, query, strict_cull=True, lexicographic=True):
    """The kernel's 1-NN for a batch-free support (N, 3) and query (M, 3) in
    any order: (idx (M,), d2 (M,), counts), counts holding per query the
    distances evaluated (``"distances"``), the non-empty cells scanned
    (``"cells"``), the cells whose start is looked up (``"lookups"``) and
    the shells walked (``"shells"``)."""
    support = np.asarray(support, np.float32)
    query = np.asarray(query, np.float32)
    m = query.shape[0]
    grid = Grid(support)
    c = grid.bins(query)
    best_d = np.full(m, np.inf, np.float32)
    best_i = np.zeros(m, np.int64)  # all distances infinite: index 0
    counts = {key: np.zeros(m, np.int64) for key in ("distances", "cells", "lookups", "shells")}
    active = np.ones(m, bool)
    dims = grid.dims
    reach = np.maximum(c, dims - 1 - c).max(1)  # the shell that covers the grid
    r = 0
    zero = np.zeros(m, np.float32)
    keep = (lambda bound: bound <= best_d) if strict_cull else (lambda bound: bound < best_d)
    while active.any():
        counts["shells"][active] += 1
        prev = None
        for off in _shell(r):
            b = c + np.array(off)
            inside = active & ((b >= 0) & (b < dims)).all(1)
            # a plane, then a row, is skipped on entry when the bound of its
            # gaps alone is strictly greater than the best of that moment
            if prev is None or off[2] != prev[2]:
                gz = grid.slab_gap(query, np.clip(b[:, 2], 0, dims[2] - 1), 2)
                plane_ok = keep(_bound(zero, zero, gz))
            if prev is None or off[1:] != prev[1:]:
                gy = grid.slab_gap(query, np.clip(b[:, 1], 0, dims[1] - 1), 1)
                row_ok = plane_ok & keep(_bound(zero, gy, gz))
            prev = off
            inside &= row_ok
            q_in = np.flatnonzero(inside)
            if q_in.size == 0:
                continue
            bq = b[q_in]
            cell = grid.cell_of(bq)
            first, last = grid.start[cell], grid.start[cell + 1]
            counts["lookups"][q_in] += 1
            lo = np.stack([grid.slab_lo[a][bq[:, a]] for a in range(3)], -1)
            hi = np.stack([grid.slab_hi[a][bq[:, a]] for a in range(3)], -1)
            lb = box_bound(query[q_in], lo, hi)
            open_ = lb <= best_d[q_in] if strict_cull else lb < best_d[q_in]
            open_ &= last > first
            q_in, first, last = q_in[open_], first[open_], last[open_]
            counts["cells"][q_in] += 1
            for j in range(int((last - first).max(initial=0))):
                has = first + j < last
                qs, at = q_in[has], (first + j)[has]
                counts["distances"][qs] += 1
                diff = query[qs] - grid.points[at]
                sq = diff * diff
                d = (sq[:, 0] + sq[:, 1]) + sq[:, 2]
                idx = grid.order[at]
                take = d < best_d[qs]
                if lexicographic:
                    take |= (d == best_d[qs]) & (idx < best_i[qs])
                best_d[qs[take]] = d[take]
                best_i[qs[take]] = idx[take]
        bound = grid.outside_bound(query, c, r)
        more = bound <= best_d if strict_cull else bound < best_d
        active &= more & (r < reach)
        r += 1
    return best_i.astype(np.int32), best_d, counts


def served_cases():
    """(label, support, query) of the served paths' 1-NN upsamples on mock
    frames, float32 numpy: app, the 2,500-point subsample (subsample order)
    onto the 60,000-point frame (the order the mock makes it) bucket-padded
    with zero points to 61,440; live, the 2,500-point subsample of 16,384
    display points in random order onto them; approx64k, the decoder's
    4,096 -> 16,384 and 16,384 -> 65,536 upsamples, all Morton-sorted."""
    from recognizer3d_tpu_torch.benchmarks.window_select import _mock_frame, _mock_level0
    from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices

    frame = _mock_frame(60_000, seed=100)
    padded = np.concatenate([frame, np.zeros((1440, 3), np.float32)])
    display = frame[np.random.RandomState(1).permutation(60_000)[:16_384]]
    levels = {n: _mock_level0(n, 150_000) for n in (4096, 16_384, 65_536)}
    return [
        ("app 2,500 -> 61,440", frame[consistent_sample_indices(60_000, 2500)], padded),
        ("live 2,500 -> 16,384", display[consistent_sample_indices(16_384, 2500)], display),
        ("approx64k 4,096 -> 16,384", levels[4096], levels[16_384]),
        ("approx64k 16,384 -> 65,536", levels[16_384], levels[65_536]),
    ]


def main() -> None:
    for label, s, q in served_cases():
        _, _, counts = select(s, q)
        n = s.shape[0]
        print(f"{label}: N={n} M={q.shape[0]}, brute force {n} distances a query", flush=True)
        for key in ("distances", "cells", "lookups", "shells"):
            v = counts[key]
            print(f"  {key} per query mean {v.mean():.2f}, median {np.median(v):.0f}, "
                  f"max {v.max()}", flush=True)

if __name__ == "__main__":
    main()
