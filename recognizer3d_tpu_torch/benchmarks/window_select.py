"""A numpy model of the window kernel's selection (``csrc/knn.cu``,
``knn_window_kernel``), and its insertion counts.

    python -m recognizer3d_tpu_torch.benchmarks.window_select

The CUDA kernel cannot run without a card, so this model follows it step by
step on the CPU: the same groups of queries, the same warm start, the same
scan order, the same lexicographic filter and the same insertion into the
best list. ``tests/test_torch_port_window_select.py`` holds its result
against ``ops/knn_kernels.knn_window_topk_plain`` (the first k of a stable
sort by distance), which is the kernel's contract.

The kernel, per CUDA block of up to ``QUERIES_PER_BLOCK`` queries inside one
query block (its window staged once in shared memory), per group of
``GROUP`` consecutive queries that one warp scans together:

1. the group's curve position ``c`` is its middle query's position mapped
   onto the support curve (``mid * N // M``), relative to the window start;
2. warm start: the ``32·E`` window points from ``a0 = clamp(c − 16·E, 0,
   w − 32·E)`` (E = 2R, R = ⌈k/32⌉ rounded up to 1, 2 or 4) are sorted by
   (distance, index) and the first ``32·R`` kept as the best list; ``theta``
   is its k-th entry, an upper bound of the true k-th;
3. the rest of the window is scanned outward from the warm range in rings:
   ring t is the tile of 32 right of the range scanned so far, then the
   tile of 32 left of it (a side that has run out of window is empty);
4. a point enters the list when (d, j) < theta lexicographically, at the
   position after every entry lexicographically below it; the last entry
   drops and theta becomes the new k-th entry.

The window search's former scan (``knn_topk_kernel`` over the window, in
increasing index from the window start with theta = +inf) is modelled too,
for the count.
"""

import importlib.machinery
import importlib.util
from pathlib import Path

import numpy as np

#: queries a warp scans together, and queries a CUDA block owns
GROUP = 2
QUERIES_PER_BLOCK = 32
_TILE = 32
_SENTINEL = np.iinfo(np.int32).max


def list_registers(k: int) -> int:
    """R: best-list registers per lane (capacity 32·R >= k)."""
    return 1 if k <= 32 else 2 if k <= 64 else 4


def sq_dists(query: np.ndarray, points: np.ndarray) -> np.ndarray:
    """((dx² + dy²) + dz²) in float32, one rounding per operation, as the
    kernel's ``__fsub_rn``/``__fmul_rn``/``__fadd_rn``: (..., 3) queries
    against (..., w, 3) points -> (..., w)."""
    d = query[..., None, :].astype(np.float32) - points.astype(np.float32)
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def groups(m: int, qb: int):
    """(first query, query count) of every warp group, as the kernel forms
    them: CUDA blocks of up to QUERIES_PER_BLOCK queries inside each query
    block, groups of GROUP consecutive queries inside each CUDA block."""
    out = []
    for jb in range(-(-m // qb)):
        for lo in range(jb * qb, min(jb * qb + qb, m), QUERIES_PER_BLOCK):
            hi = min(lo + QUERIES_PER_BLOCK, jb * qb + qb, m)
            for g0 in range(lo, hi, GROUP):
                out.append((g0, min(GROUP, hi - g0)))
    return out


def scan_order(c: int, w: int, k: int) -> "tuple[np.ndarray, int]":
    """Window positions in the kernel's order for a group at curve position
    ``c``: the warm range first (its ``n_warm`` points), then ring by ring
    the right tile and the left tile. Returns (order (w,), n_warm)."""
    e = 2 * list_registers(k)
    a0 = min(max(c - 16 * e, 0), max(w - 32 * e, 0))
    parts = [np.arange(a0, min(a0 + 32 * e, w))]
    n_rings = max(-(-(w - a0 - 32 * e) // _TILE), -(-a0 // _TILE), 0)
    for t in range(n_rings):
        for base in (a0 + _TILE * (e + t), a0 - _TILE * (t + 1)):
            pos = np.arange(base, base + _TILE)
            parts.append(pos[(pos >= 0) & (pos < w)])
    return np.concatenate(parts), len(parts[0])


def _lex_less(ad, ai, bd, bi):
    return (ad < bd) | ((ad == bd) & (ai < bi))


def _scan(d: np.ndarray, order: np.ndarray, n_warm: int, k: int, cap: int):
    """Sequential selection over (Q, w) distances, each row in its own
    ``order`` (Q, w) of window positions: the first ``n_warm`` sorted at
    once, then one insertion test per point. Returns the (Q, cap) lists
    (distance, window index) and the insertions per row."""
    q = d.shape[0]
    rows = np.arange(q)
    wi = order[:, :n_warm]
    wd = np.take_along_axis(d, wi, -1)
    srt = np.lexsort((wi, wd), axis=-1)[:, :cap]
    best_d = np.full((q, cap), np.inf, np.float32)
    best_i = np.full((q, cap), _SENTINEL, np.int64)
    best_d[:, : srt.shape[1]] = np.take_along_axis(wd, srt, -1)
    best_i[:, : srt.shape[1]] = np.take_along_axis(wi, srt, -1)
    inserted = np.zeros(q, np.int64)
    slots = np.arange(cap)
    for t in range(n_warm, d.shape[1]):
        j = order[:, t]
        cd = d[rows, j]
        take = _lex_less(cd, j, best_d[:, k - 1], best_i[:, k - 1])
        if not take.any():
            continue
        r, cd, j = rows[take], cd[take, None], j[take, None]
        bd, bi = best_d[r], best_i[r]
        pos = _lex_less(bd, bi, cd, j).sum(-1, keepdims=True)
        prev_d = np.concatenate([bd[:, :1], bd[:, :-1]], -1)
        prev_i = np.concatenate([bi[:, :1], bi[:, :-1]], -1)
        best_d[r] = np.where(slots < pos, bd, np.where(slots == pos, cd, prev_d))
        best_i[r] = np.where(slots < pos, bi, np.where(slots == pos, j, prev_i))
        inserted[r] += 1
    return best_d, best_i, inserted


def select(support, query, k, starts, w, qb, queries=None):
    """The kernel's selection for a batch-free Morton-sorted support (N, 3)
    and query (M, 3): (idx (M', k) into the support, d2 (M', k), insertions
    after the warm start (M',)) for the rows ``queries`` (all by default)."""
    n, m = support.shape[0], query.shape[0]
    queries = np.arange(m) if queries is None else np.asarray(queries)
    orders = np.zeros((m, w), np.int64)
    want = np.zeros(m, bool)
    want[queries] = True
    n_warm = 0
    for g0, nq in groups(m, qb):
        if want[g0 : g0 + nq].any():
            mid = g0 + nq // 2
            orders[g0 : g0 + nq], n_warm = scan_order(
                mid * n // m - int(starts[g0 // qb]), w, k
            )
    s = starts[queries // qb].astype(np.int64)
    d = sq_dists(query[queries], support[s[:, None] + np.arange(w)])
    best_d, best_i, inserted = _scan(
        d, orders[queries], n_warm, k, 32 * list_registers(k)
    )
    return best_i[:, :k] + s[:, None], best_d[:, :k], inserted


def count_increasing(support, query, k, starts, w, qb, queries):
    """Insertions per query of the former scan: the window in increasing index
    from its start, theta = +inf until the list holds k points."""
    queries = np.asarray(queries)
    s = starts[queries // qb].astype(np.int64)
    d = sq_dists(query[queries], support[s[:, None] + np.arange(w)])
    order = np.broadcast_to(np.arange(w), d.shape)
    return _scan(d, order, 0, k, 32 * list_registers(k))[2]


def _mock_frame(frame_points: int, seed: int = 300) -> np.ndarray:
    """A mock frame of ``bin/make_mock_data`` (``frame_points`` points, in
    the order it makes them)."""
    root = Path(__file__).resolve().parents[2]
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(root / "bin" / "make_mock_data")
    )
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module.make_frame(np.random.RandomState(seed), 0.0, frame_points)[0]


def _mock_level0(points: int = 65_536, frame_points: int = 150_000):
    """A Morton-sorted level-0 cloud of the approx64k path: a mock frame
    of ``frame_points`` points, its consistent ``points``-point sample,
    sorted by the port's Morton order."""
    import torch

    from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
    from recognizer3d_tpu_torch.ops.morton import morton_order

    frame = _mock_frame(frame_points)
    cloud = frame[consistent_sample_indices(frame_points, points)]
    order = morton_order(torch.from_numpy(cloud)[None])[0].numpy()
    return cloud[order]


def main() -> None:
    from recognizer3d_tpu_torch.ops.knn import window_starts

    n, w, k, qb, samples = 65_536, 4096, 32, 512, 256
    x = _mock_level0(n)
    starts = window_starts(n, n, w, qb)
    queries = np.linspace(0, n - 1, samples).astype(np.int64)
    old = count_increasing(x, x, k, starts, w, qb, queries)
    _, _, new = select(x, x, k, starts, w, qb, queries)
    cap = 32 * list_registers(k)
    print(f"level 0 of a mock frame (seed 300, 150,000 -> {n} points, Morton-sorted), "
          f"w={w}, k={k}, {samples} evenly spaced queries")
    print(f"former scan (increasing index, theta=+inf): insertions per query mean "
          f"{old.mean():.2f}, median {np.median(old):.0f}, max {old.max()}")
    print(f"warm start ({2 * cap} points sorted, first {cap} kept) + outward scan: "
          f"insertions per query mean {new.mean():.2f}, median {np.median(new):.0f}, "
          f"max {new.max()}")


if __name__ == "__main__":
    main()
