"""A numpy model of the exact KNN kernel's selection (``csrc/knn.cu``,
``knn_cull_kernel``), and its work counts.

    python -m recognizer3d_tpu_torch.benchmarks.knn_cull

The CUDA kernel cannot run without a card, so this model follows it step by
step on the CPU: the same tile boxes and rounded box bound, the same warm
start, the same visit order, the same strict cull and the same
lexicographic insertion into the best list.
``tests/test_torch_port_knn_cull.py`` holds its result against
``ops/knn_kernels.knn_topk_plain`` (the first k of a stable sort by
distance), which is the kernel's contract.

The kernel, per group of ``group`` consecutive queries that one warp
serves together (1 or 2: the launcher's ``cull_group`` in ``csrc/knn.cu``
owns that policy, so the model takes it as an argument; a short last group
repeats its last query):

1. the support is cut into tiles of 32 consecutive points, each with its
   bounding box; the bound of a query to a box is ((gx² + gy²) + gz²) of
   the gaps ``max(lo − q, 0) + max(q − hi, 0)``, rounded at every step as
   the distance is, so it never exceeds the rounded distance of a point in
   the box (correctly rounded operations are monotone);
2. warm start: the group's curve position ``c`` is its middle query's
   position mapped onto the support (``mid * N // M``); the ``E = 2R``
   tiles around it (R = ⌈k/32⌉ rounded up to 1, 2 or 4) are sorted by
   (distance, index) and the first ``32·R`` points kept as the best list;
   ``theta`` is its k-th entry;
3. the other tiles are walked nearest-box-first in two levels: batches of
   32 super tiles (32 tiles each) in increasing index; in a batch, the
   alive super tile of least bound next, and in it the alive tile of least
   bound next (ties to the lower index), the key being the least bound over
   the group's queries. A tile or super tile is alive while its bound is at
   most ``theta``'s distance for some query of the group: one whose bound
   equals it can hold a point at that distance with a smaller index, which
   the stable sort puts first, so the cull is strict;
4. a point of a visited tile enters a query's list when (d, j) < theta
   lexicographically, at the position after every entry lexicographically
   below it; the last entry drops and theta becomes the new k-th entry.

Where the boxes come from: up to 2,048 support points each CUDA block
builds them in its shared memory; above, one launch before the walk
(``knn_box_kernel``) boxes each tile in a warp and each super tile from
its 32 tiles' boxes, into a global scratch (``box_pass``). Min and max are
exact, so both give the walk the same boxes, and the same selection
(the model reduces a super tile straight from its points: the same
values).

``select(..., rows=...)`` walks only some query rows (with the other
queries of their groups), each warm-started at its position in the whole
launch, so that the work of a launch too large for the model can be
sampled.

The flags ``strict_cull=False`` (cull on ``bound >= theta``) and
``lexicographic=False`` (filter and place by distance alone, as a scan in
increasing index may) exist to show, in the tests, that either change
breaks the stable sort's order on tied distances. The kernel has no such
flags.
"""

import numpy as np

from recognizer3d_tpu_torch.benchmarks.window_select import (
    count_increasing, list_registers, sq_dists,
)

#: support points a tile (and tiles a super tile)
TILE = 32
_SENTINEL = np.iinfo(np.int32).max


def tile_boxes(support: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(lo, hi), each (ceil(N / 32), 3) float32: the bounding box of each
    tile of 32 consecutive support points (the last tile may be short)."""
    n = support.shape[0]
    nt = -(-n // TILE)
    pad = nt * TILE - n
    lo = np.concatenate([support, np.full((pad, 3), np.inf, np.float32)])
    hi = np.concatenate([support, np.full((pad, 3), -np.inf, np.float32)])
    return (lo.reshape(nt, TILE, 3).min(1).astype(np.float32),
            hi.reshape(nt, TILE, 3).max(1).astype(np.float32))


def box_pass(support: np.ndarray):
    """The box pass (``knn_box_kernel``): (lo, hi, slo, shi), each super
    tile's box reduced straight from its points (the kernel reduces its
    tiles' boxes: min and max are exact, so the values are the same)."""
    n = support.shape[0]
    lo, hi = tile_boxes(support)
    span = TILE * TILE
    ns = -(-n // span)
    pad = ns * span - n
    plo = np.concatenate([support, np.full((pad, 3), np.inf, np.float32)])
    phi = np.concatenate([support, np.full((pad, 3), -np.inf, np.float32)])
    return (lo, hi, plo.reshape(ns, span, 3).min(1).astype(np.float32),
            phi.reshape(ns, span, 3).max(1).astype(np.float32))


def box_bound(query: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Lower bound of the rounded squared distance of (..., 3) queries to
    any point of the (..., 3) boxes, in float32 with one rounding per
    operation, in the distance's order."""
    zero = np.float32(0)
    gap = np.maximum(lo - query, zero) + np.maximum(query - hi, zero)
    sq = gap * gap
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def warm_tile(c: int, n_tiles: int, k: int) -> int:
    """First of the 2R warm-start tiles around curve position ``c``."""
    e = 2 * list_registers(k)
    return min(max((c + TILE // 2) // TILE - e // 2, 0), max(n_tiles - e, 0))


def _lex_less(ad, ai, bd, bi):
    return (ad < bd) | ((ad == bd) & (ai < bi))


def query_rows(m: int, group: int, rows=None) -> np.ndarray:
    """The sorted query rows ``select`` walks: all ``m``, or ``rows`` with
    the other queries of their groups of ``group``."""
    if rows is None:
        return np.arange(m)
    heads = np.unique(np.asarray(rows) // group * group)
    walked = np.unique((heads[:, None] + np.arange(group)).ravel())
    return walked[walked < m]


def select(support, query, k, group, strict_cull=True, lexicographic=True, rows=None):
    """The kernel's selection for a batch-free support (N, 3) and query
    (M, 3) in any order, ``group`` (1 or 2) queries a warp: (idx (L, k),
    d2 (L, k), counts) for the L rows of ``query_rows(M, group, rows)``,
    where counts holds per row the distances evaluated (``"distances"``,
    the warm start's included), the tiles visited after the warm start
    (``"tiles"``) and the insertions after the warm start
    (``"insertions"``)."""
    support = np.asarray(support, np.float32)
    query = np.asarray(query, np.float32)
    n, m = support.shape[0], query.shape[0]
    r, nt = list_registers(k), -(-n // TILE)
    e, cap = 2 * r, 32 * r
    lo, hi, slo, shi = box_pass(support)
    rows = query_rows(m, group, rows)
    g0 = rows - rows % group
    nq = np.minimum(group, m - g0)
    tw0 = np.array([warm_tile(c, nt, k) for c in (g0 + nq // 2) * n // m])
    query = query[rows]

    # warm start: 32·E points sorted by (distance, index), 32·R kept
    wi = tw0[:, None] * TILE + np.arange(e * TILE)
    valid = wi < n
    wd = np.where(valid, sq_dists(query, support[np.minimum(wi, n - 1)]), np.inf)
    wi = np.where(valid, wi, _SENTINEL)
    srt = np.lexsort((wi, wd), axis=-1)[:, :cap]
    best_d = np.take_along_axis(wd, srt, -1).astype(np.float32)
    best_i = np.take_along_axis(wi, srt, -1).astype(np.int64)
    counts = {
        "distances": valid.sum(-1),
        "tiles": np.zeros(rows.size, np.int64),
        "insertions": np.zeros(rows.size, np.int64),
    }

    # the walk: super-tile batches in increasing index; in a batch, the
    # alive super tile of least bound next, and in it the alive tile of
    # least bound next, until none is alive (bounds fixed, thetas of the
    # moment)
    ga = np.flatnonzero(rows == g0)  # each group's first row
    gb = ga + nq[ga] - 1  # the group's other query, or itself
    n_groups, ns = ga.size, slo.shape[0]
    lb_t = box_bound(query[:, None], lo[None], hi[None])  # (M, nt)
    lb_s = box_bound(query[:, None], slo[None], shi[None])  # (M, ns)
    tiles = np.arange(nt)
    t_rem = (tiles < tw0[ga, None]) | (tiles >= tw0[ga, None] + e)  # (G, nt)
    s_rem = np.ones((n_groups, ns), bool)
    batch = np.zeros(n_groups, np.int64)
    cur = np.full(n_groups, -1)
    active = np.ones(n_groups, bool)
    lane = np.arange(TILE)

    def pick(lb, rem, first, count):
        """Per group, the alive candidate of least bound among ``count``
        consecutive ones from ``first`` (-1 where none is alive)."""
        idx = first[:, None] + lane
        ok = idx < count
        idx = np.minimum(idx, count - 1)
        a, b = lb[ga[:, None], idx], lb[gb[:, None], idx]
        th_a, th_b = best_d[ga, k - 1, None], best_d[gb, k - 1, None]
        alive = ((a <= th_a) | (b <= th_b)) if strict_cull else ((a < th_a) | (b < th_b))
        alive &= ok & np.take_along_axis(rem, idx, 1)
        key = np.where(alive, np.minimum(a, b), np.inf)
        best = key.argmin(1)
        return np.where(alive.any(1), idx[np.arange(idx.shape[0]), best], -1)

    slots = np.arange(cap)
    while active.any():
        need = np.flatnonzero(active & (cur < 0))
        if need.size:
            s_next = pick(lb_s, s_rem, TILE * batch, ns)[need]
            found = s_next >= 0
            cur[need[found]] = s_next[found]
            s_rem[need[found], s_next[found]] = False
            batch[need[~found]] += 1
            active[need[~found]] &= TILE * batch[need[~found]] < ns
        has = np.flatnonzero(active & (cur >= 0))
        if has.size == 0:
            continue
        t_next = pick(lb_t, t_rem, TILE * np.maximum(cur, 0), nt)[has]
        cur[has[t_next < 0]] = -1
        vis, t_vis = has[t_next >= 0], t_next[t_next >= 0]
        if vis.size == 0:
            continue
        t_rem[vis, t_vis] = False
        two = gb[vis] != ga[vis]
        visit = np.concatenate([ga[vis], gb[vis][two]])
        t_q = np.concatenate([t_vis, t_vis[two]])
        j_all = t_q[:, None] * TILE + lane  # (V, 32)
        valid = j_all < n
        counts["tiles"][visit] += 1
        counts["distances"][visit] += valid.sum(-1)
        d = sq_dists(query[visit][:, None], support[np.minimum(j_all, n - 1)][:, :, None])
        d = d[..., 0]
        for ln in range(TILE):
            bd, bi = best_d[visit], best_i[visit]
            cd, j = d[:, ln], j_all[:, ln]
            if lexicographic:
                take = _lex_less(cd, j, bd[:, k - 1], bi[:, k - 1])
            else:
                take = cd < bd[:, k - 1]
            take &= valid[:, ln]
            if not take.any():
                continue
            q, bd, bi = visit[take], bd[take], bi[take]
            cd, j = cd[take, None], j[take, None]
            if lexicographic:
                pos = _lex_less(bd, bi, cd, j).sum(-1, keepdims=True)
            else:
                pos = (bd <= cd).sum(-1, keepdims=True)
            prev_d = np.concatenate([bd[:, :1], bd[:, :-1]], -1)
            prev_i = np.concatenate([bi[:, :1], bi[:, :-1]], -1)
            best_d[q] = np.where(slots < pos, bd, np.where(slots == pos, cd, prev_d))
            best_i[q] = np.where(slots < pos, bi, np.where(slots == pos, j, prev_i))
            counts["insertions"][q] += 1
    return best_i[:, :k], best_d[:, :k], counts


def main() -> None:
    from recognizer3d_tpu_torch.benchmarks.window_select import _mock_level0

    n, k = 2500, 32
    x = _mock_level0(n, 60_000)
    # one query a warp: a launch of 2,500 queries is one wave on an H100
    _, _, counts = select(x, x, k, 1)
    old = count_increasing(x, x, k, np.zeros(1, np.int32), n, n, np.arange(n))
    print(f"level 0 of a mock frame (seed 300, 60,000 -> {n} points, Morton-sorted), "
          f"self-KNN k={k}, all {n} queries, one a warp")
    print(f"streaming kernel (every tile in increasing index, theta=+inf): distances per query "
          f"{n}, tiles {-(-n // TILE)}, insertions mean {old.mean():.2f}, median "
          f"{np.median(old):.0f}, max {old.max()}")
    for key in ("distances", "tiles", "insertions"):
        v = counts[key]
        print(f"culled kernel (warm start, nearest-box-first walk, strict cull): {key} "
              f"per query mean {v.mean():.2f}, median {np.median(v):.0f}, max {v.max()}")


if __name__ == "__main__":
    main()
