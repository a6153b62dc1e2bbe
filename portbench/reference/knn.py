"""Exact k-nearest neighbours in plain PyTorch, in blocks that fit.

Queries are taken in blocks of nearby points (sorted by a Morton code of
their own). For each block, the distances to a window of support points
that lie near it in the same order bound each query's k-th distance from
above; every support point inside the block's box, widened by the largest
such bound, is a candidate, and the k nearest candidates are the k nearest
points. Distances are ``(dx·dx + dy·dy) + dz·dz``, one rounding per
operation; ties go to the lower support index.
"""

import torch

_WINDOW = 512          # support points each side of a block's Morton range
_BLOCK = 1024          # queries a block
_MAX_PAIRS = 1 << 27   # distances held at once; a block with more splits


def _d2(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    dx = q[:, 0:1] - s[None, :, 0]
    dy = q[:, 1:2] - s[None, :, 1]
    dz = q[:, 2:3] - s[None, :, 2]
    return (dx * dx + dy * dy) + dz * dz


def morton_codes(xyz: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(N, 3) -> (N,) int64 codes of 10 bits an axis over the box [lo, hi]."""
    q = ((xyz - lo) / (hi - lo + 1e-9) * 1023.0).clamp(0, 1023).long()
    code = torch.zeros(xyz.shape[0], dtype=torch.long, device=xyz.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def _select(d2: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row, ties to the earlier column (ids rise)."""
    d_sorted, order = torch.sort(d2, dim=1, stable=True)
    return ids[order[:, :k]], d_sorted[:, :k]


def _block(support, q, k, s_sorted, s_codes, q_codes):
    lo = int(torch.searchsorted(s_codes, q_codes[:1]).item())
    hi = int(torch.searchsorted(s_codes, q_codes[-1:], right=True).item())
    n = s_sorted.shape[0]
    a, b = max(0, lo - _WINDOW), min(n, hi + _WINDOW)
    if b - a < k:
        a, b = 0, n
    bound = _d2(q, s_sorted[a:b]).kthvalue(k, dim=1).values.max()
    r = torch.sqrt(bound) * (1 + 1e-5) + 1e-12
    box_lo, box_hi = q.amin(0) - r, q.amax(0) + r
    inside = ((support >= box_lo) & (support <= box_hi)).all(dim=1)
    ids = torch.nonzero(inside)[:, 0]
    if ids.numel() * q.shape[0] > _MAX_PAIRS and q.shape[0] > 1:
        h = q.shape[0] // 2
        first = _block(support, q[:h], k, s_sorted, s_codes, q_codes[:h])
        second = _block(support, q[h:], k, s_sorted, s_codes, q_codes[h:])
        return torch.cat([first[0], second[0]]), torch.cat([first[1], second[1]])
    return _select(_d2(q, support[ids]), ids, k)


def knn(support: torch.Tensor, query: torch.Tensor, k: int):
    """Exact k nearest of (N, 3) ``support`` for each of (M, 3) ``query``:
    (indices (M, k) int64 into support, squared distances (M, k)), nearest
    first."""
    both = torch.cat([support, query])
    lo, hi = both.amin(0), both.amax(0)
    s_codes = morton_codes(support, lo, hi)
    s_codes, s_order = torch.sort(s_codes, stable=True)
    s_sorted = support[s_order]
    q_codes = morton_codes(query, lo, hi)
    q_codes, q_order = torch.sort(q_codes, stable=True)
    m = query.shape[0]
    idx = torch.empty((m, k), dtype=torch.long, device=query.device)
    d2 = torch.empty((m, k), dtype=query.dtype, device=query.device)
    for start in range(0, m, _BLOCK):
        rows = q_order[start:start + _BLOCK]
        i, d = _block(support, query[rows], k, s_sorted, s_codes,
                      q_codes[start:start + _BLOCK])
        idx[rows], d2[rows] = i, d
    return idx, d2
