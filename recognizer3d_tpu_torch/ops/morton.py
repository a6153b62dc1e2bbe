"""Morton orders and permutation helpers (counterpart of the geometry helpers
in ``recognizer3d_tpu/ops/knn_pallas.py``).

The network runs each level in Morton-sorted order, so the orders here must
equal the JAX package's exactly: the codes keep its float32 operation order
(normalise, scale by 1023, clip, truncate) and the sort is stable, as
``jnp.argsort`` is.
"""

import torch


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, N) int32 Morton codes (per-cloud normalised)."""
    mn = torch.amin(xyz, dim=1, keepdim=True)
    mx = torch.amax(xyz, dim=1, keepdim=True)
    q = torch.clamp((xyz - mn) / (mx - mn + 1e-9) * 1023.0, 0, 1023).to(
        torch.int32
    )
    return (
        _part1by2(q[..., 0])
        | (_part1by2(q[..., 1]) << 1)
        | (_part1by2(q[..., 2]) << 2)
    )


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int64 stable Morton sort order."""
    return torch.argsort(morton_codes(xyz), dim=1, stable=True)


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation, (N,) or batched (B, N), by one scatter."""
    iota = torch.arange(perm.shape[-1], device=perm.device, dtype=perm.dtype)
    iota = iota.expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, iota)


def sort_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Reorder the point dimension of (B, N, C) by ``order``: (N,) shared by
    the batch, or (B, M) per cloud (M may be smaller than N: a gather)."""
    if order.dim() == 1:
        return x[:, order]
    return torch.gather(
        x, 1, order.unsqueeze(-1).expand(-1, -1, x.shape[-1])
    )


def unsort_results(idx_sorted: torch.Tensor, d2_sorted: torch.Tensor,
                   s_order: torch.Tensor, q_order: torch.Tensor):
    """Map a search run on Morton-sorted clouds back to the given order:
    indices into the sorted support become original support ids, and query
    rows return to the original query order (counterpart of
    ``knn_pallas._unsort_results``). idx (B, M, k) int32, d2 (B, M, k)."""
    B, m, k = idx_sorted.shape
    idx_orig = torch.gather(s_order, 1, idx_sorted.reshape(B, m * k).long())
    idx_orig = idx_orig.reshape(B, m, k).to(torch.int32)
    inv_q = invert_permutation(q_order)
    return sort_rows(idx_orig, inv_q), sort_rows(d2_sorted, inv_q)
