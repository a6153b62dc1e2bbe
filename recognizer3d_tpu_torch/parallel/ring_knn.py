"""Exact KNN over point-sharded clouds by a ring exchange (counterpart of
``recognizer3d_tpu/parallel/ring_knn.py``).

Each rank keeps its block of queries; the support blocks travel once round
the ring of ranks (:func:`mesh.rotate`, the ``lax.ppermute`` to rank + 1),
and at every step each rank merges the visiting block's candidates into a
running best k, with indices offset to global (block-sharded) ids. A
rank holds O(N/D) points at any time, and no step gathers the whole cloud.

The step's search is the port's exact route, ``ops/knn.knn(visiting,
query, k_step, "naive")``: the KNN kernel (B1) for k >= 2, the 1-NN route
for k = 1. The JAX ring calls ``knn_naive``, which materialises the whole
(m_loc × n_loc) distance matrix: 275 GB a step for a 1,048,576-point cloud
over 4 ranks. The route here has bounded memory, and computes the same
function with other rounding: direct differences, not ‖q‖² + ‖s‖² − 2q·s.

The merge keeps ``lax.top_k``'s order: the running best, then the visiting
block, ties to the earlier, by a stable sort (``torch.topk`` breaks ties
otherwise). So, as in JAX, exact ties across ring steps go to the block that
came first in this rank's ring order, not to the lower global index.

The rows a query picks up carry gradient where autograd records (the
point-sharded train step): :func:`ring_knn_gather`'s table rows and
:func:`ring_gather`'s rows. Their backward is a second trip round the ring
(:func:`_ring_scatter_add`): each rank scatter-adds its rows' cotangents
into an accumulator for the block visiting it, and the accumulator travels
on to the block's owner. Indices and distances carry none (the geometry is
an input).

All functions run inside a rank (see ``mesh.RankPool``), on the ring
``on`` (default: the whole group; a row of a DP×SP grid of ranks); on one
rank they are the single-process search.
"""

from typing import List, Optional, Tuple

import torch

from recognizer3d_tpu_torch.ops.knn import gather_neighbors, knn
from recognizer3d_tpu_torch.parallel import mesh


def _merge(cand_d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest candidates, in ``lax.top_k(-d)``'s order
    (ties to the earlier candidate)."""
    return torch.sort(cand_d, dim=-1, stable=True).indices[..., :k]


def _steps(support: torch.Tensor, query: torch.Tensor, k: int, carried: List[torch.Tensor],
           on: mesh.Ring):
    """Yield (local indices, global indices, d2, carried blocks) of each
    ring step's search of the visiting support block, ``carried``
    travelling with it."""
    d, me = on.size, on.position
    n_loc = support.shape[1]
    k_step = min(k, n_loc)
    visiting = [support, *carried]
    for i in range(d):
        src = (me - i) % d  # the block visiting at step i started on rank me - i
        idx, d2 = knn(visiting[0], query, k_step, "naive")
        yield idx, idx + src * n_loc, d2, visiting[1:]
        if i < d - 1:
            visiting = mesh.rotate(visiting, on)


def ring_knn(
    support: torch.Tensor, query: torch.Tensor, k: int, on: Optional[mesh.Ring] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN with both clouds block-sharded over the ranks:
    :func:`ring_knn_gather` without a row table.

    :param support: (B, n_loc, 3), this rank's block of the support.
    :param query: (B, m_loc, 3), this rank's block of the queries.
    :return: (global indices int32 (B, m_loc, k), squared distances).
    """
    return ring_knn_gather(support, query, None, k, on)[:2]


def ring_knn_gather(
    support: torch.Tensor, query: torch.Tensor, table: Optional[torch.Tensor], k: int,
    on: Optional[mesh.Ring] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Exact KNN and the neighbours' rows in one ring pass: the visiting
    block's ``table`` rows travel with its points, and (distance, index,
    row) triples merge in the running best k. Every query then holds its k
    neighbours' rows locally.

    :param table: (B, n_loc, C) rows of this rank's support block, or None
        (no rows: the third result is None).
    :return: (global indices (B, m_loc, k), squared distances, rows
        (B, m_loc, k, C)); the rows differentiable in ``table``.
    """
    on = mesh.ring() if on is None else on
    if table is not None and table.requires_grad and torch.is_grad_enabled():
        return _RingKnnGather.apply(table, support, query, k, on)
    return _ring_knn_gather(support, query, table, k, on)


def _ring_knn_gather(support, query, table, k: int, on: mesh.Ring):
    b, m, _ = query.shape
    best_d = torch.full((b, m, k), float("inf"), dtype=torch.float32, device=query.device)
    best_i = torch.zeros((b, m, k), dtype=torch.int32, device=query.device)
    best_f = None
    if table is not None:
        best_f = torch.zeros((b, m, k, table.shape[-1]), dtype=table.dtype, device=table.device)
    carried = [] if table is None else [table]
    for idx, gidx, d2, visiting in _steps(support, query, k, carried, on):
        cand_d = torch.cat([best_d, d2], dim=-1)
        sel = _merge(cand_d, k)
        best_d = torch.gather(cand_d, -1, sel)
        best_i = torch.gather(torch.cat([best_i, gidx], dim=-1), -1, sel)
        if table is not None:
            cand_f = torch.cat([best_f, gather_neighbors(visiting[0], idx)], dim=-2)
            best_f = torch.gather(cand_f, -2,
                                  sel[..., None].expand(-1, -1, -1, cand_f.shape[-1]))
    return best_i, torch.clamp(best_d, min=0.0), best_f


def ring_gather(features: torch.Tensor, idx_global: torch.Tensor,
                on: Optional[mesh.Ring] = None) -> torch.Tensor:
    """Rows of a point-sharded table by global ids: the feature blocks travel
    once round the ring, and each query picks up the neighbours whose id
    lies in the visiting block.

    :param features: (B, n_loc, C), this rank's block of the table.
    :param idx_global: (B, m_loc, k) global row ids.
    :return: (B, m_loc, k, C), differentiable in ``features``.
    """
    on = mesh.ring() if on is None else on
    if features.requires_grad and torch.is_grad_enabled():
        return _RingGather.apply(features, idx_global, on)
    return _ring_gather(features, idx_global, on)


def _ring_gather(features: torch.Tensor, idx_global: torch.Tensor, on: mesh.Ring):
    d, me = on.size, on.position
    b, n_loc, c = features.shape
    m, k = idx_global.shape[1], idx_global.shape[2]
    out = torch.zeros((b, m, k, c), dtype=features.dtype, device=features.device)
    visiting = features
    for i in range(d):
        local = idx_global.long() - ((me - i) % d) * n_loc
        hit = (local >= 0) & (local < n_loc)
        got = gather_neighbors(visiting, local.clamp(0, n_loc - 1))
        out = torch.where(hit[..., None], got, out)
        if i < d - 1:
            (visiting,) = mesh.rotate([visiting], on)
    return out


def _ring_scatter_add(cot: torch.Tensor, idx_global: torch.Tensor, n_loc: int,
                      on: mesh.Ring) -> torch.Tensor:
    """The backward of a ring gather: every row's cotangent ``cot`` (B,
    m_loc, k, C), picked up at global id ``idx_global`` (B, m_loc, k),
    summed into the block (B, n_loc, C) of the rank that owns the id. At
    step i this rank adds its cotangents of block (position − i − 1) into
    the accumulator it holds for that block and passes it on to position
    + 1; after the last step it holds its own block's, from every rank.
    The sums run in float32 at least (as ``gather_neighbors``' backward)."""
    d, me = on.size, on.position
    b, _, _, c = cot.shape
    acc_dtype = torch.promote_types(cot.dtype, torch.float32)
    g = idx_global.long()
    owner = g // n_loc
    flat = (g % n_loc) + torch.arange(b, device=g.device).view(b, 1, 1) * n_loc
    rows = cot.reshape(-1, c).to(acc_dtype)
    acc = None
    for i in range(d):
        sel = (owner == (me - i - 1) % d).reshape(-1)
        mine = torch.zeros((b * n_loc, c), dtype=acc_dtype, device=cot.device)
        mine.index_add_(0, flat.reshape(-1)[sel], rows[sel])
        acc = mine if acc is None else acc + mine
        if i < d - 1:
            (acc,) = mesh.rotate([acc], on)
    return acc.view(b, n_loc, c).to(cot.dtype)


class _RingKnnGather(torch.autograd.Function):
    """:func:`ring_knn_gather` with the rows' backward into ``table``."""

    @staticmethod
    def forward(ctx, table, support, query, k, on):
        idx, d2, rows = _ring_knn_gather(support, query, table, k, on)
        ctx.save_for_backward(idx)
        ctx.n_loc, ctx.on = table.shape[1], on
        ctx.mark_non_differentiable(idx, d2)
        return idx, d2, rows

    @staticmethod
    def backward(ctx, _g_idx, _g_d2, g_rows):
        (idx,) = ctx.saved_tensors
        return _ring_scatter_add(g_rows, idx, ctx.n_loc, ctx.on), None, None, None, None


class _RingGather(torch.autograd.Function):
    """:func:`ring_gather` with its backward into ``features``."""

    @staticmethod
    def forward(ctx, features, idx_global, on):
        ctx.save_for_backward(idx_global)
        ctx.n_loc, ctx.on = features.shape[1], on
        return _ring_gather(features, idx_global, on)

    @staticmethod
    def backward(ctx, g_out):
        (idx,) = ctx.saved_tensors
        return _ring_scatter_add(g_out, idx, ctx.n_loc, ctx.on), None, None
