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

All functions run inside a rank (see ``mesh.RankPool``); on one rank they
are the single-process search.
"""

from typing import List, Optional, Tuple

import torch

from recognizer3d_tpu_torch.ops.knn import gather_neighbors, knn
from recognizer3d_tpu_torch.parallel import mesh


def _merge(cand_d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k smallest candidates, in ``lax.top_k(-d)``'s order
    (ties to the earlier candidate)."""
    return torch.sort(cand_d, dim=-1, stable=True).indices[..., :k]


def _steps(support: torch.Tensor, query: torch.Tensor, k: int, carried: List[torch.Tensor]):
    """Yield (global indices, d2, carried blocks) of each ring step's search
    of the visiting support block, ``carried`` travelling with it."""
    d, me = mesh.world(), mesh.rank()
    n_loc = support.shape[1]
    k_step = min(k, n_loc)
    visiting = [support, *carried]
    for i in range(d):
        src = (me - i) % d  # the block visiting at step i started on rank me - i
        idx, d2 = knn(visiting[0], query, k_step, "naive")
        yield idx, idx + src * n_loc, d2, visiting[1:]
        if i < d - 1:
            visiting = mesh.rotate(visiting)


def ring_knn(
    support: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN with both clouds block-sharded over the ranks:
    :func:`ring_knn_gather` without a row table.

    :param support: (B, n_loc, 3), this rank's block of the support.
    :param query: (B, m_loc, 3), this rank's block of the queries.
    :return: (global indices int32 (B, m_loc, k), squared distances).
    """
    return ring_knn_gather(support, query, None, k)[:2]


def ring_knn_gather(
    support: torch.Tensor, query: torch.Tensor, table: Optional[torch.Tensor], k: int
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Exact KNN and the neighbours' rows in one ring pass: the visiting
    block's ``table`` rows travel with its points, and (distance, index,
    row) triples merge in the running best k. Every query then holds its k
    neighbours' rows locally.

    :param table: (B, n_loc, C) rows of this rank's support block, or None
        (no rows: the third result is None).
    :return: (global indices (B, m_loc, k), squared distances, rows
        (B, m_loc, k, C)).
    """
    b, m, _ = query.shape
    best_d = torch.full((b, m, k), float("inf"), dtype=torch.float32, device=query.device)
    best_i = torch.zeros((b, m, k), dtype=torch.int32, device=query.device)
    best_f = None
    if table is not None:
        best_f = torch.zeros((b, m, k, table.shape[-1]), dtype=table.dtype, device=table.device)
    carried = [] if table is None else [table]
    for idx, gidx, d2, visiting in _steps(support, query, k, carried):
        cand_d = torch.cat([best_d, d2], dim=-1)
        sel = _merge(cand_d, k)
        best_d = torch.gather(cand_d, -1, sel)
        best_i = torch.gather(torch.cat([best_i, gidx], dim=-1), -1, sel)
        if table is not None:
            cand_f = torch.cat([best_f, gather_neighbors(visiting[0], idx)], dim=-2)
            best_f = torch.gather(cand_f, -2,
                                  sel[..., None].expand(-1, -1, -1, cand_f.shape[-1]))
    return best_i, torch.clamp(best_d, min=0.0), best_f


def ring_gather(features: torch.Tensor, idx_global: torch.Tensor) -> torch.Tensor:
    """Rows of a point-sharded table by global ids: the feature blocks travel
    once round the ring, and each query picks up the neighbours whose id
    lies in the visiting block.

    :param features: (B, n_loc, C), this rank's block of the table.
    :param idx_global: (B, m_loc, k) global row ids.
    :return: (B, m_loc, k, C).
    """
    d, me = mesh.world(), mesh.rank()
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
            (visiting,) = mesh.rotate([visiting])
    return out
