"""K-nearest-neighbour front end (counterpart of ``recognizer3d_tpu/ops/knn.py``).

All functions share the JAX package's contract::

    indices (B, M, k) int32, squared_distances (B, M, k) float32
      = knn_fn(support (B, N, 3), query (B, M, 3), k)

``knn``/``knn_presorted`` route ``"naive"`` the way the JAX package routes it
on its accelerator:

* k in [2, 128]                                -> KNN kernel (``knn_topk``)
* k == 1, N <= 65,536 and (N >= 2048 or M >= 16,384) -> 1-NN kernel (``argmin_1nn``)
* k == 1, N > 65,536                            -> KNN kernel at k = 1
* any other k == 1 (the decoder's inner upsamplings, N <= 625)
                                                -> plain ``knn_argmin``
* k > 128                                       -> ``knn_tiled`` / ``knn_naive``

``"pallas"`` always takes the KNN kernel. ``"approximate"`` (the default of
the settings, as in the JAX package and the reference) routes as the JAX
dispatchers do:

* k == 1, N <= 32,768                           -> the ``"naive"`` route (exact)
* N > 12,288 and N·M > 64M (the window regime)  -> ``knn_window``: Morton-window
  search on the window kernel (``knn_window_topk``), with the window size or
  the exact fallback of the session recall guard (``ensure_window_recall``)
* otherwise                                     -> ``knn_approximate``: the
  KNN kernel

Where the TPU selects with ``lax.approx_min_k`` (a partial reduction with a
recall target below 1), the port selects exactly within the same candidate
set: the whole support, or the query block's window. So its recall is at
least the TPU's, and on the CPU, where JAX's ``approx_min_k`` is an exact
top-k, the two packages pick the same neighbours up to near-ties.

``"kdtree"`` runs the host KD-tree (``ops/knn_cpp.knn_kdtree``) on every
device, as the JAX package does through its host callback.

The kernels' wrappers run their plain versions on CPU tensors, so the route
is the same on every device. The exact kernels return the same neighbours
for points in any order (B1's culling is only faster on Morton-sorted
ones), so outside the window regime ``knn_presorted`` (Morton-sorted
callers) routes exactly as ``knn``.
"""

import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.ops.knn_kernels import (
    MAX_K,
    argmin_1nn,
    argmin_1nn_plain,
    knn_topk,
    knn_window_topk,
)
from recognizer3d_tpu_torch.ops.morton import (
    morton_order,
    sort_rows,
    unsort_results,
)
from recognizer3d_tpu_torch.utils.device import resolve_device

# M*N elements of a full distance matrix above which k > 128 searches tile,
# and "approximate" searches over more than _WINDOW_MIN_SUPPORT points take
# the Morton window (the JAX package's thresholds)
_NAIVE_MAX_MN = 64_000_000
_WINDOW_MIN_SUPPORT = 12_288
# "approximate" 1-NN searches up to this support size take the exact route
_APPROX_EXACT_1NN_MAX_SUPPORT = 32768
# the 1-NN kernel's routing window, as in the JAX package
_ARGMIN_MAX_SUPPORT = 65536
_ARGMIN_MIN_SUPPORT = 2048
_ARGMIN_MIN_QUERIES = 16384


def knn_naive(
    support: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN through the full distance matrix in the expanded form
    ‖q‖² + ‖s‖² − 2 q·s (one matmul), as the JAX ``knn_naive``; ties keep
    the lower index. Only k > 128 searches reach it."""
    if k == 1:
        return knn_argmin(support, query)
    q2 = (query * query).sum(-1, keepdim=True)
    s2 = (support * support).sum(-1, keepdim=True)
    d2 = q2 + s2.transpose(-1, -2) - 2.0 * (query @ support.transpose(-1, -2))
    d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
    return order[..., :k].to(torch.int32), torch.clamp(d2_sorted[..., :k], min=0.0)


def knn_argmin(
    support: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN in plain PyTorch on any device (direct differences,
    bounded memory). The decoder's inner upsamplings take it: at their
    sizes (support <= 625) a kernel launch buys nothing."""
    return argmin_1nn_plain(support, query)


def knn_tiled(
    support: torch.Tensor, query: torch.Tensor, k: int, support_tile: int = 4096
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN with bounded memory: a scan over support tiles keeping a
    running best k (direct differences; ties keep the lower index)."""
    B, n, _ = support.shape
    best_d = best_i = None
    for lo in range(0, n, support_tile):
        tile = support[:, lo : lo + support_tile]
        dx = query[..., 0:1] - tile[..., 0].unsqueeze(1)
        dy = query[..., 1:2] - tile[..., 1].unsqueeze(1)
        dz = query[..., 2:3] - tile[..., 2].unsqueeze(1)
        d2 = (dx * dx + dy * dy) + dz * dz
        idx = torch.arange(lo, lo + tile.shape[1], device=support.device)
        idx = idx.expand_as(d2)
        if best_d is not None:
            d2 = torch.cat([best_d, d2], dim=-1)
            idx = torch.cat([best_i, idx], dim=-1)
        d2_sorted, sel = torch.sort(d2, dim=-1, stable=True)
        best_d = d2_sorted[..., :k]
        best_i = torch.gather(idx, -1, sel[..., :k])
    return best_i.to(torch.int32), best_d


def knn_approximate(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    recall_target: float = 0.95,
    query_block: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``knn_approximate`` (full-distance ``approx_min_k`` over query
    blocks), selected exactly: the ``"naive"`` route, i.e. the KNN kernel
    for k in [2, 128]. Exact recall is at least the TPU's, so
    ``recall_target`` is accepted and unused, and ``query_block`` is too
    (the kernels bound their own memory)."""
    return knn(support, query, k, "naive")


def window_starts(n: int, m: int, window_points: int, query_block: int) -> np.ndarray:
    """(ceil(m / query_block),) int32 first support row of each query
    block's window, the JAX ``knn_window`` arithmetic: the block's centre on
    the query curve (clamped to the real queries), mapped proportionally
    onto the support curve, minus half a window, clipped to the support."""
    qb, w = query_block, window_points
    n_blocks = -(-m // qb)
    centers = np.minimum((np.arange(n_blocks) + 0.5) * qb, m - 0.5) * (n / m)
    return np.clip(np.round(centers - w / 2), 0, n - w).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _device_window_starts(n, m, window_points, query_block, device) -> torch.Tensor:
    return torch.from_numpy(window_starts(n, m, window_points, query_block)).to(device)


def knn_window(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    window_points: int = 4096,
    query_block: int = 512,
    block_group: int = 16,
    recall_target: float = 0.9,
    presorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Morton-window KNN, as the JAX ``knn_window``: both clouds
    Morton-sorted, each block of ``query_block`` sorted queries searches
    only the ``window_points`` support points around its relative position
    on the curve. O(M · window_points) work instead of O(M · N).

    The selection inside a window is exact (the window kernel
    ``knn_window_topk``), where the TPU runs ``approx_min_k`` at
    ``recall_target``; the parameter is accepted and unused. ``block_group``
    only batches the TPU's loop and has no counterpart either.

    With ``presorted=True`` both inputs must already be Morton-sorted
    (``ops/morton.morton_order``); indices are then into the given support
    order and rows stay in the given query order.
    """
    n, m = support.shape[1], query.shape[1]
    if n <= window_points:
        # the window covers everything: the full-distance search
        return knn_approximate(support, query, k, recall_target)
    if presorted:
        s_sorted, q_sorted = support, query
    else:
        s_order = morton_order(support)
        s_sorted = sort_rows(support, s_order)
        if support is query:
            q_order, q_sorted = s_order, s_sorted
        else:
            q_order = morton_order(query)
            q_sorted = sort_rows(query, q_order)
    starts = _device_window_starts(n, m, window_points, query_block, support.device)
    idx, d2 = knn_window_topk(
        s_sorted.contiguous(), q_sorted.contiguous(), k, starts,
        window_points, query_block,
    )
    if presorted:
        return idx, d2
    return unsort_results(idx, d2, s_order, q_order)


# --- recall ------------------------------------------------------------------

#: queries re-searched exactly per approximate call when runtime recall
#: telemetry is on (RECOGNIZER3D_KNN_RECALL=1)
_RECALL_SAMPLES = 256


def _recall_telemetry_enabled() -> bool:
    return os.environ.get("RECOGNIZER3D_KNN_RECALL", "") not in ("", "0")


def recall_sample_positions(m: int) -> np.ndarray:
    """The ``min(256, m)`` evenly spaced query positions that
    :func:`sampled_recall` re-searches (every query block is touched), by
    a float64 ``linspace``."""
    return np.linspace(0, m - 1, min(_RECALL_SAMPLES, m)).astype(np.int64)


def sampled_recall(support, query, k, result) -> torch.Tensor:
    """Recall@k of an (idx, d2) KNN result against an exact re-search of
    the queries at :func:`recall_sample_positions`, as a 0-d float32
    tensor. JAX's float32 ``linspace``, truncated, can place a position
    one higher than the port's float64 one (two positions at M = 150,000,
    one at M = 163,840); at every M the recall guard probes, the two
    agree. A returned neighbour counts as a hit when its
    distance ranks within the exact top k, so equidistant ties cannot miss.
    The exact re-search is the ``"naive"`` route (the KNN kernel for
    k >= 2), whose distances come from the same formula as the window
    kernel's."""
    _, d2 = result
    pos = torch.from_numpy(recall_sample_positions(query.shape[1])).to(query.device)
    q_sub = query[:, pos].contiguous()
    _, exact_d2 = knn(support, q_sub, k, "naive")
    kth = exact_d2[..., k - 1 : k]
    hits = d2[:, pos] <= kth * (1.0 + 1e-5) + 1e-12
    return hits.float().mean()


def measure_recall(support, query, k: int, approach: str = "approximate") -> float:
    """Run ``knn(approach)`` and return its sampled recall@k as a float."""
    result = knn(support, query, k, approach)
    return float(sampled_recall(support, query, k, result))


def _with_recall_telemetry(support, query, k, result, tag):
    """Opt-in runtime recall check of an approximate search
    (RECOGNIZER3D_KNN_RECALL=1): one exact re-search of 256 queries after
    the search, logged as a warning. Costs nothing when off."""
    recall = float(sampled_recall(support, query, k, result))
    m = query.shape[1]
    logging.getLogger("knn").warning(
        "approximate-KNN recall@%d [%s]: %.4f (%d/%d queries sampled)",
        k, tag, recall, min(_RECALL_SAMPLES, m), m,
    )
    return result


# --- the session recall guard ------------------------------------------------
# As in the JAX package: a one-off sampled-recall probe on the session's first
# window-regime cloud widens the session window along _WINDOW_LADDER until the
# probe clears the target, and demotes "approximate" to the exact route for
# the session if the widest rung still misses. The state is process-global,
# so a widened window and an exact fallback hold for every Model of the
# process until reset_window_guard() (the JAX package's semantics, kept for
# parity). PyTorch runs eagerly and the dispatchers read the state on every
# call, so nothing needs retracing when the guard acts.

#: successive window sizes the guard may widen to
_WINDOW_LADDER = (4096, 8192, 16384)

_GUARD_TARGET_DEFAULT = 0.9

_session_guard = {"window_points": _WINDOW_LADDER[0], "exact_fallback": False}


def session_window_points() -> int:
    """The Morton-window size the approximate dispatch currently uses."""
    return _session_guard["window_points"]


def session_exact_fallback() -> bool:
    """True when the guard demoted ``knn="approximate"`` to the exact route
    for this process (the widest ladder rung still missed the target)."""
    return _session_guard["exact_fallback"]


def reset_window_guard() -> None:
    """Restore the tuned default routing (tests and benchmarks)."""
    _session_guard["window_points"] = _WINDOW_LADDER[0]
    _session_guard["exact_fallback"] = False


def session_guard_state() -> Tuple[int, bool]:
    """(window points, exact fallback) of this process's session."""
    return _session_guard["window_points"], _session_guard["exact_fallback"]


def adopt_session_guard(state: Tuple[int, bool]) -> None:
    """Install another process's :func:`session_guard_state`: the ranks of a
    serving pool search with rank 0's session (in the JAX package the
    shards of one process share it)."""
    _session_guard["window_points"], _session_guard["exact_fallback"] = (
        int(state[0]), bool(state[1]))


def _in_window_regime(n: int, m: int) -> bool:
    return n > _WINDOW_MIN_SUPPORT and n * m > _NAIVE_MAX_MN


def window_regime_active(n: int) -> bool:
    """True when a self-KNN over ``n`` points routes through the Morton
    window, the approximate path's only recall-lossy regime."""
    return _in_window_regime(n, n)


def _window_recall_probe(x: torch.Tensor, k: int, w: int) -> float:
    """Sampled self-KNN recall@k of the window search at window size w."""
    return float(sampled_recall(x, x, k, knn_window(x, x, k, window_points=w)))


def ensure_window_recall(
    cloud,
    k: int,
    target: Optional[float] = None,
    ladder: Optional[Tuple[int, ...]] = None,
    device="cuda",
) -> dict:
    """Run the recall guard on one representative cloud (once per session;
    ``Model`` calls it from the first window-regime predict). Measures the
    sampled self-KNN recall@k of the window search at each ladder rung from
    the current session window upward, installs the first rung that clears
    ``target`` as the session window, and engages the exact fallback when
    even the widest rung misses.

    :param cloud: (N, 3) or (B, N, 3) coordinates (xyz only), numpy or torch.
    :param k: neighbours per point (the model's n_neighbors).
    :param target: required sampled recall@k; default 0.9, overridable via
        RECOGNIZER3D_RECALL_TARGET.
    :param ladder: override of _WINDOW_LADDER (tests); probed as given.
    :param device: where the probe runs; the GPU unless the caller asks
        for ``"cpu"``.
    :return: dict with ``recall`` (the final measured value),
        ``window_points``, ``exact_fallback``, ``widened`` and ``active``
        (False when the cloud is below the window regime).
    """
    if target is None:
        target = float(
            os.environ.get("RECOGNIZER3D_RECALL_TARGET", _GUARD_TARGET_DEFAULT)
        )
    rungs = _WINDOW_LADDER if ladder is None else tuple(ladder)
    x = torch.as_tensor(np.asarray(cloud, np.float32), device=resolve_device(device))
    if x.dim() == 2:
        x = x[None]
    x = x[..., :3].contiguous()
    n = x.shape[1]
    if not window_regime_active(n):
        return {
            "active": False,
            "recall": 1.0,
            "window_points": _session_guard["window_points"],
            "exact_fallback": False,
            "widened": False,
        }
    start = _session_guard["window_points"]
    recall = 0.0
    chosen = None
    for w in rungs:
        if ladder is None and w < start:
            # a converged session never probes below its installed window
            continue
        # w >= n degenerates to the full-distance search inside knn_window
        recall = _window_recall_probe(x, k, w)
        if recall >= target:
            chosen = w
            break
        if w >= n:
            break
    widened = chosen is not None and chosen != start
    if chosen is None:
        _session_guard["exact_fallback"] = True
        logging.getLogger("knn").warning(
            "approximate-KNN recall guard: sampled recall@%d is %.3f at the "
            "widest window (%d of %d points), below the %.2f target for "
            "this capture distribution. Falling back to EXACT KNN for this "
            "session (slower, exact). Set RECOGNIZER3D_KNN_RECALL=0 "
            "to disable the guard.",
            k, recall, rungs[-1], n, target,
        )
    elif widened:
        _session_guard["window_points"] = chosen
        logging.getLogger("knn").warning(
            "approximate-KNN recall guard: widened the Morton window "
            "%d -> %d points for this session (sampled recall@%d %.3f >= "
            "%.2f target on this capture distribution).",
            start, chosen, k, recall, target,
        )
    return {
        "active": True,
        "recall": recall,
        "window_points": _session_guard["window_points"],
        "exact_fallback": _session_guard["exact_fallback"],
        "widened": widened,
    }


def _approximate(support, query, k, presorted: bool):
    """The window-regime branch of the "approximate" dispatchers."""
    n, m = support.shape[1], query.shape[1]
    if session_exact_fallback():
        return (knn_presorted if presorted else knn)(support, query, k, "naive")
    result = knn_window(
        support, query, k, window_points=session_window_points(), presorted=presorted
    )
    if _recall_telemetry_enabled():
        tag = "window/presorted" if presorted else "window"
        result = _with_recall_telemetry(support, query, k, result, f"{tag} N={n} M={m}")
    return result


def knn(
    support: torch.Tensor, query: torch.Tensor, k: int, approach: str = "naive"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching KNN front end: (indices int32, squared dists float32),
    both (B, M, k)."""
    support = support.contiguous()
    query = query.contiguous()
    n, m = support.shape[1], query.shape[1]
    if approach == "naive":
        if k == 1:
            if n <= _ARGMIN_MAX_SUPPORT and (
                n >= _ARGMIN_MIN_SUPPORT or m >= _ARGMIN_MIN_QUERIES
            ):
                return argmin_1nn(support, query)
            if n > _ARGMIN_MAX_SUPPORT:
                return knn_topk(support, query, 1)
            return knn_argmin(support, query)
        if k <= MAX_K:
            return knn_topk(support, query, k)
        if n * m > _NAIVE_MAX_MN:
            return knn_tiled(support, query, k)
        return knn_naive(support, query, k)
    if approach == "pallas":
        return knn_topk(support, query, k)
    if approach == "approximate":
        if k == 1 and n <= _APPROX_EXACT_1NN_MAX_SUPPORT:
            return knn(support, query, 1, "naive")
        if _in_window_regime(n, m):
            return _approximate(support, query, k, presorted=False)
        result = knn_approximate(support, query, k)
        if _recall_telemetry_enabled():
            result = _with_recall_telemetry(
                support, query, k, result, f"approx_min_k N={n} M={m}"
            )
        return result
    if approach == "kdtree":
        from recognizer3d_tpu_torch.ops.knn_cpp import knn_kdtree

        return knn_kdtree(support, query, k)
    raise ValueError(f"KNN approach {approach} not understood!")


def knn_presorted(
    support: torch.Tensor, query: torch.Tensor, k: int, approach: str = "naive"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` for callers that keep their points Morton-sorted:
    indices are into the given support order and rows stay in the given
    query order. Only the window regime of ``"approximate"`` differs from
    :func:`knn`: it skips the window search's own sort and unsort."""
    n, m = support.shape[1], query.shape[1]
    if approach == "approximate" and k == 1 and n <= _APPROX_EXACT_1NN_MAX_SUPPORT:
        return knn_presorted(support, query, 1, "naive")
    if approach == "approximate" and _in_window_regime(n, m):
        return _approximate(support.contiguous(), query.contiguous(), k, presorted=True)
    return knn(support, query, k, approach)


def gather_neighbors(features: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features, (B, M, K) indices into N -> (B, M, K, C).

    bfloat16 features that autograd records are gathered as float32 and
    rounded back (the same values), so that the backward sums each row's
    cotangents in float32 and rounds once: a bfloat16 scatter-add would
    round at every one of a row's K additions, in an order that differs
    from device to device (atomics on the card)."""
    if features.dtype == torch.bfloat16 and features.requires_grad:
        return gather_neighbors(features.float(), neighbors).to(torch.bfloat16)
    B, n, c = features.shape
    _, m, k = neighbors.shape
    if B == 1:
        flat = neighbors.reshape(-1).long()
    else:
        offsets = torch.arange(B, device=neighbors.device).view(B, 1, 1) * n
        flat = (neighbors.long() + offsets).reshape(-1)
    return features.reshape(B * n, c).index_select(0, flat).reshape(B, m, k, c)
