"""Exact KNN and 1-NN kernels (``csrc/knn.cu``) with their plain versions.

* :func:`knn_topk` replaces ``recognizer3d_tpu/ops/knn_pallas.py::_knn_kernel``
  (exact k-NN, k <= 128): the encoder self-KNNs of the main path. Supports
  of over 2,048 points take the kernel's global-memory form, the
  counterpart of the TPU kernel's ``hbm=True``: one more launch computes
  the boxes into a scratch (counted as ``knn_topk_boxes``).
* :func:`argmin_1nn` replaces ``::_argmin_kernel`` (exact 1-NN with tile
  culling) with a kernel that culls over a grid of cells it builds itself:
  the final upsample onto the full cloud, and approx64k's decoder
  upsamples.
* :func:`knn_window_topk` replaces the ``lax.approx_min_k`` selection of
  ``recognizer3d_tpu/ops/knn.py::knn_window`` (the Morton-window search of
  ``knn="approximate"``): each block of ``query_block`` sorted queries
  selects its k nearest among a ``window_points`` slice of the sorted
  support, exactly.

All take support (B, N, 3) and query (B, M, 3) float32 and return indices
into the support as given (int32) and squared distances (float32, >= 0),
nearest first. A CPU tensor runs the plain PyTorch version; a CUDA tensor
launches the kernel or raises. The plain versions compute distances as the
kernels do, by direct differences in the order ((dx² + dy²) + dz²), and
rank them with a stable sort (ties keep the lower support index), so the
kernel and its plain version agree bit for bit.
"""

from typing import Tuple

import torch

from recognizer3d_tpu_torch.ops import _build

#: largest k the KNN kernel takes (as the TPU kernel's best-list width)
MAX_K = 128

# plain versions hold at most this many (query, support) distances at once
_PLAIN_CHUNK_ELEMS = 1 << 24


def _sq_dists(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """(..., m, N) squared distances of (..., m, 3) queries to (..., N, 3)
    support points by direct differences, one rounding per operation (eager
    ops are never contracted into FMAs)."""
    dx = query[..., 0:1] - support[..., 0].unsqueeze(-2)
    dy = query[..., 1:2] - support[..., 1].unsqueeze(-2)
    dz = query[..., 2:3] - support[..., 2].unsqueeze(-2)
    return (dx * dx + dy * dy) + dz * dz


def _query_chunks(m: int, n: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(n, 1))
    for lo in range(0, m, step):
        yield lo, min(m, lo + step)


def knn_topk_plain(
    support: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the KNN kernel: full distances + stable sort."""
    idx_parts, d2_parts = [], []
    for lo, hi in _query_chunks(query.shape[1], support.shape[1]):
        d2 = _sq_dists(query[:, lo:hi], support)
        d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
        idx_parts.append(order[..., :k].to(torch.int32))
        d2_parts.append(d2_sorted[..., :k])
    return torch.cat(idx_parts, 1), torch.cat(d2_parts, 1)


def argmin_1nn_plain(
    support: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the 1-NN kernel: full distances + argmin (first
    index of the minimum), which is ``knn_topk_plain(support, query, 1)``."""
    idx_parts, d2_parts = [], []
    for lo, hi in _query_chunks(query.shape[1], support.shape[1]):
        d2 = _sq_dists(query[:, lo:hi], support)
        best, arg = torch.min(d2, dim=-1, keepdim=True)
        idx_parts.append(arg.to(torch.int32))
        d2_parts.append(best)
    return torch.cat(idx_parts, 1), torch.cat(d2_parts, 1)


def _check_clouds(support: torch.Tensor, query: torch.Tensor):
    if support.dim() != 3 or support.shape[-1] != 3:
        raise ValueError(f"support: shape {tuple(support.shape)}, expected (B, N, 3)")
    if query.dim() != 3 or query.shape[-1] != 3 or query.shape[0] != support.shape[0]:
        raise ValueError(
            f"query: shape {tuple(query.shape)}, expected ({support.shape[0]}, M, 3)"
        )
    if support.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError("support and query must be float32")
    if support.device != query.device:
        raise ValueError(f"support on {support.device}, query on {query.device}")
    if support.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {support.device}")


def _check_cuda_clouds(support: torch.Tensor, query: torch.Tensor):
    B, n, _ = support.shape
    m = query.shape[1]
    _build.check_cuda_tensor("support", support, torch.float32, (B, n, 3), support.device)
    _build.check_cuda_tensor("query", query, torch.float32, (B, m, 3), support.device)


def knn_topk(
    support: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest support points of every query: (idx int32 (B, M, k),
    d2 float32 (B, M, k)), nearest first."""
    _check_clouds(support, query)
    B, n, _ = support.shape
    m = query.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}] taken by the KNN kernel")
    if k > n:
        raise ValueError(f"k={k} exceeds support size {n}")
    if support.device.type == "cpu":
        return knn_topk_plain(support, query, k)
    _check_cuda_clouds(support, query)
    idx = torch.empty((B, m, k), dtype=torch.int32, device=support.device)
    d2 = torch.empty((B, m, k), dtype=torch.float32, device=support.device)
    lib = _build.library()
    # supports over the kernel's size threshold take the global-memory
    # form: a box pass of its own into this scratch, then the walk
    scratch_bytes = lib.r3d_knn_topk_scratch_bytes(B, n)
    scratch = None
    if scratch_bytes:
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=support.device)
        _build.LAUNCHES["knn_topk_boxes"] += 1
    _build.LAUNCHES["knn_topk"] += 1
    status = lib.r3d_knn_topk(
        query.data_ptr(), support.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        idx.data_ptr(), d2.data_ptr(), B, m, n, k, _build.stream_ptr(support.device),
    )
    _build.check_status("r3d_knn_topk", status)
    return idx, d2



def cull_boxes_plain(support: torch.Tensor) -> torch.Tensor:
    """Plain version of the global-memory form's box pass, in its scratch's
    layout, per cloud: tile boxes (6 rows of nt: lo x, y, z, hi x, y, z),
    then super-tile boxes (6 rows of ns), by ``amin``/``amax`` over tiles of
    32 points and super tiles of 32 tiles (points past the support empty)."""
    b, n, _ = support.shape
    nt = -(-n // 32)
    ns = -(-nt // 32)
    pad = torch.full((b, ns * 1024 - n, 3), float("inf"), device=support.device)
    lo = torch.cat([support, pad], 1).view(b, ns * 32, 32, 3).amin(2)
    hi = torch.cat([support, -pad], 1).view(b, ns * 32, 32, 3).amax(2)
    tiles = torch.cat([lo[:, :nt], hi[:, :nt]], 2).transpose(1, 2).reshape(b, 6 * nt)
    supers = torch.cat([lo.view(b, ns, 32, 3).amin(2), hi.view(b, ns, 32, 3).amax(2)], 2)
    return torch.cat([tiles, supers.transpose(1, 2).reshape(b, 6 * ns)], 1)


def cull_boxes(support: torch.Tensor) -> torch.Tensor:
    """The boxes the global-memory form's box pass writes for ``support``
    on the card, in :func:`cull_boxes_plain`'s layout: the route run on one
    query at k = 1 (a short walk) with a scratch of its own, read back. A
    check of the box pass, not a path: no launch is counted."""
    b, n, _ = support.shape
    lib = _build.library()
    scratch_bytes = lib.r3d_knn_topk_scratch_bytes(b, n)
    if not scratch_bytes:
        raise ValueError(f"a support of {n} points takes the shared-memory form: no box pass")
    scratch = torch.empty(scratch_bytes // 4, dtype=torch.float32, device=support.device)
    q = support[:, :1].contiguous()
    idx = torch.empty((b, 1, 1), dtype=torch.int32, device=support.device)
    d2 = torch.empty((b, 1, 1), dtype=torch.float32, device=support.device)
    status = lib.r3d_knn_topk(q.data_ptr(), support.data_ptr(), scratch.data_ptr(),
                              idx.data_ptr(), d2.data_ptr(), b, 1, n, 1,
                              _build.stream_ptr(support.device))
    _build.check_status("r3d_knn_topk", status)
    nt = -(-n // 32)
    return scratch.view(b, -1)[:, : 6 * (nt + -(-nt // 32))]


def argmin_1nn(
    support: torch.Tensor, query: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact nearest support point of every query: (idx int32 (B, M, 1),
    d2 float32 (B, M, 1))."""
    _check_clouds(support, query)
    B, n, _ = support.shape
    m = query.shape[1]
    if n < 1:
        raise ValueError("empty support")
    if support.device.type == "cpu":
        return argmin_1nn_plain(support, query)
    _check_cuda_clouds(support, query)
    idx = torch.empty((B, m, 1), dtype=torch.int32, device=support.device)
    d2 = torch.empty((B, m, 1), dtype=torch.float32, device=support.device)
    lib = _build.library()
    # supports too large to order in each CUDA block's shared memory are
    # ordered once, by a launch of their own, into this scratch
    scratch_bytes = lib.r3d_argmin_scratch_bytes(B, n)
    scratch = None
    if scratch_bytes:
        scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=support.device)
        _build.LAUNCHES["argmin_1nn_order"] += 1
    _build.LAUNCHES["argmin_1nn"] += 1
    status = lib.r3d_argmin(
        query.data_ptr(), support.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        idx.data_ptr(), d2.data_ptr(), B, m, n, _build.stream_ptr(support.device),
    )
    _build.check_status("r3d_argmin", status)
    return idx, d2


def knn_window_topk_plain(
    support: torch.Tensor, query: torch.Tensor, k: int, starts: torch.Tensor,
    window_points: int, query_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the window kernel: per query block, the window's
    distances + stable sort (k = 1: ``torch.min``, the first index of the
    minimum, as the kernel's strict ``<``). The last block is padded with
    copies of the last query, as ``knn_window`` pads it; padded rows are
    dropped."""
    B, _, _ = support.shape
    m = query.shape[1]
    w, qb = window_points, query_block
    offsets = torch.arange(w, device=support.device)
    per_chunk = max(1, _PLAIN_CHUNK_ELEMS // (qb * w))
    idx_parts, d2_parts = [], []
    for j0 in range(0, starts.shape[0], per_chunk):
        j1 = min(starts.shape[0], j0 + per_chunk)
        lo, hi = j0 * qb, min(m, j1 * qb)
        q = query[:, lo:hi]
        pad = (j1 - j0) * qb - (hi - lo)
        if pad:
            q = torch.cat([q, q[:, -1:].expand(B, pad, 3)], dim=1)
        q = q.reshape(B, j1 - j0, qb, 3)
        st = starts[j0:j1].long()
        window = support[:, st[:, None] + offsets]  # (B, blocks, w, 3)
        d2 = _sq_dists(q, window)  # (B, blocks, qb, w)
        if k == 1:
            best, arg = torch.min(d2, dim=-1, keepdim=True)
        else:
            d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
            best, arg = d2_sorted[..., :k], order[..., :k]
        idx = arg + st[None, :, None, None]
        idx_parts.append(idx.reshape(B, -1, k)[:, : hi - lo].to(torch.int32))
        d2_parts.append(best.reshape(B, -1, k)[:, : hi - lo])
    return torch.cat(idx_parts, 1), torch.cat(d2_parts, 1)


def knn_window_topk(
    support: torch.Tensor, query: torch.Tensor, k: int, starts: torch.Tensor,
    window_points: int, query_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest support points of every query within its query
    block's window: query j searches ``support[:, s : s + window_points]``
    with ``s = starts[j // query_block]``. (idx int32 (B, M, k) into the
    support as given, d2 float32 (B, M, k)), nearest first.

    :param starts: (ceil(M / query_block),) int32 window starts in
        [0, N - window_points], on the clouds' device.
    :param query_block: a multiple of 8 for k >= 2 and of 32 for k = 1
        (the k = 1 kernel's CUDA blocks of 32 to 256 queries must each lie
        in one query block, so that a block stages one window).
    """
    _check_clouds(support, query)
    B, n, _ = support.shape
    m = query.shape[1]
    w, qb = window_points, query_block
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside [1, {MAX_K}] taken by the window kernel")
    if not k <= w <= n:
        raise ValueError(f"need k={k} <= window_points={w} <= support size {n}")
    n_blocks = -(-m // qb)
    if starts.dtype != torch.int32 or tuple(starts.shape) != (n_blocks,):
        raise ValueError(
            f"starts: {starts.dtype} {tuple(starts.shape)}, expected int32 ({n_blocks},)"
        )
    if support.device.type == "cpu":
        return knn_window_topk_plain(support, query, k, starts, w, qb)
    _check_cuda_clouds(support, query)
    _build.check_cuda_tensor("starts", starts, torch.int32, (n_blocks,), support.device)
    if qb % (32 if k == 1 else 8):
        raise ValueError(f"query_block={qb} must be a multiple of {32 if k == 1 else 8}")
    idx = torch.empty((B, m, k), dtype=torch.int32, device=support.device)
    d2 = torch.empty((B, m, k), dtype=torch.float32, device=support.device)
    lib = _build.library()
    # windows wider than shared memory holds are scanned by the streaming
    # kernel (k >= 2), counted under a name of its own
    streams = k >= 2 and lib.r3d_knn_window_streams(w)
    _build.LAUNCHES["knn_topk_stream" if streams else "knn_window_topk"] += 1
    status = lib.r3d_knn_window(
        query.data_ptr(), support.data_ptr(), starts.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), B, m, n, w, qb, k, _build.stream_ptr(support.device),
    )
    _build.check_status("r3d_knn_window", status)
    return idx, d2
