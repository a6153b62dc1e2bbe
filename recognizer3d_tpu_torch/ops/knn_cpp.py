"""The host KD-tree behind ``knn="kdtree"`` (counterpart of
``recognizer3d_tpu/ops/knn_cpp.py``).

``csrc/kdtree.cpp`` is built by ``g++`` at first use (``ops/_build.py``:
``build_kdtree``) and loaded through ctypes; a failed build raises. Two
entry points:

- :func:`knn_kdtree_host`: numpy in and out;
- :func:`knn_kdtree`: tensors in and out. ``knn="kdtree"`` is a host
  KD-tree by definition, so it copies support and query to the host, runs
  the tree there and returns the results on the input's device, as the JAX
  package's host callback does.
"""

import ctypes
import threading
from typing import Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.ops import _build

_ABI_VERSION = 1

_lib = None
_lock = threading.Lock()


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_kdtree()))
            lib.knn_kdtree_batch.restype = None
            lib.knn_kdtree_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # support
                ctypes.c_int64,  # B
                ctypes.c_int64,  # N
                ctypes.POINTER(ctypes.c_float),  # query
                ctypes.c_int64,  # M
                ctypes.c_int32,  # k
                ctypes.POINTER(ctypes.c_int32),  # out idx
                ctypes.POINTER(ctypes.c_float),  # out d2
            ]
            lib.knn_kdtree_abi_version.restype = ctypes.c_int32
            lib.knn_kdtree_abi_version.argtypes = []
            abi = lib.knn_kdtree_abi_version()
            if abi != _ABI_VERSION:
                raise RuntimeError(f"libr3d_kdtree ABI {abi}, expected {_ABI_VERSION}")
            _lib = lib
    return _lib


def knn_kdtree_host(support: np.ndarray, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact KNN on the host through the C++ KD-tree.

    :param support: (B, N, 3) float32.
    :param query: (B, M, 3) float32.
    :return: indices int32 (B, M, k) and squared distances float32
        (B, M, k), ascending; where N < k the last neighbour repeats.
    """
    lib = _load()
    support = np.ascontiguousarray(support, dtype=np.float32)
    query = np.ascontiguousarray(query, dtype=np.float32)
    if support.ndim != 3 or query.ndim != 3:
        raise ValueError(
            f"expected (B, N, 3) support and (B, M, 3) query, got "
            f"{support.shape} and {query.shape}"
        )
    b, n, _ = support.shape
    m = query.shape[1]
    if query.shape[0] != b:
        raise ValueError(f"batch mismatch: support B={b}, query B={query.shape[0]}")
    if n < 1:
        raise ValueError("support is empty (N=0): no neighbours exist")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    out_idx = np.empty((b, m, k), dtype=np.int32)
    out_d2 = np.empty((b, m, k), dtype=np.float32)
    lib.knn_kdtree_batch(
        support.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(b),
        ctypes.c_int64(n),
        query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(m),
        ctypes.c_int32(k),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_d2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out_idx, out_d2


def knn_kdtree(support: torch.Tensor, query: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_kdtree_host` on tensors: support (B, N, 3) and query
    (B, M, 3) go to the host, the indices (int32, the dispatcher's dtype)
    and squared distances (float32), both (B, M, k), come back on the
    query's device."""
    idx, d2 = knn_kdtree_host(
        support.detach().float().cpu().numpy(), query.detach().float().cpu().numpy(), k
    )
    return (torch.from_numpy(idx).to(query.device), torch.from_numpy(d2).to(query.device))
