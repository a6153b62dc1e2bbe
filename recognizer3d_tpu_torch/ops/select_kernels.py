"""The n smallest priorities of each row (``csrc/select.cu``, B8) with its
plain version.

:func:`select_smallest` replaces the ``lax.approx_min_k`` selection of
``recognizer3d_tpu/data/pipeline.py:115`` (``z_filter_subsample``: the
``n_out`` smallest random priorities of a depth frame, on the TPU's
PartialReduce hardware, recall 0.95). It selects exactly, as the JAX
package does off the TPU and in its ``DeviceDatasetCache`` sampler with
``lax.top_k(-priority, n_out)``: the indices of each row's ``n_out``
smallest priorities, in ascending priority, ties to the lower index. Its
callers are ``data/pipeline.subsample_order`` (the live depth path, 786,432
priorities -> 16,384 a frame) and ``DeviceDatasetCache.assemble`` (every
train batch assembled on the device).

What bounds the kernel on the card is bytes: 4·B·N read and 8·B·n_out
written. A CPU tensor runs the plain version, a stable sort; a CUDA tensor
launches the kernel or raises. The two agree bit for bit.
"""

import torch

from recognizer3d_tpu_torch.ops import _build

#: rows the kernel takes (its launch grid's second dimension)
MAX_ROWS = 65_535


def select_smallest_plain(priority: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain version: the first ``n_out`` indices of a stable sort."""
    return torch.sort(priority, dim=-1, stable=True).indices[..., :n_out]


def _check(priority: torch.Tensor, n_out: int) -> None:
    if priority.dtype != torch.float32:
        raise TypeError(f"priority: dtype {priority.dtype}, expected float32")
    if priority.dim() != 2:
        raise ValueError(f"priority: shape {tuple(priority.shape)}, expected (B, N)")
    if not priority.is_contiguous():
        raise ValueError("priority: not contiguous")
    if not 1 <= n_out <= priority.shape[1]:
        raise ValueError(f"n_out={n_out} outside [1, {priority.shape[1]}]")
    if priority.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("priority: requires grad; a selection has no backward (run it "
                           "under torch.no_grad() or torch.inference_mode())")


def select_smallest(priority: torch.Tensor, n_out: int) -> torch.Tensor:
    """(B, n_out) int64: the indices of the ``n_out`` smallest values of
    each row of ``priority`` (B, N) float32, in ascending value, ties to
    the lower index."""
    _check(priority, n_out)
    if priority.device.type == "cpu":
        return select_smallest_plain(priority, n_out)
    if priority.device.type != "cuda":
        raise ValueError(f"unsupported device {priority.device}")
    b, n = priority.shape
    if b > MAX_ROWS:
        raise ValueError(f"priority: {b} rows, the kernel takes at most {MAX_ROWS}")
    order = torch.empty((b, n_out), dtype=torch.int64, device=priority.device)
    lib = _build.library()
    scratch = torch.empty(lib.r3d_select_scratch_bytes(b, n, n_out), dtype=torch.uint8,
                          device=priority.device)
    _build.LAUNCHES["select_smallest"] += 1
    status = lib.r3d_select_smallest(priority.data_ptr(), scratch.data_ptr(), order.data_ptr(),
                                     b, n, n_out, _build.stream_ptr(priority.device))
    _build.check_status("r3d_select_smallest", status)
    return order
