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

The kernel is one launch a call, a thread block cluster a row; its launch
plan (:func:`select_plan`: blocks a row, whether a block stages its slice
of the row in shared memory, whether the selected keys stay in shared
memory) is chosen here from the shapes and the card's SM count, and
passed to the kernel, which refuses a plan it cannot launch.
"""

import dataclasses

import torch

from recognizer3d_tpu_torch.ops import _build

#: the plan's limits and sizes, as ``csrc/select.cu`` lays out shared memory
MAX_SMEM = 232_448          # bytes a block may use
MAX_CLUSTER = 16            # blocks a row (a cluster; above 8 non-portable)
ROW_BLOCK = 4_096           # priorities a block takes at least, below MAX_CLUSTER blocks
STATIC_BYTES = 8_192        # the kernel's fixed part
HIST_BINS = 2048            # a block's histogram (the widest digit: 11 bits)
CNT_BYTES = 16 * 256 * 4    # the sort's digit counts, a row for each of 16 warps


@dataclasses.dataclass(frozen=True)
class SelectPlan:
    """How the kernel selects from (B, N) -> n_out: ``cluster`` blocks a
    row; ``staged``: each block loads its slice of the row into shared
    memory once (else every pass re-reads it from global memory);
    ``keys_shared``: the selected keys stay in the blocks' shared memory
    (else in a global scratch of ``scratch_bytes``); ``smem_bytes`` a
    block."""

    cluster: int
    staged: bool
    keys_shared: bool
    smem_bytes: int
    scratch_bytes: int


def _smem_bytes(cluster: int, chunk: int, kpb: int, staged: bool, keys_shared: bool) -> int:
    """The fixed part; the cluster's bin sums of the 3 digit passes, 2048 /
    cluster a block and pass; the histogram or key buffer A; the digit
    counts; the staged slice or key buffer B."""
    def align(x):
        return (x + 15) // 16 * 16

    keys = 8 * kpb if keys_shared else 0
    stage = 4 * (chunk + 4) if staged else 0
    red = 3 * 4 * (HIST_BINS // cluster) if cluster > 1 else 0
    return (STATIC_BYTES + red + align(max(keys, 4 * HIST_BINS)) + CNT_BYTES
            + align(max(stage, keys)))


def plan_for(b: int, n: int, n_out: int, cluster: int, staged: bool,
             keys_shared: bool) -> SelectPlan:
    """The plan of the given form, its shared memory and scratch sized as
    the kernel lays them out (whether it fits is the caller's question)."""
    chunk = -(-(-(-n // cluster)) // 4) * 4
    kpb = -(-n_out // cluster)
    return SelectPlan(cluster, staged, keys_shared,
                      _smem_bytes(cluster, chunk, kpb, staged, keys_shared),
                      0 if keys_shared else 2 * b * n_out * 8)


def select_plan(b: int, n: int, n_out: int, sms: int, max_cluster: int = MAX_CLUSTER,
                row_block: int = ROW_BLOCK) -> SelectPlan:
    """The kernel's launch plan for ``b`` rows of ``n`` priorities -> ``n_out``
    on a card of ``sms`` SMs. Blocks a row: the fewest (a power of two) that
    give each at most ``row_block`` priorities, up to ``max_cluster``, while
    ``b`` rows fill no more than half the card; more where the selected
    keys do not fit the blocks' shared memory. Then the first that fits:
    staged with the keys in shared memory, streamed with them, and (at
    ``max_cluster`` blocks) with the keys in a global scratch staged,
    streamed. The live frame's 786,432 -> 16,384 takes 16 blocks, staged; a
    train batch's 4 x 20,000 -> 2,500 eight a row, staged (on an H100
    faster than two or four: ``benchmarks/launch_ab.py B8``, which also
    times other bounds)."""
    cluster = 1
    while (cluster < max_cluster and cluster * row_block < n
           and b * cluster * 2 <= max(sms, 1)):
        cluster *= 2
    while True:
        forms = ((True, True), (False, True))
        if cluster >= max_cluster:
            forms += ((True, False), (False, False))
        for staged, keys_shared in forms:
            plan = plan_for(b, n, n_out, cluster, staged, keys_shared)
            if plan.smem_bytes <= MAX_SMEM:
                return plan
        cluster *= 2


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
    plan = select_plan(b, n, n_out,
                       torch.cuda.get_device_properties(priority.device).multi_processor_count)
    order = torch.empty((b, n_out), dtype=torch.int64, device=priority.device)
    lib = _build.library()
    scratch = None
    if plan.scratch_bytes:
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=priority.device)
    _build.LAUNCHES["select_smallest"] += 1
    status = lib.r3d_select_smallest(
        priority.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        order.data_ptr(), b, n, n_out, plan.cluster, int(plan.staged), int(plan.keys_shared),
        _build.stream_ptr(priority.device))
    _build.check_status(f"r3d_select_smallest {plan}", status)
    return order
