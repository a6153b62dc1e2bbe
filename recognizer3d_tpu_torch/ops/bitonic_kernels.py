"""Bitonic compare-exchange stages (``csrc/bitonic.cu``) with their plain
version.

:func:`roll_stages` replaces ``benchmarks/bench_roll_stages.py::_kernel``,
the micro-benchmark of a bitonic stage (partner ``v[i ^ d]``, compare,
min / max with a payload riding along) that asks whether a bitonic network
can beat repeated min-extraction in the KNN selection. It takes x
(..., ts) float32 and returns ``v + float(payload) * 1e-12`` after
``stages`` stages on every row of ts lanes. A CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the kernel or raises. The two agree
bit for bit.
"""

import torch

from recognizer3d_tpu_torch.ops import _build

#: the lane counts the kernel takes: one CUDA block of ts threads per row,
#: a multiple of twice the largest exchange distance (32)
_TS_STEP, _TS_MAX = 64, 1024
#: the partner distances of the stages, as in the TPU kernel
_DISTANCES = (1, 2, 4, 8, 16, 32)
_KK = 32
_PAYLOAD_SCALE = 1e-12


def stage_distances(stages: int):
    """The partner distance d of each stage."""
    d_seq = _DISTANCES[: max(1, min(len(_DISTANCES), stages))]
    return [d_seq[s % len(d_seq)] for s in range(stages)]


def roll_stages_plain(x: torch.Tensor, stages: int) -> torch.Tensor:
    """Plain version: the same stages as tensor ops, the partner taken
    through ``arange(ts) ^ d``."""
    ts = x.shape[-1]
    lane = torch.arange(ts, device=x.device)
    vals = x
    pays = lane.to(torch.int32).expand(x.shape)
    bit_kk = (lane & _KK) // _KK
    for d in stage_distances(stages):
        partner_at = lane ^ d
        partner = vals[..., partner_at]
        ppartner = pays[..., partner_at]
        keep_min = ((1 - (lane & d) // d) ^ bit_kk) == 1
        cmp = vals <= partner
        mn = torch.where(cmp, vals, partner)
        mx = torch.where(cmp, partner, vals)
        pmn = torch.where(cmp, pays, ppartner)
        pmx = torch.where(cmp, ppartner, pays)
        vals = torch.where(keep_min, mn, mx)
        pays = torch.where(keep_min, pmn, pmx)
    return vals + pays.to(torch.float32) * _PAYLOAD_SCALE


def roll_stages(x: torch.Tensor, stages: int) -> torch.Tensor:
    """``stages`` bitonic compare-exchange stages on every row of the last
    axis of x (float32, ts a multiple of 64 up to 1024)."""
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected float32")
    if x.dim() < 1 or x.shape[-1] % _TS_STEP or not 0 < x.shape[-1] <= _TS_MAX:
        raise ValueError(
            f"x: shape {tuple(x.shape)}; the last axis must be a multiple of "
            f"{_TS_STEP} up to {_TS_MAX}"
        )
    if stages < 0:
        raise ValueError(f"stages={stages} < 0")
    if x.device.type == "cpu":
        return roll_stages_plain(x, stages)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _build.check_cuda_tensor("x", x, torch.float32, tuple(x.shape), x.device)
    out = torch.empty_like(x)
    ts = x.shape[-1]
    lib = _build.library()
    _build.LAUNCHES["roll_stages"] += 1
    status = lib.r3d_roll_stages(
        x.data_ptr(), out.data_ptr(), x.numel() // ts, ts, stages,
        _build.stream_ptr(x.device),
    )
    _build.check_status("r3d_roll_stages", status)
    return out
