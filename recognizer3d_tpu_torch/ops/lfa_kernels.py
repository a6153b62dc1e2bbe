"""Fused eval-mode LFA kernels (``csrc/lfa.cu``) with their plain versions.

* :func:`lfa_round1` replaces ``recognizer3d_tpu/ops/lfa_pallas.py::_round1_kernel``
  (wrapper ``lfa_round1_fused``): RPE-MLP + BN + relu -> attentive pool 1
  -> mlp_rpe2 + BN + relu.
* :func:`attentive_pool2_residual` replaces ``::_pool2_res_kernel`` (wrapper
  ``attentive_pool2_residual_fused``): attentive pool 2 -> pool MLP + BN +
  relu -> mlp2 + shortcut on the block input -> leaky_relu(0.01).
* :func:`attentive_pool2` replaces ``::_pool2_kernel`` (wrapper
  ``attentive_pool2_fused``): the same kernel without the residual, ending
  at the pool MLP + BN + relu.

The wrappers take the JAX wrappers' arguments and fold the BatchNorm eval
affines into the constants the same way (``lfa_pallas.py:329-359`` and
``:517-521``). The folded constants then feed either the plain PyTorch
version (a CPU tensor) or the kernel (a CUDA tensor; no fallback).
:func:`supports` is the JAX gate unchanged: levels with half width 8 or 32.
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from recognizer3d_tpu_torch.ops import _build


def supports(k: int, half: int, dtype: str) -> bool:
    """The fused path covers half == 8 (level 0) and half == 32 (level 1),
    K a power of two >= 8, and K*2h a multiple of 128 up to 2048 lanes."""
    lanes = k * 2 * half
    return (
        dtype in ("float32", "bfloat16")
        and half in (8, 32)
        and k >= 8
        and (k & (k - 1)) == 0
        and lanes % 128 == 0
        and lanes <= 2048
        and (half * 2) <= 128
    )


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def round1_constants(w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2) -> Dict:
    """The BN-folded constants of round 1: o1 <- s1·b1 + o1, Wp <- Wp·sp,
    op <- sp·bp + op, W2 <- W2·s2, o2 <- s2·b2 + o2."""
    s1, sp, s2 = _f32(s1), _f32(sp), _f32(s2)
    return {
        "w9": _f32(w9),
        "s1": s1,
        "o1": s1 * _f32(b1) + _f32(o1),
        "ws": _f32(ws),
        "wp": _f32(wp) * sp[None, :],
        "op": sp * _f32(bp) + _f32(op),
        "w2": _f32(w2) * s2[None, :],
        "o2": s2 * _f32(b2) + _f32(o2),
    }


def lfa_round1_plain(gathered, d2, center, c: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the round-1 kernel on folded constants ``c``:
    gathered (B, N, K, 2h), d2 (B, N, K), center (B, N, h) ->
    (pooled (B, N, h), rpe2 (B, N, K·h))."""
    B, n, k, c2 = gathered.shape
    h = c2 // 2
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    pre = (gathered[..., :h] + center[:, :, None, :]) + dist[..., None] * c["w9"]
    rpe = torch.relu(pre * c["s1"] + c["o1"])
    cat = torch.cat([rpe, gathered[..., h:]], dim=-1)
    w = torch.softmax(cat @ c["ws"], dim=-2)
    pooled = torch.relu((w * cat).sum(dim=-2) @ c["wp"] + c["op"])
    rpe2 = torch.relu(rpe @ c["w2"] + c["o2"])
    return pooled, rpe2.reshape(B, n, k * h)


def _pack(parts) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def lfa_round1(
    gathered, d2, center_term, w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First LFA round, fused (arguments as ``lfa_pallas.lfa_round1_fused``).

    :param gathered: (B, N, K, 2h) neighbour rows, [:h] support projection,
        [h:] mlp1 features.
    :param d2: (B, N, K) squared neighbour distances.
    :param center_term: (B, N, h) per-point centre projection.
    :return: (pooled1 (B, N, h), rpe2 (B, N, K·h)), float32.
    """
    B, n, k, c2 = gathered.shape
    h = c2 // 2
    if not supports(k, h, "float32"):
        raise ValueError(f"fused LFA does not take K={k}, half={h}")
    c = round1_constants(w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2)
    if gathered.device.type == "cpu":
        return lfa_round1_plain(gathered, d2, center_term, c)
    if gathered.device.type != "cuda":
        raise ValueError(f"unsupported device {gathered.device}")
    dev = gathered.device
    consts = _pack([c["w9"], c["s1"], c["o1"], c["ws"], c["wp"], c["op"],
                    c["w2"], c["o2"]])
    _build.check_cuda_tensor("gathered", gathered, torch.float32, (B, n, k, c2), dev)
    _build.check_cuda_tensor("d2", d2, torch.float32, (B, n, k), dev)
    _build.check_cuda_tensor("center_term", center_term, torch.float32, (B, n, h), dev)
    _build.check_cuda_tensor("consts", consts, torch.float32, (5 * h + 7 * h * h,), dev)
    pooled = torch.empty((B, n, h), dtype=torch.float32, device=dev)
    rpe2 = torch.empty((B, n, k * h), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.LAUNCHES["lfa_round1"] += 1
    status = lib.r3d_lfa_round1(
        gathered.data_ptr(), d2.data_ptr(), center_term.data_ptr(),
        consts.data_ptr(), pooled.data_ptr(), rpe2.data_ptr(),
        B * n, k, h, _build.stream_ptr(dev),
    )
    _build.check_status("r3d_lfa_round1", status)
    return pooled, rpe2


def pool2_constants(ws, wp, bp, sp, op, wm=None, wsh=None, off=None) -> Dict:
    """The BN-folded constants of pool 2: Wp <- Wp·sp, op <- sp·bp + op;
    the residual's ``wm``, ``wsh`` and ``off`` arrive folded (as in the JAX
    call site) and are left out for pool 2 alone."""
    sp = _f32(sp)
    c = {
        "ws": _f32(ws),
        "wp": _f32(wp) * sp[None, :],
        "op": sp * _f32(bp) + _f32(op),
    }
    if wm is not None:
        c.update(wm=_f32(wm), wsh=_f32(wsh), off=_f32(off))
    return c


def attentive_pool2_plain(rpe2, g2, c: Dict, k: int) -> torch.Tensor:
    """Plain version of the pool-2 kernel on folded constants:
    rpe2 (B, N, K·h), g2 (B, N, K, h) -> (B, N, 2h)."""
    B, n, kh = rpe2.shape
    h = kh // k
    cat = torch.cat([rpe2.reshape(B, n, k, h), g2.reshape(B, n, k, h)], dim=-1)
    w = torch.softmax(cat @ c["ws"], dim=-2)
    return torch.relu((w * cat).sum(dim=-2) @ c["wp"] + c["op"])


def attentive_pool2_residual_plain(rpe2, g2, f_in, c: Dict, k: int) -> torch.Tensor:
    """Plain version of the pool-2 + residual kernel on folded constants:
    rpe2 (B, N, K·h), g2 (B, N, K, h), f_in (B, N, F) -> (B, N, 4h)."""
    pooled = attentive_pool2_plain(rpe2, g2, c, k)
    res = (pooled @ c["wm"] + f_in @ c["wsh"]) + c["off"]
    return F.leaky_relu(res, 0.01)


def attentive_pool2(rpe2, g2, ws, wp, bp, sp, op, k: int) -> torch.Tensor:
    """Second attentive pooling without the residual, fused (arguments as
    ``lfa_pallas.attentive_pool2_fused``): returns the pool MLP + BN + relu
    output (B, N, 2h).

    :param rpe2: (B, N, K·h) from :func:`lfa_round1`.
    :param g2: (B, N, K, h) gathered pooled rows.
    """
    B, n, kh = rpe2.shape
    h = kh // k
    if not supports(k, h, "float32"):
        raise ValueError(f"fused LFA does not take K={k}, half={h}")
    c = pool2_constants(ws, wp, bp, sp, op)
    if rpe2.device.type == "cpu":
        return attentive_pool2_plain(rpe2, g2, c, k)
    if rpe2.device.type != "cuda":
        raise ValueError(f"unsupported device {rpe2.device}")
    dev = rpe2.device
    consts = _pack([c["ws"], c["wp"], c["op"]])
    _build.check_cuda_tensor("rpe2", rpe2, torch.float32, (B, n, kh), dev)
    _build.check_cuda_tensor("g2", g2, torch.float32, (B, n, k, h), dev)
    _build.check_cuda_tensor("consts", consts, torch.float32, (8 * h * h + 2 * h,), dev)
    out = torch.empty((B, n, 2 * h), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.LAUNCHES["lfa_pool2"] += 1
    status = lib.r3d_lfa_pool2(
        rpe2.data_ptr(), g2.data_ptr(), consts.data_ptr(), out.data_ptr(),
        B * n, k, h, _build.stream_ptr(dev),
    )
    _build.check_status("r3d_lfa_pool2", status)
    return out


def attentive_pool2_residual(
    rpe2, g2, ws, wp, bp, sp, op, f_in, wm, wsh, off, k: int
) -> torch.Tensor:
    """Second attentive pooling with the block residual, fused (arguments
    as ``lfa_pallas.attentive_pool2_residual_fused``): returns
    ``leaky_relu(mlp2(pool2(...)) + shortcut(f_in), 0.01)`` (B, N, 4h).

    :param rpe2: (B, N, K·h) from :func:`lfa_round1`.
    :param g2: (B, N, K, h) gathered pooled rows.
    :param f_in: (B, N, F) the block's input rows.
    :param wm: mlp2 matrix W·s (2h, 4h); ``wsh`` the shortcut's (F, 4h);
        ``off`` the combined offset (4h,).
    """
    B, n, kh = rpe2.shape
    h = kh // k
    nf = f_in.shape[-1]
    if not supports(k, h, "float32"):
        raise ValueError(f"fused LFA does not take K={k}, half={h}")
    c = pool2_constants(ws, wp, bp, sp, op, wm, wsh, off)
    if rpe2.device.type == "cpu":
        return attentive_pool2_residual_plain(rpe2, g2, f_in, c, k)
    if rpe2.device.type != "cuda":
        raise ValueError(f"unsupported device {rpe2.device}")
    dev = rpe2.device
    consts = _pack([c["ws"], c["wp"], c["op"], c["wm"], c["wsh"], c["off"]])
    _build.check_cuda_tensor("rpe2", rpe2, torch.float32, (B, n, kh), dev)
    _build.check_cuda_tensor("g2", g2, torch.float32, (B, n, k, h), dev)
    _build.check_cuda_tensor("f_in", f_in, torch.float32, (B, n, nf), dev)
    _build.check_cuda_tensor(
        "consts", consts, torch.float32, (16 * h * h + 6 * h + 4 * h * nf,), dev
    )
    out = torch.empty((B, n, 4 * h), dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.LAUNCHES["lfa_pool2_res"] += 1
    status = lib.r3d_lfa_pool2_res(
        rpe2.data_ptr(), g2.data_ptr(), f_in.data_ptr(), consts.data_ptr(),
        out.data_ptr(), B * n, k, h, nf, _build.stream_ptr(dev),
    )
    _build.check_status("r3d_lfa_pool2_res", status)
    return out
