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

The wrappers take the JAX wrappers' arguments, but for the gathered
neighbour rows, and fold the BatchNorm eval affines into the constants the
same way (``lfa_pallas.py:329-359`` and ``:517-521``). In place of the
gathered (B, N, K, C) rows they take the table the rows come from, (B, S,
C), and the KNN's (B, N, K) indices into it: the kernels read each row by
index, and no gathered tensor is made. The folded constants then feed
either the plain PyTorch version (a CPU tensor: it gathers with
``ops/knn.gather_neighbors`` and computes on the gathered rows) or the
kernel (a CUDA tensor; no fallback).
:func:`supports` is the JAX gate unchanged: levels with half width 8 or 32.

Each kernel has a float32 and a bfloat16 form, chosen by the dtype of the
row inputs, as the JAX wrappers choose theirs (``io = bfloat16`` at
``lfa_pallas.py:322``, ``:445`` and ``:509``): under bfloat16 the rows
move as bfloat16, the dots read bfloat16-rounded operands and sum in
float32, and the RPE, BN affines and softmax stay float32. The launch
counts keep the forms apart (``lfa_round1`` / ``lfa_round1_bf16``, …).
"""

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from recognizer3d_tpu_torch.ops import _build
from recognizer3d_tpu_torch.ops.knn import gather_neighbors


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


def _check_supported(k: int, h: int, dtype: torch.dtype) -> None:
    if not supports(k, h, str(dtype).removeprefix("torch.")):
        raise ValueError(f"fused LFA does not take K={k}, half={h}, dtype {dtype}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _bf16r(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _round_mats(c: Dict, names, dtype: torch.dtype) -> Dict:
    """Under bfloat16 I/O the matrices the kernels' dots read are folded in
    float32 and then rounded to bfloat16 once, as the JAX wrappers cast
    them (``.astype(io)``); offsets, scales and ``w9`` stay float32."""
    if dtype == torch.bfloat16:
        c.update({name: _bf16r(c[name]) for name in names})
    return c


def _softmax_k(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over K (dim -2) as the JAX kernels write it: e / sum(e)."""
    e = torch.exp(scores - scores.amax(dim=-2, keepdim=True))
    return e / e.sum(dim=-2, keepdim=True)


def round1_constants(w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2,
                     dtype: torch.dtype = torch.float32) -> Dict:
    """The BN-folded constants of round 1: o1 <- s1·b1 + o1, Wp <- Wp·sp,
    op <- sp·bp + op, W2 <- W2·s2, o2 <- s2·b2 + o2; for bfloat16 I/O
    (``dtype``) Ws, Wp and W2 rounded to bfloat16."""
    s1, sp, s2 = _f32(s1), _f32(sp), _f32(s2)
    return _round_mats({
        "w9": _f32(w9),
        "s1": s1,
        "o1": s1 * _f32(b1) + _f32(o1),
        "ws": _f32(ws),
        "wp": _f32(wp) * sp[None, :],
        "op": sp * _f32(bp) + _f32(op),
        "w2": _f32(w2) * s2[None, :],
        "o2": s2 * _f32(b2) + _f32(o2),
    }, ("ws", "wp", "w2"), dtype)


def lfa_round1_plain(table, neighbors, d2, center, c: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the round-1 kernel on folded constants ``c``:
    table (B, S, 2h) gathered at neighbors (B, N, K), d2 (B, N, K), center
    (B, N, h) -> (pooled (B, N, h), rpe2 (B, N, K·h)), in ``table``'s dtype.

    bfloat16 ``table`` takes the rounding points of the JAX kernel's
    bfloat16 form: the RPE and its BN affine in float32 (the affine one
    fused multiply-add), the concatenation rounded to bfloat16 for the
    score and rpe2 dots, the softmax in float32, each product ``w·cat`` (of
    the unrounded concatenation) rounded to bfloat16 before the pooled sum,
    every dot a float32 sum of exact products, and the outputs rounded
    once."""
    gathered = gather_neighbors(table, neighbors)
    B, n, k, c2 = gathered.shape
    h = c2 // 2
    bf16 = gathered.dtype == torch.bfloat16
    g = gathered.float() if bf16 else gathered
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    pre = (g[..., :h] + center[:, :, None, :]) + dist[..., None] * c["w9"]
    if bf16:
        # one rounding, as the fused multiply-add the compilers make of
        # ``pre * s1 + o1`` (XLA on the CPU, the CUDA kernel's fmaf): the
        # float64 product is exact, and a sum rounded twice differs from
        # one rounding only at a float32 midpoint
        rpe = torch.relu((pre.double() * c["s1"] + c["o1"]).float())
    else:
        rpe = torch.relu(pre * c["s1"] + c["o1"])
    cat = torch.cat([rpe, g[..., h:]], dim=-1)
    if not bf16:
        w = torch.softmax(cat @ c["ws"], dim=-2)
        pooled = torch.relu((w * cat).sum(dim=-2) @ c["wp"] + c["op"])
        rpe2 = torch.relu(rpe @ c["w2"] + c["o2"])
        return pooled, rpe2.reshape(B, n, k * h)
    catd = _bf16r(cat)
    w = _softmax_k(catd @ c["ws"])
    pooled = torch.relu(_bf16r(w * cat).sum(dim=-2) @ c["wp"] + c["op"])
    rpe2 = torch.relu(catd[..., :h] @ c["w2"] + c["o2"])
    return pooled.to(torch.bfloat16), rpe2.reshape(B, n, k * h).to(torch.bfloat16)


def _pack(parts) -> torch.Tensor:
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def _check_neighbors(table, neighbors, dtype: torch.dtype, width: int, dev) -> None:
    """The kernels' table and indices: a contiguous (B, S, ``width``)
    ``dtype`` table whose rows start on 16-byte boundaries (they are copied
    16 bytes at a time) and contiguous (B, N, K) int32 indices into each
    cloud's S rows, as the KNN returns them (the kernels do not check their
    range)."""
    B, _, k = neighbors.shape
    _build.check_cuda_tensor("table", table, dtype, (B, None, width), dev, align=16)
    _build.check_cuda_tensor("neighbors", neighbors, torch.int32, (B, None, k), dev)


def lfa_round1(
    table, neighbors, d2, center_term, w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """First LFA round, fused (arguments as ``lfa_pallas.lfa_round1_fused``,
    its gathered rows given as a table and the indices that gather them).

    :param table: (B, S, 2h) rows the neighbours index, [:h] support
        projection, [h:] mlp1 features; float32, or bfloat16 for the
        kernel's bfloat16 form.
    :param neighbors: (B, N, K) indices into each cloud's S table rows;
        int32 on the card (the KNN's own, as they come).
    :param d2: (B, N, K) squared neighbour distances, float32.
    :param center_term: (B, N, h) per-point centre projection, float32.
    :return: (pooled1 (B, N, h), rpe2 (B, N, K·h)), in ``table``'s dtype.
    """
    B, _, c2 = table.shape
    _, n, k = neighbors.shape
    h = c2 // 2
    dtype = table.dtype
    _check_supported(k, h, dtype)
    c = round1_constants(w9, b1, s1, o1, ws, wp, bp, sp, op, w2, b2, s2, o2, dtype=dtype)
    if table.device.type == "cpu":
        return lfa_round1_plain(table, neighbors, d2, center_term, c)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dev = table.device
    consts = _pack([c["w9"], c["s1"], c["o1"], c["ws"], c["wp"], c["op"],
                    c["w2"], c["o2"]])
    _check_neighbors(table, neighbors, dtype, c2, dev)
    _build.check_cuda_tensor("d2", d2, torch.float32, (B, n, k), dev)
    _build.check_cuda_tensor("center_term", center_term, torch.float32, (B, n, h), dev)
    _build.check_cuda_tensor("consts", consts, torch.float32, (5 * h + 7 * h * h,), dev)
    pooled = torch.empty((B, n, h), dtype=dtype, device=dev)
    rpe2 = torch.empty((B, n, k * h), dtype=dtype, device=dev)
    lib = _build.library()
    name = "lfa_round1" if dtype == torch.float32 else "lfa_round1_bf16"
    _build.LAUNCHES[name] += 1
    status = getattr(lib, "r3d_" + name)(
        table.data_ptr(), neighbors.data_ptr(), d2.data_ptr(), center_term.data_ptr(),
        consts.data_ptr(), pooled.data_ptr(), rpe2.data_ptr(),
        B * n, k, h, n, table.shape[1], _build.stream_ptr(dev),
    )
    _build.check_status("r3d_" + name, status)
    return pooled, rpe2


def pool2_constants(ws, wp, bp, sp, op, wm=None, wsh=None, off=None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """The BN-folded constants of pool 2: Wp <- Wp·sp, op <- sp·bp + op;
    the residual's ``wm``, ``wsh`` and ``off`` arrive folded (as in the JAX
    call site) and are left out for pool 2 alone. For bfloat16 I/O
    (``dtype``) Ws, Wp, Wm and Wsh rounded to bfloat16."""
    sp = _f32(sp)
    c = {
        "ws": _f32(ws),
        "wp": _f32(wp) * sp[None, :],
        "op": sp * _f32(bp) + _f32(op),
    }
    if wm is not None:
        c.update(wm=_f32(wm), wsh=_f32(wsh), off=_f32(off))
    return _round_mats(c, [name for name in ("ws", "wp", "wm", "wsh") if name in c], dtype)


def _pool2_head(rpe2, table, neighbors, c: Dict) -> torch.Tensor:
    """Attentive pool 2 and the pool MLP + BN + relu, in float32 (for
    bfloat16 inputs with their kernel's rounding points), on the table's
    rows gathered at ``neighbors``."""
    g2 = gather_neighbors(table, neighbors)
    B, n, k, h = g2.shape
    cat = torch.cat([rpe2.reshape(B, n, k, h), g2], dim=-1)
    if rpe2.dtype != torch.bfloat16:
        w = torch.softmax(cat @ c["ws"], dim=-2)
        return torch.relu((w * cat).sum(dim=-2) @ c["wp"] + c["op"])
    cat = cat.float()
    w = _softmax_k(cat @ c["ws"])
    return torch.relu(_bf16r(w * cat).sum(dim=-2) @ c["wp"] + c["op"])


def attentive_pool2_plain(rpe2, table, neighbors, c: Dict) -> torch.Tensor:
    """Plain version of the pool-2 kernel on folded constants:
    rpe2 (B, N, K·h), table (B, S, h) gathered at neighbors (B, N, K) ->
    (B, N, 2h), in ``rpe2``'s dtype (bfloat16: the output rounded once)."""
    return _pool2_head(rpe2, table, neighbors, c).to(rpe2.dtype)


def attentive_pool2_residual_plain(rpe2, table, neighbors, f_in, c: Dict) -> torch.Tensor:
    """Plain version of the pool-2 + residual kernel on folded constants:
    rpe2 (B, N, K·h), table (B, S, h) gathered at neighbors (B, N, K), f_in
    (B, N, F) -> (B, N, 4h), in ``rpe2``'s dtype (bfloat16: the pooled rows
    rounded before the mlp2 dot, ``f_in`` bfloat16 in the shortcut dot, the
    output rounded once)."""
    pooled = _pool2_head(rpe2, table, neighbors, c)
    if rpe2.dtype == torch.bfloat16:
        pooled, f_in = _bf16r(pooled), f_in.float()
    res = (pooled @ c["wm"] + f_in @ c["wsh"]) + c["off"]
    return F.leaky_relu(res, 0.01).to(rpe2.dtype)


def _pool2_launch(name, rpe2, table, neighbors, f_in, consts_parts, out_width):
    """Launch ``r3d_<name>`` (pool 2 alone without ``f_in``) on CUDA
    tensors, after checking them; returns the output rows."""
    B, n, k = neighbors.shape
    h = table.shape[-1]
    dtype, dev = rpe2.dtype, rpe2.device
    consts = _pack(consts_parts)
    _build.check_cuda_tensor("rpe2", rpe2, dtype, (B, n, k * h), dev, align=16)
    _check_neighbors(table, neighbors, dtype, h, dev)
    nf = 0
    if f_in is not None:
        nf = f_in.shape[-1]
        if dtype == torch.bfloat16 and nf % 2:
            raise ValueError(f"f_in: {nf} bfloat16 features a row, expected an even count")
        # rows copied 4 bytes at a time
        _build.check_cuda_tensor("f_in", f_in, dtype, (B, n, nf), dev, align=4)
    expected = 8 * h * h + 2 * h + (8 * h * h + 4 * h + 4 * h * nf if f_in is not None else 0)
    _build.check_cuda_tensor("consts", consts, torch.float32, (expected,), dev)
    out = torch.empty((B, n, out_width), dtype=dtype, device=dev)
    lib = _build.library()
    if dtype == torch.bfloat16:
        name += "_bf16"
    _build.LAUNCHES[name] += 1
    fn = getattr(lib, "r3d_" + name)
    rows = (rpe2.data_ptr(), table.data_ptr(), neighbors.data_ptr())
    cloud = (n, table.shape[1], _build.stream_ptr(dev))
    if f_in is None:
        status = fn(*rows, consts.data_ptr(), out.data_ptr(), B * n, k, h, *cloud)
    else:
        status = fn(*rows, f_in.data_ptr(), consts.data_ptr(), out.data_ptr(),
                    B * n, k, h, nf, *cloud)
    _build.check_status("r3d_" + name, status)
    return out


def attentive_pool2(rpe2, table, neighbors, ws, wp, bp, sp, op) -> torch.Tensor:
    """Second attentive pooling without the residual, fused (arguments as
    ``lfa_pallas.attentive_pool2_fused``, its gathered rows given as a
    table and the indices that gather them): returns the pool MLP + BN +
    relu output (B, N, 2h), in ``rpe2``'s dtype (float32 or bfloat16).

    :param rpe2: (B, N, K·h) from :func:`lfa_round1`.
    :param table: (B, S, h) round 1's pooled rows, in ``rpe2``'s dtype.
    :param neighbors: (B, N, K) indices into each cloud's S table rows
        (int32 on the card).
    """
    h = table.shape[-1]
    _check_supported(neighbors.shape[-1], h, rpe2.dtype)
    c = pool2_constants(ws, wp, bp, sp, op, dtype=rpe2.dtype)
    if rpe2.device.type == "cpu":
        return attentive_pool2_plain(rpe2, table, neighbors, c)
    if rpe2.device.type != "cuda":
        raise ValueError(f"unsupported device {rpe2.device}")
    return _pool2_launch("lfa_pool2", rpe2, table, neighbors, None,
                         [c["ws"], c["wp"], c["op"]], 2 * h)


def attentive_pool2_residual(
    rpe2, table, neighbors, ws, wp, bp, sp, op, f_in, wm, wsh, off
) -> torch.Tensor:
    """Second attentive pooling with the block residual, fused (arguments
    as ``lfa_pallas.attentive_pool2_residual_fused``, its gathered rows
    given as a table and the indices that gather them): returns
    ``leaky_relu(mlp2(pool2(...)) + shortcut(f_in), 0.01)`` (B, N, 4h), in
    ``rpe2``'s dtype (float32 or bfloat16; ``table`` and ``f_in`` alike).

    :param rpe2: (B, N, K·h) from :func:`lfa_round1`.
    :param table: (B, S, h) round 1's pooled rows.
    :param neighbors: (B, N, K) indices into each cloud's S table rows
        (int32 on the card).
    :param f_in: (B, N, F) the block's input rows.
    :param wm: mlp2 matrix W·s (2h, 4h); ``wsh`` the shortcut's (F, 4h);
        ``off`` the combined offset (4h,).
    """
    h = table.shape[-1]
    _check_supported(neighbors.shape[-1], h, rpe2.dtype)
    c = pool2_constants(ws, wp, bp, sp, op, wm, wsh, off, dtype=rpe2.dtype)
    if rpe2.device.type == "cpu":
        return attentive_pool2_residual_plain(rpe2, table, neighbors, f_in, c)
    if rpe2.device.type != "cuda":
        raise ValueError(f"unsupported device {rpe2.device}")
    parts = [c["ws"], c["wp"], c["op"], c["wm"], c["wsh"], c["off"]]
    return _pool2_launch("lfa_pool2_res", rpe2, table, neighbors, f_in, parts, 4 * h)
