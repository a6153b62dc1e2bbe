"""Chunked eval forward for million-point clouds (counterpart of
``recognizer3d_tpu/models/large.py``).

The in-model forward (``models/randlanet.py``) holds whole-level (N, K, C)
neighbour tensors in every unfused LFA block: about 2 GB each at N =
1,048,576. This forward computes the same function, weight for weight, with
each unfused LFA's neighbour pipeline streamed in query chunks, so the
largest per-neighbour tensor is (chunk, K, C):

- an unfused level (``_lfa_chunked``): phase A per chunk, the neighbour
  gather, the LocSE encoding, ``mlp_rpe1`` and attentive pool 1 (its
  ``mlp_rpe1`` output kept for phase B); phase B per chunk, after all of
  phase A (the pooled rows it gathers reach outside the chunk), the gather
  of pooled rows, ``mlp_rpe2`` and attentive pool 2;
- a fused level (``_lfa_fused_level``): the same two phases through the LFA
  kernels, B2 (``lfa_kernels.lfa_round1``) and B3
  (``lfa_kernels.attentive_pool2_residual``), one launch each over the
  whole level: the kernels read the neighbour rows by index, so no
  per-neighbour tensor is made and there is nothing to chunk. It keeps one
  full-level intermediate between the phases, ``rpe2`` (N, K·half), and
  runs where the kernels take the level's (K, half) and that intermediate
  stays under ``_FUSED_LEVEL_MAX_GATHER_BYTES``.

Everything else (the per-level Morton orders, the KNN, the decimation, the
decoder's 1-NN upsample, the head) is the sorted-domain flow of the in-model
forward: one entry gather, one composed gather a level transition, one exit
gather. Chunks are edge-padded to a whole number of ``chunk`` rows, as the
JAX package pads them, and the padded rows are dropped; a Python loop over
the chunks takes the place of ``lax.map``.

What the JAX module has that this one leaves out, and why:

- ``models/functional.py``, the layers over parameter dictionaries: the
  port's submodules hold the parameters and take any leading shape, so this
  forward applies them as they are (``_mlp`` and ``_pool`` below only fix
  the dtype at float32);
- ``local_gather``, the gather of a chunk's rows from a slice of the table
  around the chunk: on the TPU it kept the gather's table inside the fast
  footprint; on the card a gather from a row slice reads the same rows as a
  gather from the whole table, so every gather here is flat, and there is no
  slice bound that could drift from the window search's query block;
- the switches ``RECOGNIZER3D_FUSED_LFA`` and ``FORCE_FUSED_LFA_INTERPRET``
  and the TPU availability gate: the LFA kernels' wrappers run their plain
  versions on CPU tensors and the kernels on CUDA tensors, so the gate is
  the kernels' geometry and the memory bound alone;
- ``RECOGNIZER3D_SORTED_FLOW``: the port runs only the sorted flow, which is
  bit-identical to the per-level sorts.

Like the JAX function, this forward reads no ``compute_dtype``: a bfloat16
model routed here computes in float32 (its parameters are float32).
"""

from typing import List

import torch

from recognizer3d_tpu_torch.models.randlanet import (
    RandLANet,
    _activation,
    _dense,
    _leaky_relu,
)
from recognizer3d_tpu_torch.ops import lfa_kernels
from recognizer3d_tpu_torch.ops.knn import knn_presorted
from recognizer3d_tpu_torch.ops.morton import invert_permutation, morton_order

#: the facade routes eval forwards of clouds of at least this many points here
LARGE_FORWARD_MIN_POINTS = 300_000

#: the fused levels' memory gate: rpe2, (N, K·half) float32, the one
#: full-level intermediate kept between the two kernels, must stay under
#: this (about 1 GB a 1M-point level at the app architecture)
_FUSED_LEVEL_MAX_GATHER_BYTES = 3 * 1024**3

_F32 = torch.float32


def _chunks(x: torch.Tensor, chunk: int) -> List[torch.Tensor]:
    """(N, ...) -> pieces of ``chunk`` rows, the last edge-padded with
    copies of the last row."""
    n = x.shape[0]
    pad = -n % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return list(x.split(chunk))


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a (N, C) table at (...,) indices -> (..., C)."""
    return table.index_select(0, idx.reshape(-1).long()).reshape(*idx.shape, table.shape[-1])


def _mlp(mlp, x: torch.Tensor) -> torch.Tensor:
    """A ``SharedMLP`` (Dense, eval BatchNorm, its activation) in float32."""
    x = _dense(mlp.conv, x, _F32)
    if mlp.batch_norm is not None:
        x = mlp.batch_norm(x)
    return _activation(mlp.activation, x)


def _pool(pool, x: torch.Tensor) -> torch.Tensor:
    """An ``AttentivePooling`` over the K axis (dim -2) in float32."""
    scores = torch.softmax(_dense(pool.score_fn, x, _F32), dim=-2)
    return _mlp(pool.mlp, (scores * x).sum(dim=-2))


def _lfa_chunked(block, xyz, feats, k: int, approach: str, chunk: int) -> torch.Tensor:
    """One eval LFA block on a level's sorted (N, ·) rows, its neighbour
    pipeline streamed in query chunks; the LocSE encoding is the
    10-channel concat ``[center, neighbour, center − neighbour, distance]``
    through ``mlp_rpe1``'s whole kernel, as the JAX function computes it."""
    n = xyz.shape[0]
    neighbors, d2 = knn_presorted(xyz[None], xyz[None], k, approach)
    nb, dist = neighbors[0], torch.sqrt(d2[0])
    table = torch.cat([xyz, _mlp(block.mlp1, feats)], dim=-1)
    rpe1 = block.mlp_rpe1

    nb_c, dist_c = _chunks(nb, chunk), _chunks(dist, chunk)
    pooled_c, rpe1_c = [], []
    for nb_i, dist_i, q_i in zip(nb_c, dist_c, _chunks(xyz, chunk)):
        g = _rows(table, nb_i)  # (c, K, 3 + half)
        center = q_i[:, None, :].expand(-1, k, 3)
        rpe = torch.cat([center, g[..., :3], center - g[..., :3], dist_i[..., None]], dim=-1)
        r = torch.relu(rpe1.batch_norm(rpe @ rpe1.conv.kernel + rpe1.conv.bias))
        pooled_c.append(_pool(block.pool1, torch.cat([r, g[..., 3:]], dim=-1)))
        rpe1_c.append(r)
    f1 = torch.cat(pooled_c)[:n]

    f2_c = []
    for nb_i, r in zip(nb_c, rpe1_c):
        cat = torch.cat([_mlp(block.mlp_rpe2, r), _rows(f1, nb_i)], dim=-1)
        f2_c.append(_pool(block.pool2, cat))
    f2 = torch.cat(f2_c)[:n]
    return _leaky_relu(_mlp(block.mlp2, f2) + _mlp(block.shortcut, feats), 0.01)


def _fused_level_available(k: int, n: int, half: int) -> bool:
    """The LFA kernels take this (K, half), and the level's rpe2 stays under
    ``_FUSED_LEVEL_MAX_GATHER_BYTES``."""
    return (
        lfa_kernels.supports(k, half, "float32")
        and n * k * half * 4 <= _FUSED_LEVEL_MAX_GATHER_BYTES
    )


def _lfa_fused_level(block, xyz, feats, k: int, approach: str) -> torch.Tensor:
    """One eval LFA block on a level's sorted (N, ·) rows through the LFA
    kernels, one launch each over the whole level: round 1 (B2) on the
    (support projection | mlp1 features) table, then pool 2 with the
    block's residual (B3) on round 1's pooled rows, each kernel reading the
    neighbour rows at the KNN's indices itself. The kernels' arguments are
    the in-model fused branch's (``LocalFeatureAggregation._fused_forward``)."""
    rpe1 = block.mlp_rpe1
    table = torch.cat([rpe1.support_projection(xyz), _mlp(block.mlp1, feats)], dim=-1)
    neighbors, d2 = knn_presorted(xyz[None], xyz[None], k, approach)

    s1, o1 = rpe1.batch_norm.eval_affine()
    wp1, bp1 = block.pool1.mlp.dense_wb()
    sp1, op1 = block.pool1.mlp.batch_norm.eval_affine()
    w2, b2 = block.mlp_rpe2.dense_wb()
    s2, o2 = block.mlp_rpe2.batch_norm.eval_affine()
    pooled, rpe2 = lfa_kernels.lfa_round1(
        table[None], neighbors, d2, rpe1.center_projection(xyz)[None].contiguous(),
        rpe1.conv.kernel[9], rpe1.conv.bias, s1, o1, block.pool1.score_kernel(),
        wp1, bp1, sp1, op1, w2, b2, s2, o2,
    )

    wp2, bp2 = block.pool2.mlp.dense_wb()
    sp2, op2 = block.pool2.mlp.batch_norm.eval_affine()
    wm, bm = block.mlp2.dense_wb()
    sm, om = block.mlp2.batch_norm.eval_affine()
    wsh, bsh = block.shortcut.dense_wb()
    ssh, osh = block.shortcut.batch_norm.eval_affine()
    return lfa_kernels.attentive_pool2_residual(
        rpe2, pooled, neighbors, block.pool2.score_kernel(), wp2, bp2, sp2, op2,
        feats[None].contiguous(), wm * sm[None, :], wsh * ssh[None, :],
        (sm * bm + om) + (ssh * bsh + osh),
    )[0]


def _forward_one(net: RandLANet, inputs: torch.Tensor, permutation: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Eval forward of one cloud (N, 3+F) -> logits (C, N)."""
    s = net.settings
    n = inputs.shape[0]
    inputs = inputs.float()
    xyz = inputs[:, :3][permutation]
    feats = _leaky_relu(net.bn_start(_dense(net.fc_start, inputs, _F32)), 0.2)

    level_sizes = [n]
    for i in range(s.n_layers):
        level_sizes.append(n // s.decimation ** (i + 1))
    orders, invs, xyz_levels = [], [], []
    for n_level in level_sizes:
        x_level = xyz[:n_level]
        order = morton_order(x_level[None])[0]
        orders.append(order)
        invs.append(invert_permutation(order))
        xyz_levels.append(x_level[order].contiguous())

    # features stay in each level's Morton order; the entry gather composes
    # the permutation with level 0's order, a level transition inv_i ∘ order_{i+1}
    feats = feats[permutation[orders[0]]]
    skip_stack = []
    for i, n_out in enumerate(s.layer_sizes):
        block = getattr(net, f"encoder_{i}")
        if _fused_level_available(s.n_neighbors, level_sizes[i], n_out // 2):
            out = _lfa_fused_level(block, xyz_levels[i], feats, s.n_neighbors, s.knn)
        else:
            out = _lfa_chunked(block, xyz_levels[i], feats, s.n_neighbors, s.knn,
                               min(chunk, level_sizes[i]))
        skip_stack.append(out)
        feats = out[invs[i][orders[i + 1]]]

    feats = _mlp(net.mlp, feats)
    for i in range(s.n_layers):
        level = s.n_layers - i
        nb1, _ = knn_presorted(xyz_levels[level][None], xyz_levels[level - 1][None], 1, s.knn)
        up = feats.index_select(0, nb1[0, :, 0].long())
        feats = _mlp(getattr(net, f"decoder_{i}"), torch.cat([up, skip_stack.pop()], dim=-1))

    # back to the original point order: inv_0 ∘ permutation⁻¹ in one gather
    feats = feats[invs[0][invert_permutation(permutation)]]
    feats = _mlp(net.fc_end_0, feats)
    feats = _mlp(net.fc_end_1, feats)
    # dropout is the identity in eval mode
    return _mlp(net.fc_end_2, feats).T


def forward_eval_large(net: RandLANet, inputs: torch.Tensor, permutation: torch.Tensor,
                       chunk: int = 65536) -> torch.Tensor:
    """Eval forward (B, N, 3+F) -> logits (B, C, N), float32, each unfused
    LFA's neighbour pipeline streamed in ``chunk``-query pieces: the function of
    ``net(inputs, permutation)`` in eval mode, in float32 whatever the
    model's ``compute_dtype``. Clouds run one at a time (eval BatchNorm
    reads running statistics, so they are independent)."""
    if net.training:
        raise RuntimeError("forward_eval_large is eval only: call net.eval() first")
    with torch.profiler.record_function("r3d.forward"):
        permutation = permutation.long()
        return torch.stack([_forward_one(net, inputs[b], permutation, chunk)
                            for b in range(inputs.shape[0])])
