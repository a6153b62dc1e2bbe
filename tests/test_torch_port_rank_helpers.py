"""Helpers of the rank tests, with no tests of their own: a function's
vector-Jacobian product over sharded inputs on a ``parallel.mesh.RankPool``
(as ``jax.vjp`` inside ``shard_map``), and ``shard_map`` over a DP×SP grid
of ranks. Both run their function inside ``collectives.whole_batch()``, as
the data-parallel and point-sharded steps do.

The workers import this module by name, so it imports only numpy, torch
and the port.
"""

from typing import Optional

import numpy as np
import torch

from recognizer3d_tpu_torch.parallel import collectives, mesh


def _shard(x, axis: int, batch_shards: int = 1):
    if isinstance(x, torch.Tensor) and x.dim() > axis:
        return mesh.block_of(x, mesh.rank(), axis, batch_shards).to(mesh.device())
    return x


def vjp_rank(fn, args, kwargs, cotangent, axis: int, out_axis: int, out_index):
    """The body of :func:`vjp` on one rank: ``fn`` on this rank's blocks
    (floating tensors made leaves that require grad), its output
    (``out_index``'s of a tuple) back-propagated from this rank's block of
    ``cotangent`` (the whole of it where it has no ``out_axis``: a
    replicated output). Returns (output, gradients of the arguments) as
    numpy, and for a module ``fn`` its parameters' gradients summed over the
    ranks and its buffers, by name."""
    args = [_shard(a, axis) for a in args]
    args = [a.detach().requires_grad_(True)
            if isinstance(a, torch.Tensor) and a.is_floating_point() else a for a in args]
    if isinstance(fn, torch.nn.Module):
        fn.to(mesh.device())
    with collectives.whole_batch():
        out = fn(*args, **kwargs)
        if out_index is not None:
            out = out[out_index]
        out.backward(_shard(cotangent, out_axis).to(out.dtype))
    grads = tuple(mesh._to_numpy(a.grad) if isinstance(a, torch.Tensor) and a.grad is not None
                  else None for a in args)
    module = {}
    if isinstance(fn, torch.nn.Module):
        collectives.all_reduce_grads(fn.parameters())
        module = {"grads": {n: mesh._to_numpy(p.grad).copy() for n, p in fn.named_parameters()},
                  "buffers": {n: mesh._to_numpy(b).copy() for n, b in fn.named_buffers()}}
    return mesh._to_numpy(out.detach()), grads, module


def vjp(pool, fn, *args, cotangent: torch.Tensor, axis: int = 1,
        out_axis: Optional[int] = None, out_index: Optional[int] = None, **kwargs):
    """The vector-Jacobian product of ``fn`` over sharded inputs: every rank
    runs ``fn`` on its block (along ``axis``) of every tensor argument and
    back-propagates its block of ``cotangent`` along ``out_axis`` (default
    ``axis``); a cotangent without that axis (a replicated scalar output)
    goes whole to every rank. Returns (the output joined along
    ``out_axis``, or rank 0's where it is replicated; the arguments'
    gradients joined along ``axis``; rank 0's module readings of
    :func:`vjp_rank`)."""
    out_axis = axis if out_axis is None else out_axis
    outs = pool.run(vjp_rank, fn, args, kwargs, cotangent, axis, out_axis, out_index)
    values = [o[0] for o in outs]
    joined = values[0] if values[0].ndim <= out_axis else np.concatenate(values, axis=out_axis)
    grads = tuple(None if g[0] is None else np.concatenate(g, axis=axis)
                  for g in zip(*(o[1] for o in outs)))
    return joined, grads, outs[0][2]


def map_rank(fn, args, kwargs, axis: int = 1, batch_shards: int = 1):
    """``fn`` on this rank's block of every tensor argument (on a grid of
    ``batch_shards`` rows, its row's block of axis 0 too), without
    autograd; the result's tensors as numpy."""
    args = [_shard(a, axis, batch_shards) for a in args]
    with torch.inference_mode(), collectives.whole_batch():
        return mesh._to_numpy(fn(*args, **kwargs))


def grid_map(pool, fn, *args, axis: int = 1, out_axis: Optional[int] = None,
             batch_shards: int = 1, **kwargs):
    """``mesh.shard_map`` over a grid of ``batch_shards`` rows
    (``P("batch", "points")``): each row takes its block of axis 0, each of
    its ranks its block of ``axis``; the blocks of the result are joined
    along ``out_axis`` (default ``axis``) within a row and the rows along
    axis 0."""
    out_axis = axis if out_axis is None else out_axis
    outs = pool.run(map_rank, fn, args, kwargs, axis, batch_shards)
    columns = pool.n_ranks // batch_shards

    def join(parts):
        rows = [np.concatenate(parts[i:i + columns], axis=out_axis)
                for i in range(0, len(parts), columns)]
        return np.concatenate(rows, axis=0)

    if isinstance(outs[0], tuple):
        return tuple(join(parts) for parts in zip(*outs))
    return join(outs)
