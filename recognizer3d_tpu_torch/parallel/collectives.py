"""Sums over the running group of ranks, plain and differentiable (the
port's counterpart of the ``psum`` that XLA inserts under a JAX mesh).

The JAX package trains over several devices with one program: flax's
train-mode BatchNorm, the losses and the metrics reduce over the global
batch, and GSPMD inserts the collectives. Here each rank is a process
(``mesh.RankPool``), so the sums are written out:

- :func:`all_reduce_sum` sums a tensor over the ranks. Every rank stages its
  tensor through a (pinned) host buffer and sends it to every other rank in
  one point-to-point exchange (``mesh.exchange``); each rank then adds the
  D parts in rank order on the host. So the sum is the same bits on every
  rank, whatever gloo's own reduction order would be: replicated
  parameters stay bit-identical. It is the identity on one rank.
- :func:`replicated_sum` and :func:`to_ranks` are its two autograd forms
  (JAX's ``psum`` and ``pbroadcast``), and the rule that picks between them
  is in :func:`replicated_sum`'s docstring.
- :func:`all_reduce_grads` sums a module's parameter gradients in one
  exchange a step (the transpose of the parameters' replication).
- :func:`whole_batch` is the context in which the model's layers reduce
  over the ranks: train-mode BatchNorm, the losses and the batch metrics
  take the whole batch's sums (:func:`batch_sum`, :func:`batch_ranks`)
  inside it and the tensor in hand outside it, the default. The callers
  that shard a batch over the ranks enter it (``training/data_parallel.py``),
  so no other forward in a rank is synced behind its caller's back.

Each takes a list of tensors of one dtype and makes one exchange of their
concatenation, so a BatchNorm pays one round trip a forward and one a
backward.
"""

from contextlib import contextmanager
from typing import List, Sequence

import torch

from recognizer3d_tpu_torch.parallel import mesh


def _host(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) on the host: a pinned copy of a device tensor, a
    copy of a host one."""
    if t.device.type == "cpu":
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.detach(), non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over the ranks of ``t`` (every rank passes the same shape and
    dtype), the parts added in rank order, on ``t``'s device. No autograd."""
    d, me = mesh.world(), mesh.rank()
    if d == 1:
        return t
    # a range the profiler reads (profile_port.py): the collectives' share of a step
    with torch.profiler.record_function("r3d.all_reduce_sum"):
        host = _host(t.contiguous())
        cpu = torch.device("cpu")
        got = mesh.exchange([(host, r) for r in range(d) if r != me],
                            [(tuple(host.shape), host.dtype, r) for r in range(d) if r != me],
                            cpu)
        parts = got[:me] + [host] + got[me:]
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        return total.to(t.device, non_blocking=True)


def _flat_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """:func:`all_reduce_sum` of several tensors of one dtype in one exchange."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    total = all_reduce_sum(flat)
    out, start = [], 0
    for t in tensors:
        out.append(total[start:start + t.numel()].view(t.shape))
        start += t.numel()
    return out


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        return tuple(t.clone() for t in _flat_sum(xs))

    @staticmethod
    def backward(ctx, *gs):
        return gs


class _ToRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        # every rank joins the sum, also where its block left an output unused
        some = next(g for g in gs if g is not None)
        gs = [some.new_zeros(shape) if g is None else g for g, shape in zip(gs, ctx.shapes)]
        return tuple(t.clone() for t in _flat_sum(gs))


def replicated_sum(*xs: torch.Tensor):
    """Σ over the ranks of each of ``xs`` (one dtype), the result the same
    on every rank; differentiable. Returns one tensor, or a tuple of them.

    The rule of the two autograd forms. Call a value *replicated* when every
    rank holds it and computes the same from it (the sums here, the
    statistics and the loss built from them), and *per-rank* when each rank
    holds its own (its block of the batch or the cloud, and all that follows
    from it). The step's loss is replicated and every rank seeds its
    backward with 1: the loss counts once, not D times. Then

    - at a per-rank → replicated edge (this function, JAX's ``psum``), every
      rank's cotangent of the sum is already the whole cotangent, so the
      backward is the identity: ∂L/∂x_r = ∂L/∂Σ. Summing the ranks'
      cotangents again would count the loss D times;
    - at a replicated → per-rank edge (:func:`to_ranks`, JAX's
      ``pbroadcast``), each rank's cotangent is its own block's share, so
      the backward sums them over the ranks.

    A replicated parameter entering every rank's block is such an edge too:
    :func:`all_reduce_grads` is its backward. Outside a group (one rank)
    both forms are the identity."""
    if mesh.world() == 1:
        return xs[0] if len(xs) == 1 else xs
    out = _ReplicatedSum.apply(*xs)
    return out[0] if len(xs) == 1 else out


def to_ranks(*xs: torch.Tensor):
    """Replicated ``xs`` (one dtype) where they enter each rank's own
    computation: the identity forward, the sum of the ranks' cotangents
    backward (see :func:`replicated_sum`)."""
    if mesh.world() == 1:
        return xs[0] if len(xs) == 1 else xs
    out = _ToRanks.apply(*xs)
    return out[0] if len(xs) == 1 else out


_whole_batch = False


@contextmanager
def whole_batch():
    """Within the block each rank of the running group holds its block of
    one batch (every rank's block the same size), and train-mode BatchNorm,
    the losses and the batch metrics are the whole batch's."""
    global _whole_batch
    saved, _whole_batch = _whole_batch, True
    try:
        yield
    finally:
        _whole_batch = saved


def batch_ranks() -> int:
    """The number of ranks the batch in hand is split over: the running
    group's size inside :func:`whole_batch`, else 1."""
    return mesh.world() if _whole_batch else 1


def batch_sum(*xs: torch.Tensor):
    """:func:`replicated_sum` of ``xs`` inside :func:`whole_batch`; outside
    it, ``xs`` as they are. Returns one tensor, or a tuple of them."""
    if batch_ranks() == 1:
        return xs[0] if len(xs) == 1 else xs
    return replicated_sum(*xs)


def all_reduce_grads(parameters) -> None:
    """Sum every parameter's ``.grad`` over the ranks, in place, in one
    exchange (a parameter without a gradient counts as zeros). Nothing on one
    rank. The parameters must share one dtype."""
    if mesh.world() == 1:
        return
    params = list(parameters)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    with torch.no_grad():
        for p, total in zip(params, _flat_sum([p.grad for p in params])):
            p.grad.copy_(total)
