"""Point-sharded (sequence-parallel) RandLA-Net: counterpart of
``recognizer3d_tpu/parallel/sp_model.py``.

For clouds beyond one card the point axis N is block-sharded over the ranks.
The network is not reimplemented: ``RandLANet.forward(..., backend=
SPBackend())`` routes every neighbourhood operation of the eval forward
through the ring exchanges of ``parallel/ring_knn.py``:

- each LFA's self-KNN and first neighbour gather are one ring pass
  (``ring_knn_gather``), the second gather one more (``ring_gather``);
- each decoder 1-NN upsample is a ring pass at k = 1;
- each decimation prefix is rebalanced onto the block layout
  (:meth:`SPBackend.constrain`): rank r's new block lies in old rank
  ⌊r/d⌋'s block, so one point-to-point receive a rank, not an all-gather;
- everything else is pointwise or dense and runs on each rank's block.

The JAX module also takes the global permutation and its inverse inside
the forward, which GSPMD lowers to all-to-alls; here the caller permutes
the cloud on the host and un-permutes the output (``SPServing``). Eval
BatchNorm and the head are pointwise, so the result is the same.

The train step runs the same forward in train mode, its backward through
the ring: the gathered rows' cotangents travel back to their owners
(``ring_knn.py``) and :meth:`SPBackend.constrain`'s to their senders;
inside ``parallel/collectives.whole_batch()`` train-mode BatchNorm takes
its statistics over every point of every rank (the ``psum`` XLA inserts for
JAX), the losses their sums likewise, and the parameter gradients are summed
over the ranks (``training/trainer.train_step``, which
``training/data_parallel.step`` calls with this backend).

``SPBackend(batch_shards=R)`` runs the DP×SP grid (JAX's ``batch_axis``):
the ranks form R rows, each row takes its block of the batch, and each
row's ranks form the ring of its own point axis (``mesh.ring``).
"""

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.parallel import mesh
from recognizer3d_tpu_torch.parallel.ring_knn import ring_gather, ring_knn_gather


def sharding_multiple(settings, n_shards: int) -> int:
    """The point-count granule of point-sharded execution: with N a multiple
    of ``decimation^n_layers · n_shards`` every decimation level is exact
    and divisible by the shard count, as
    :meth:`SPBackend.check_level_sizes` requires."""
    return int(n_shards) * int(settings.decimation) ** settings.n_layers


def pad_for_sharding(
    cloud: np.ndarray,
    settings,
    n_shards: int,
    n_target: int = 0,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, int]:
    """Pad a cloud's point axis up to the smallest multiple of
    :func:`sharding_multiple` that is at least N, ``settings.min_n_points``
    and ``n_target``, with random duplicates of real points (the sampler's
    own padding, so duplicate neighbours at distance 0 are inputs the model
    knows); the same ``RandomState`` draws as the JAX package's.

    :param cloud: (N, C) or (B, N, C).
    :return: (padded cloud, N) — callers slice outputs back to N.
    """
    cloud = np.asarray(cloud)
    n = cloud.shape[-2]
    if n < 1:
        raise ValueError("cannot pad an empty cloud")
    granule = sharding_multiple(settings, n_shards)
    target = max(n, settings.min_n_points, int(n_target))
    target = -(-target // granule) * granule
    if target == n:
        return cloud, n
    rng = rng if rng is not None else np.random.RandomState(0)
    dup = rng.randint(0, n, target - n)
    return np.concatenate([cloud, cloud[..., dup, :]], axis=-2), n


def _constrain_plan(d: int, me: int, old: int, new: int):
    """The rows that move when position ``me`` of a ring of ``d`` rebalances
    the first ``d·new`` rows of a block-sharded array (blocks of ``old``
    rows) onto blocks of ``new``: (outgoing, incoming), outgoing (peer, lo,
    hi) rows of my old block that land in peer's new block, incoming (peer,
    lo, hi) rows of my new block held in peer's old block (local offsets;
    peer == me is the piece that stays)."""
    outgoing, incoming = [], []
    for peer in range(d):
        lo, hi = max(peer * new, me * old), min((peer + 1) * new, (me + 1) * old)
        if lo < hi:
            outgoing.append((peer, lo - me * old, hi - me * old))
        lo, hi = max(me * new, peer * old), min((me + 1) * new, (peer + 1) * old)
        if lo < hi:
            incoming.append((peer, lo - me * new, hi - me * new))
    return outgoing, incoming


def _move_rows(x: torch.Tensor, rows: int, sends: List[Tuple[int, int, int]],
               recvs: List[Tuple[int, int, int]], on: mesh.Ring) -> torch.Tensor:
    """A (B, rows, ...) tensor whose slices ``recvs`` (peer, lo, hi) come
    from the ring's peers (from ``x`` itself for peer == me, whose matching
    send names the source rows), the rest zeros, after sending ``x``'s
    slices ``sends`` (peer, lo, hi) to them. One exchange."""
    me = on.position
    out = torch.zeros((x.shape[0], rows, *x.shape[2:]), dtype=x.dtype, device=x.device)
    own = [(lo, hi) for peer, lo, hi in sends if peer == me]
    for (peer, lo, hi), (a, b) in zip([r for r in recvs if r[0] == me], own):
        out[:, lo:hi] = x[:, a:b]
    away = [r for r in recvs if r[0] != me]
    # a range the profiler reads (profile_port.py)
    with torch.profiler.record_function("r3d.constrain"):
        got = mesh.exchange(
            [(x[:, lo:hi], on.peer(peer)) for peer, lo, hi in sends if peer != me],
            [((x.shape[0], hi - lo, *x.shape[2:]), x.dtype, on.peer(peer))
             for peer, lo, hi in away],
            x.device)
    for (_, lo, hi), part in zip(away, got):
        out[:, lo:hi] = part
    return out


class _Constrain(torch.autograd.Function):
    """The prefix rebalance and its inverse exchange: each received row's
    cotangent goes back to its sender; rows past the prefix get zeros."""

    @staticmethod
    def forward(ctx, x, n, on):
        d, old = on.size, x.shape[1]
        ctx.plan, ctx.old, ctx.on = _constrain_plan(d, on.position, old, n // d), old, on
        outgoing, incoming = ctx.plan
        return _move_rows(x, n // d, outgoing, incoming, on)

    @staticmethod
    def backward(ctx, g):
        outgoing, incoming = ctx.plan
        return _move_rows(g.contiguous(), ctx.old, incoming, outgoing, ctx.on), None, None


@dataclass(frozen=True)
class SPBackend:
    """The neighbourhood operations of the forward over the running group's
    ranks (``parallel/mesh.py``), each tensor this rank's block of a
    point-sharded one; with ``batch_shards`` > 1, of a DP×SP grid's."""

    batch_shards: int = 1

    @property
    def ring(self) -> mesh.Ring:
        """This rank's point axis."""
        return mesh.ring(self.batch_shards)

    @property
    def n_shards(self) -> int:
        return self.ring.size

    def knn_gather(
        self, support: torch.Tensor, query: torch.Tensor, table: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact KNN and the neighbours' rows, one ring pass."""
        return ring_knn_gather(support, query, table, k, self.ring)

    def gather(self, features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows by global point ids, one ring pass."""
        return ring_gather(features, idx, self.ring)

    def constrain(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's block of the first ``n`` rows of the point-sharded
        (B, N, ...) array whose block is ``x``: the decimation prefix
        rebalanced onto the block layout. Each rank sends the rows other
        ranks' new blocks take from its old block, and receives its own;
        differentiable (the cotangents return to their senders)."""
        on = self.ring
        if n % on.size:
            raise ValueError(f"prefix of {n} rows does not split over {on.size} ranks")
        if on.size == 1:
            return x[:, :n]
        if x.requires_grad and torch.is_grad_enabled():
            return _Constrain.apply(x, n, on)
        outgoing, incoming = _constrain_plan(on.size, on.position, x.shape[1], n // on.size)
        return _move_rows(x, n // on.size, outgoing, incoming, on)

    def check_level_sizes(self, level_sizes) -> None:
        n_shards = self.n_shards
        for n in level_sizes:
            if n % n_shards != 0:
                raise ValueError(
                    f"point-sharded forward needs every decimation level "
                    f"divisible by the {n_shards}-way point axis; got level "
                    f"size {n} (pad N to a multiple of "
                    f"decimation^n_layers * n_shards)"
                )

    def shard_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        """This rank's block of (B, N, ...) inputs that every rank holds,
        on this rank's device: its row's block of the batch, its ring
        position's block of the points."""
        return mesh.block_of(inputs, mesh.rank(), 1, self.batch_shards).to(mesh.device())
