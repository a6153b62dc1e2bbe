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

Eval only: a point-sharded train step (cross-shard BatchNorm statistics) is
ROADMAP A9b.
"""

from typing import Optional, Tuple

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


class SPBackend:
    """The neighbourhood operations of the eval forward over the running
    group's ranks (``parallel/mesh.py``), each tensor this rank's block of
    a point-sharded one."""

    @property
    def n_shards(self) -> int:
        return mesh.world()

    def knn_gather(
        self, support: torch.Tensor, query: torch.Tensor, table: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Exact KNN and the neighbours' rows, one ring pass."""
        return ring_knn_gather(support, query, table, k)

    def gather(self, features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Rows by global point ids, one ring pass."""
        return ring_gather(features, idx)

    def constrain(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's block of the first ``n`` rows of the point-sharded
        (B, N, ...) array whose block is ``x``: the decimation prefix
        rebalanced onto the block layout. Each rank sends the rows other
        ranks' new blocks take from its old block, and receives its own."""
        d, me = mesh.world(), mesh.rank()
        old = x.shape[1]
        if n % d:
            raise ValueError(f"prefix of {n} rows does not split over {d} ranks")
        new = n // d
        if d == 1:
            return x[:, :new]
        out = torch.empty((x.shape[0], new, *x.shape[2:]), dtype=x.dtype, device=x.device)
        sends, recvs, slots = [], [], []
        for peer in range(d):
            # rows of peer's new block held in my old block
            lo, hi = max(peer * new, me * old), min((peer + 1) * new, (me + 1) * old)
            if lo < hi:
                piece = x[:, lo - me * old : hi - me * old]
                if peer == me:
                    out[:, lo - me * new : hi - me * new] = piece
                else:
                    sends.append((piece, peer))
            # rows of my new block held in peer's old block
            lo, hi = max(me * new, peer * old), min((me + 1) * new, (peer + 1) * old)
            if lo < hi and peer != me:
                recvs.append(((x.shape[0], hi - lo, *x.shape[2:]), x.dtype, peer))
                slots.append((lo - me * new, hi - me * new))
        for (a, b), got in zip(slots, mesh.exchange(sends, recvs, x.device)):
            out[:, a:b] = got
        return out

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
        on this rank's device."""
        return inputs.chunk(self.n_shards, dim=1)[mesh.rank()].to(mesh.device())

