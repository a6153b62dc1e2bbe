"""Serving over several ranks (counterpart of
``recognizer3d_tpu/parallel/serving.py``).

- :class:`DPServing` shards each batch of clouds over the ranks: eval
  frames are independent (BatchNorm reads its running statistics), so each
  rank runs the single-card predict program on its block of the batch.
- :class:`SPServing` shards each cloud's points over the ranks and runs the
  full-resolution point-sharded forward (``parallel/sp_model.py``): every
  point classified by the network, no subsample and upsample.

Both start a pool of ranks (``parallel/mesh.RankPool``) on an explicit list
of devices, the counterpart of the JAX mesh's device list (a card may
repeat in it), or run on a pool the caller started. Rank 0 is the caller,
with the caller's ``Model``; the workers get its settings and weights once,
at construction (a model whose weights change afterwards needs a new
server). Close a server (or use it as a context manager) to stop the
workers of the pool it started, or to drop its model from a pool it was
given.
"""

from dataclasses import asdict

import numpy as np
import torch

from recognizer3d_tpu_torch.ops import knn as knn_ops
from recognizer3d_tpu_torch.parallel import mesh
from recognizer3d_tpu_torch.parallel.sp_model import SPBackend, pad_for_sharding


def _adopt_model(key: str, root=None) -> None:
    """Every rank keeps a model under ``key``: rank 0 has the caller's, the
    workers build one from rank 0's settings and weights (broadcast)."""
    payload = mesh.replicate(root)
    if mesh.rank() == 0:
        return
    from recognizer3d_tpu_torch.models.facade import Model
    from recognizer3d_tpu_torch.models.settings import RandLANetSettings

    settings, weights, transfer_dtype = payload
    mesh.local()[key] = Model(RandLANetSettings(**settings), weights=weights,
                              device=mesh.device(), transfer_dtype=transfer_dtype)


def _dp_predict(key: str, threshold, root=None):
    """One batch on every rank: rank 0's host prep (padded batch, sample
    indices, permutation, session recall guard) goes out, each rank runs
    ``Model._predict_full`` on its block of clouds and thresholds on its
    device (``threshold`` None: the confidences), and rank 0 gets the
    blocks back."""
    model = mesh.local()[key]
    buf = None if root is None else root[0]
    indices, permutation, guard, shape, dtype = mesh.replicate(
        None if root is None else (*root[1:], tuple(buf.shape), buf.dtype))
    knn_ops.adopt_session_guard(guard)
    block = mesh.scatter_blocks(buf, 0, shape, dtype)
    dev = model.device
    with torch.inference_mode():
        conf = model._predict_full(
            block.to(dev, non_blocking=True),
            torch.from_numpy(indices).to(dev),
            torch.from_numpy(permutation).to(dev),
        )
        out = (conf if threshold is None else conf[:, 1, :] > threshold).cpu()
    return mesh.gather_blocks(out, axis=0)


def _sp_confidences(key: str, root=None):
    """One permuted cloud on every rank: each rank runs the point-sharded
    forward on its block, and rank 0 gets the confidences (B, C, N), in the
    permuted order."""
    model = mesh.local()[key]
    shape, dtype = mesh.replicate(None if root is None else (tuple(root.shape), root.dtype))
    block = mesh.scatter_blocks(root, 1, shape, dtype)
    with torch.inference_mode():
        logits = model.module(block.to(model.device), None, backend=SPBackend())
        conf = torch.softmax(logits, dim=-2).cpu()
    return mesh.gather_blocks(conf, axis=2)


class _RankServing:
    """A pool of ranks holding one model each."""

    def __init__(self, model, devices):
        self._owns_pool = not isinstance(devices, mesh.RankPool)
        first = list(devices)[0] if self._owns_pool else devices.devices[0]
        if mesh.normalize_device(first) != mesh.normalize_device(model.device):
            raise ValueError(f"rank 0 runs the caller's model, on {model.device}; the ranks' "
                             f"devices start with {first}")
        self._model = model
        self.pool = mesh.RankPool(devices) if self._owns_pool else devices
        self._key = f"{type(self).__name__}-{id(self)}"
        mesh.local()[self._key] = model
        state = {k: v.detach().cpu() for k, v in model.module.state_dict().items()}
        try:
            self.pool.run(_adopt_model, self._key,
                          root=(asdict(model.settings), state, model.transfer_dtype))
        except BaseException:
            mesh.forget(self._key)
            raise

    @property
    def devices(self):
        return self.pool.devices

    def close(self) -> None:
        """Stop the worker ranks of a pool this server started; on a given
        pool, drop this server's model from every rank."""
        mesh.forget(self._key)
        if self._owns_pool:
            self.pool.close()
        elif not self.pool.closed:
            self.pool.run(mesh.forget, self._key)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class DPServing(_RankServing):
    """Batch ``predict`` / ``predict_mask`` over data-parallel ranks.

    Mirrors :meth:`Model.predict` / :meth:`Model.predict_mask`: the same host
    prep (consistent sample indices, one permutation drawn for the whole
    batch under the caller's numpy seed, bucket padding) and the same
    device program on each rank's block of clouds. A batch that does not
    divide over the ranks is padded by repeating its last cloud, and the
    padding rows are dropped. Each call hands the workers rank 0's session
    recall guard (``ops/knn``), which the JAX package's shards share in one
    process.

    :param model: the caller's ``Model``; rank 0 runs it.
    :param devices: one device a rank, ``devices[0]`` the model's; or a
        running ``RankPool`` whose rank 0 is on the model's device.
    """

    @property
    def n_devices(self) -> int:
        return self.pool.n_ranks

    def _run(self, xyz, threshold) -> np.ndarray:
        inputs = np.asarray(xyz, dtype=np.float32)
        assert inputs.ndim == 3 and inputs.shape[-1] == 3, (
            "DPServing expects a batch (B, N, 3) of clouds"
        )
        b = inputs.shape[0]
        pad_b = (-b) % self.n_devices
        if pad_b:
            inputs = np.concatenate((inputs, np.repeat(inputs[-1:], pad_b, axis=0)), axis=0)
        buf, indices, permutation, n_full = self._model._prepare_host(inputs)
        root = (buf, indices, permutation, knn_ops.session_guard_state())
        out = self.pool.run(_dp_predict, self._key, threshold, root=root)[0]
        return out.numpy()[:b, ..., :n_full]

    def predict_mask(self, xyz: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """(B, N) bool foreground masks, class-1 confidence > threshold."""
        return self._run(xyz, float(threshold))

    def predict(self, xyz: np.ndarray) -> np.ndarray:
        """(B, C, N) per-class confidences."""
        return self._run(xyz, None)


class SPServing(_RankServing):
    """Full-resolution point-sharded serving of large clouds.

    :class:`DPServing` scales clouds a second; this scales points a cloud.
    Each cloud is padded with duplicates of its points (``pad_for_sharding``)
    up to its proportional bucket rounded to the sharding granule, then
    permuted, both from this server's ``RandomState(0)`` in the JAX
    package's order. Rank 0 sends each rank its block of the permuted
    cloud, the ranks run the point-sharded forward, and rank 0 un-permutes
    the confidences and drops the padding.

    :param model: the caller's ``Model``; rank 0 runs it.
    :param devices: one device a rank, ``devices[0]`` the model's; or a
        running ``RankPool`` whose rank 0 is on the model's device.
    """

    def __init__(self, model, devices):
        super().__init__(model, devices)
        self._rng = np.random.RandomState(0)

    @property
    def n_shards(self) -> int:
        return self.pool.n_ranks

    def _predict_one(self, cloud: np.ndarray) -> np.ndarray:
        from recognizer3d_tpu_torch.models.facade import _bucket

        padded, n = pad_for_sharding(cloud, self._model.settings, self.n_shards,
                                     n_target=_bucket(cloud.shape[0]), rng=self._rng)
        permutation = self._rng.permutation(padded.shape[0])
        x = torch.from_numpy(np.ascontiguousarray(padded[permutation][None], np.float32))
        conf_perm = self.pool.run(_sp_confidences, self._key, root=x)[0][0].numpy()
        conf = np.empty_like(conf_perm)
        conf[:, permutation] = conf_perm
        return conf[:, :n]

    def predict(self, xyz: np.ndarray) -> np.ndarray:
        """(C, N) or (B, C, N) full-resolution per-class confidences."""
        xyz = np.asarray(xyz, dtype=np.float32)
        if xyz.ndim == 2:
            return self._predict_one(xyz)
        return np.stack([self._predict_one(c) for c in xyz])

    def predict_mask(self, xyz: np.ndarray, threshold: float = 0.5) -> np.ndarray:
        """(N,) or (B, N) bool: class-1 confidence above the threshold."""
        return self.predict(xyz)[..., 1, :] > threshold
