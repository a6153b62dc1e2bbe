"""Model facade: load/save/predict (counterpart of
``recognizer3d_tpu/models/facade.py``).

Same archive layout (a zip of a ``config`` JSON and a ``model`` blob holding
the flax msgpack of ``{"params", "batch_stats"}``), so archives move between
the two packages both ways, and the same predict contract: consistent
seed-0 subsample -> forward -> softmax -> upsample onto the full cloud.

Full clouds are padded with zeros to proportional buckets (``_bucket``),
which keeps the shapes the device sees few across live frames of varying
size; the padded rows are sliced off after the upsample. The host buffer
for the padded cloud is reused from frame to frame (and pinned when the
model runs on the GPU). The per-call random permutation is a numpy draw
under the caller's seed, as in the JAX package, so a seeded caller gives
both packages the same permutation.

With ``knn="approximate"`` in its Morton-window regime, the first predict of
a ``Model`` runs the session recall guard (``ops/knn.ensure_window_recall``)
on that cloud, as the JAX facade does.

``Model.load`` also reads the reference implementation's archives, whose
``model`` blob is a torch ``state_dict`` (``models/torch_compat.py``).

``Model.train`` and ``Model.evaluate`` run the training engine
(``training/trainer.py``) with the JAX facade's loaders: a shuffled,
augmented, randomly sampled training loader and a consistent, unshuffled
validation loader.

Eval forwards of clouds of ``LARGE_FORWARD_MIN_POINTS`` points or more
(``Model.predict(..., prepostprocess=False)``, or ``upsampling="none"``)
run the chunked million-point forward (``models/large.py``), as the JAX
facade routes them.
"""

import json
import logging
import os
import shutil
import tempfile
from dataclasses import asdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.data.augmentation import AugmentationSettings
from recognizer3d_tpu_torch.data.loader import get_data_loader
from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
from recognizer3d_tpu_torch.models.large import LARGE_FORWARD_MIN_POINTS, forward_eval_large
from recognizer3d_tpu_torch.models.randlanet import RandLANet
from recognizer3d_tpu_torch.models.settings import RandLANetSettings
from recognizer3d_tpu_torch.models.torch_compat import load_reference_weights
from recognizer3d_tpu_torch.models.weights import (
    from_flax_variables,
    to_flax_variables,
)
from recognizer3d_tpu_torch.ops import knn as knn_ops
from recognizer3d_tpu_torch.ops.upsample import upsample as upsample_features
from recognizer3d_tpu_torch.utils import msgpack_lite
from recognizer3d_tpu_torch.utils.device import resolve_device

_BUCKET = 4096  # minimum full-cloud padding granularity
# eval forwards at / beyond this cloud size stream the LFA neighbour
# pipeline in chunks (models/large.py)
_LARGE_FORWARD_MIN = LARGE_FORWARD_MIN_POINTS
# batched eval forwards with more total points than this run per cloud
_BATCHED_PER_CLOUD_MIN = 131072


def _bucket(n: int) -> int:
    """Round a full-cloud size up to its bucket: steps of up to 1/8 of the
    size, at least 4096, so padding waste stays below ~12.5%."""
    if n <= _BUCKET:
        return _BUCKET
    step = max(_BUCKET, 1 << (int(n).bit_length() - 4))
    return -(-n // step) * step


class Model:
    """RandLA-Net model wrapper with weight loading, saving, prediction,
    training and evaluation."""

    #: sampled recall@K of ``knn="approximate"`` below which ``evaluate``
    #: warns (outside the window regime, where there is no guard to act)
    KNN_RECALL_WARN_THRESHOLD = 0.9

    def __init__(
        self,
        settings: RandLANetSettings,
        weights: Optional[Dict[str, torch.Tensor]] = None,
        device="cuda",
        seed: int = 0,
        transfer_dtype: str = "float32",
    ):
        """
        :param settings: Model settings defining RandLANet.
        :param weights: Optional state_dict of this package's RandLANet
            (``models/weights.from_flax_variables`` makes one from flax
            variables). Without it the weights are drawn from ``seed``.
        :param device: where the model runs; the GPU unless the caller asks
            for ``"cpu"``. Raises when CUDA is asked for and missing.
        :param transfer_dtype: dtype of the host-to-device upload of full
            clouds in :meth:`predict` / :meth:`predict_mask`. "float16"
            halves the upload bytes; coordinates return to float32 on the
            device before any compute, so the only effect is input
            quantization (4.9e-4 relative, ~0.3 mm at a 0.6 m range).
            The default keeps exact parity.
        """
        assert transfer_dtype in ("float32", "float16"), transfer_dtype
        self.device = resolve_device(device)
        self._transfer_dtype = np.dtype(transfer_dtype)
        self.settings = settings
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self._module = RandLANet(settings)
        if weights is not None:
            self._module.load_state_dict(weights)
        self._module.to(self.device).eval()
        self._pad_buffer = None
        self._recall_guard_ran = False
        #: what the recall guard returned on this model's first
        #: window-regime cloud (None until it ran)
        self.recall_guard_result: Optional[dict] = None

    @property
    def module(self) -> RandLANet:
        """Underlying ``nn.Module``."""
        return self._module

    @property
    def transfer_dtype(self) -> str:
        return self._transfer_dtype.name

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------

    @staticmethod
    def load(path: Path, device="cuda", transfer_dtype: str = "float32",
             **kwargs) -> "Model":
        """Load a model archive written by either package (flax msgpack
        weights) or by the reference implementation (a torch
        ``state_dict``). kwargs override settings fields after load."""
        path = Path(path)
        assert path.is_file(), f"Could not find model file at {path}!"
        with tempfile.TemporaryDirectory() as tmp_str:
            tmp = Path(tmp_str)
            shutil.unpack_archive(str(path), tmp, format="zip")
            with (tmp / "config").open("r") as f:
                config = json.load(f)
            blob = (tmp / "model").read_bytes()
        known = {
            k: v for k, v in config.items()
            if k in RandLANetSettings.__dataclass_fields__
        }
        settings = RandLANetSettings(**known)
        for key, value in kwargs.items():
            if hasattr(settings, key):
                setattr(settings, key, value)
        return Model(
            settings,
            weights=from_flax_variables(Model._decode_weights(blob, settings)),
            device=device,
            transfer_dtype=transfer_dtype,
        )

    @staticmethod
    def _decode_weights(blob: bytes, settings: RandLANetSettings) -> Dict:
        """The archive's ``model`` blob -> flax-layout variables: a flax
        msgpack blob as it is, else a reference PyTorch ``state_dict``
        (``models/torch_compat.py``)."""
        try:
            restored = msgpack_lite.msgpack_restore(blob)
        except ValueError:
            restored = None
        if isinstance(restored, dict) and "params" in restored:
            return restored
        return load_reference_weights(blob, settings)

    def save(self, path: Path) -> None:
        """Save as a zip of ``config`` (JSON) + ``model`` (flax msgpack),
        readable by both packages."""
        path = Path(path)
        os.makedirs(path.parent, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp_str:
            tmp = Path(tmp_str)
            with (tmp / "config").open("w") as f:
                json.dump(asdict(self.settings), f)
            variables = to_flax_variables(self._module.state_dict())
            (tmp / "model").write_bytes(msgpack_lite.packb(variables))
            with tempfile.TemporaryDirectory() as tmp2:
                shutil.make_archive(str(Path(tmp2) / "file"), "zip", tmp)
                shutil.move(str(Path(tmp2) / "file.zip"), path)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------

    def _forward(self, inputs: torch.Tensor, permutation: torch.Tensor) -> torch.Tensor:
        if inputs.shape[1] >= _LARGE_FORWARD_MIN:
            return forward_eval_large(self._module, inputs, permutation)
        if inputs.shape[0] > 1 and inputs.shape[0] * inputs.shape[1] > _BATCHED_PER_CLOUD_MIN:
            # eval BN reads running stats, so clouds are independent: one
            # forward per cloud is numerically identical and keeps each
            # gather on a single cloud's table
            return torch.cat(
                [self._module(inputs[b : b + 1], permutation) for b in range(inputs.shape[0])]
            )
        return self._module(inputs, permutation)

    def _upsample_conf(self, confidences, xyz, xyz_upsampled) -> torch.Tensor:
        """confidences (B, C, N1) -> (B, C, N2)."""
        up = upsample_features(
            confidences.transpose(-1, -2),
            xyz,
            xyz_upsampled,
            approach=self.settings.upsampling,
            knn_approach=self.settings.knn if self.settings.knn != "kdtree" else "naive",
        )
        return up.transpose(-1, -2)

    def _predict_full(self, inputs_full, sample_idx, permutation) -> torch.Tensor:
        """Consistent subsample -> forward -> softmax -> full-cloud upsample,
        all on the device. The upload may arrive float16; compute is f32."""
        inputs_full = inputs_full.float()
        sampled = inputs_full[:, sample_idx]
        logits = self._module(sampled, permutation)
        confidences = torch.softmax(logits, dim=-2)
        return self._upsample_conf(confidences, sampled[..., :3], inputs_full[..., :3])

    def upsample(self, logits, xyz, xyz_upsampled) -> np.ndarray:
        """softmax(logits) upsampled onto ``xyz_upsampled``: logits (B, C, N1)
        -> confidences (B, C, N2). The target is bucket-padded as in
        :meth:`predict`."""
        xyz_upsampled = np.asarray(xyz_upsampled, dtype=np.float32)
        n_full = xyz_upsampled.shape[-2]
        n_padded = _bucket(n_full)
        if n_padded != n_full:
            pad_width = [(0, 0)] * xyz_upsampled.ndim
            pad_width[-2] = (0, n_padded - n_full)
            xyz_upsampled = np.pad(xyz_upsampled, pad_width)
        dev = self.device
        with torch.inference_mode():
            confidences = torch.softmax(torch.as_tensor(logits, device=dev).float(), dim=-2)
            out = self._upsample_conf(
                confidences,
                torch.as_tensor(np.asarray(xyz, np.float32), device=dev),
                torch.as_tensor(xyz_upsampled, device=dev),
            )
            return out[..., :n_full].cpu().numpy()

    def _knn_regime_warnings(self) -> None:
        """Guidance on the neighbour-search setting for this cloud size
        (the JAX facade's, for the routes this package has)."""
        if self.settings.knn == "kdtree":
            logging.warning(
                'knn="kdtree" runs the C++ KD-tree on the host inside the '
                "forward: each of its neighbour searches (one at every encoder "
                "level and decoder upsampling) copies the points to the host "
                "and the result back. Use it as a correctness oracle; prefer "
                'knn="naive" or "approximate" for latency.'
            )
        if self.settings.n_points > 20000:
            if self.settings.knn == "naive":
                logging.warning(
                    'knn="naive" for N > 20000 runs the brute-force exact KNN '
                    'kernel, whose cost grows with N²; consider '
                    'knn="approximate".'
                )
        elif self.settings.knn not in ("naive", "pallas", "kdtree"):
            logging.warning(
                "For improved performance, it is recommended to "
                'use knn="naive" when N < 20000.'
            )

    def _maybe_run_recall_guard(self, full_cloud: np.ndarray) -> None:
        """Session-first-frame recall guard, as the JAX facade's: when
        ``knn="approximate"`` is in its Morton-window regime at this model's
        n_points, probe the first cloud's sampled self-KNN recall and let
        ``ops/knn.ensure_window_recall`` widen the session window
        (4096 -> 8192 -> 16384) or demote the session to the exact route.
        Runs once per Model instance; opt out with RECOGNIZER3D_KNN_RECALL=0.

        :param full_cloud: (N, >=3) one representative host cloud; the
            probe samples it to n_points exactly like the forward will.
        """
        if self._recall_guard_ran or self.settings.knn != "approximate":
            return
        if os.environ.get("RECOGNIZER3D_KNN_RECALL", "") == "0":
            self._recall_guard_ran = True
            return
        if not knn_ops.window_regime_active(self.settings.n_points):
            self._recall_guard_ran = True
            return
        full_cloud = np.asarray(full_cloud, np.float32)
        if full_cloud.ndim != 2 or len(full_cloud) == 0:
            return
        self._recall_guard_ran = True
        idx = consistent_sample_indices(len(full_cloud), self.settings.n_points)
        self.recall_guard_result = knn_ops.ensure_window_recall(
            full_cloud[idx, :3], self.settings.n_neighbors, device=self.device
        )

    def _prepare_full(self, inputs: np.ndarray):
        """:meth:`_prepare_host`, with the padded cloud, the indices and the
        permutation on the device."""
        buf, indices, permutation, n_full = self._prepare_host(inputs)
        dev = self.device
        return (
            buf.to(dev, non_blocking=True),
            torch.from_numpy(indices).to(dev),
            torch.from_numpy(permutation).to(dev),
            n_full,
        )

    def _prepare_host(self, inputs: np.ndarray):
        """Host prep of the full-cloud predict paths: consistent sample
        indices, this call's random permutation (a numpy draw under the
        caller's seed), and bucket padding into a reused host buffer (pinned
        when the model runs on the GPU). Returns (the padded (B, bucket, C)
        tensor in the transfer dtype, indices, permutation (int64 numpy),
        N)."""
        n_full = inputs.shape[1]
        indices = np.array(
            consistent_sample_indices(n_full, self.settings.n_points), dtype=np.int64
        )
        permutation = np.random.permutation(self.settings.n_points).astype(np.int64)
        n_padded = _bucket(n_full)
        dtype = torch.from_numpy(np.zeros(0, self._transfer_dtype)).dtype
        buf_shape = (inputs.shape[0], n_padded, inputs.shape[2])
        buf = self._pad_buffer
        if buf is None or tuple(buf.shape) != buf_shape or buf.dtype != dtype:
            buf = torch.zeros(buf_shape, dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._pad_buffer = buf
        host = buf.numpy()
        host[:, :n_full] = inputs  # casts to the transfer dtype on copy
        host[:, n_full:] = 0.0
        return buf, indices, permutation, n_full

    @staticmethod
    def _batch_inputs(xyz: np.ndarray, features: Optional[np.ndarray]):
        assert xyz.shape[-1] == 3, "xyz should have shape (B) x N x 3!"
        batched = xyz.ndim == 3
        inputs = xyz if batched else np.expand_dims(xyz, 0)
        if features is not None:
            feats = features if features.ndim == 3 else features[None]
            assert inputs.shape[:2] == feats.shape[:2], (
                "xyz and features should have the same batch size and points!"
            )
            inputs = np.concatenate((inputs, feats), axis=-1)
        return inputs.astype(np.float32), batched

    def predict_mask(
        self,
        xyz: np.ndarray,
        threshold: float = 0.5,
        features: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Boolean foreground mask for one full cloud (the live loop's call):
        :meth:`predict`'s computation, thresholded on the device so one bool
        per point comes back.

        :param xyz: (N, 3) or (B, N, 3) coordinates.
        :return: (N,) or (B, N) bool, class-1 confidence > threshold.
        """
        inputs, batched = self._batch_inputs(xyz, features)
        self._maybe_run_recall_guard(inputs[0])
        padded, indices, permutation, n_full = self._prepare_full(inputs)
        with torch.inference_mode():
            conf = self._predict_full(padded, indices, permutation)
            mask = (conf[:, 1, :] > threshold)[:, :n_full].cpu().numpy()
        return mask if batched else mask[0]

    def predict(
        self,
        xyz: np.ndarray,
        features: Optional[np.ndarray] = None,
        prepostprocess: bool = True,
    ) -> np.ndarray:
        """Per-class confidences on one or a batch of point clouds.

        :param xyz: Point coordinates (B, N, 3) or (N, 3).
        :param features: Optional point features (B, N, F) or (N, F).
        :param prepostprocess: Include the consistent subsample to
            ``settings.n_points`` and the upsample back onto the full cloud.
        :return: Per-class confidences (B, C, N) or (C, N) as numpy.
        """
        self._knn_regime_warnings()
        inputs, batched = self._batch_inputs(xyz, features)
        self._maybe_run_recall_guard(inputs[0])
        if self.settings.upsampling == "none":
            prepostprocess = False
        with torch.inference_mode():
            if prepostprocess:
                padded, indices, permutation, n_full = self._prepare_full(inputs)
                predictions = self._predict_full(padded, indices, permutation)
                predictions = predictions[:, :, :n_full]
            else:
                permutation = np.random.permutation(inputs.shape[1]).astype(np.int64)
                logits = self._forward(
                    torch.from_numpy(inputs).to(self.device),
                    torch.from_numpy(permutation).to(self.device),
                )
                predictions = torch.softmax(logits, dim=-2)
            predictions = predictions.cpu().numpy()
        return predictions if batched else predictions[0]

    # ------------------------------------------------------------------
    # training / evaluation
    # ------------------------------------------------------------------

    def _check_knn_recall(self, dataset) -> None:
        """Sampled recall check on the first evaluation cloud when
        ``knn="approximate"``: in the Morton-window regime the acting guard
        (:meth:`_maybe_run_recall_guard`), below it a warning when the
        sampled recall@K falls under ``KNN_RECALL_WARN_THRESHOLD``. Opt out
        with RECOGNIZER3D_KNN_RECALL=0."""
        if self.settings.knn != "approximate":
            return
        if os.environ.get("RECOGNIZER3D_KNN_RECALL", "") == "0":
            return
        if len(dataset) == 0:
            return
        xyz = np.asarray(dataset[0][0], np.float32)[:, :3]  # the search is on xyz
        if len(xyz) == 0:
            return
        n = self.settings.n_points
        if knn_ops.window_regime_active(n):
            self._maybe_run_recall_guard(xyz)
            return
        idx = consistent_sample_indices(len(xyz), n)
        with torch.inference_mode():
            cloud = torch.from_numpy(np.ascontiguousarray(xyz[idx][None])).to(self.device)
            recall = knn_ops.measure_recall(cloud, cloud, self.settings.n_neighbors,
                                            "approximate")
        if recall < self.KNN_RECALL_WARN_THRESHOLD:
            logging.warning(
                "approximate-KNN sampled recall@%d on the evaluation data is %.3f "
                '(< %.2f); consider knn="naive" for this evaluation.',
                self.settings.n_neighbors, recall, self.KNN_RECALL_WARN_THRESHOLD,
            )

    def train(
        self,
        dataset_train: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        dataset_validation: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        training_settings=None,
        augmentation_settings: AugmentationSettings = AugmentationSettings(),
        log_dir: Optional[Path] = None,
        class_names: Optional[List[str]] = None,
        callbacks: List[Callable[[int, Dict[str, float]], None]] = [],
        pool=None,
    ):
        """Train this model in place; it ends with the best (``val_mIoU``)
        weights, in eval mode. Returns the Trainer (its ``history``: steps, times and metrics of
        each epoch). With ``training_settings.data_parallel_devices`` N > 1
        the steps run over N ranks, or over the ranks of ``pool`` (a
        ``parallel.mesh.RankPool`` whose rank 0 is on this model's device)."""
        from recognizer3d_tpu_torch.training.settings import TrainingSettings
        from recognizer3d_tpu_torch.training.trainer import Trainer

        if training_settings is None:
            training_settings = TrainingSettings()
        assert class_names is not None and len(class_names) == self.settings.n_classes, (
            "The length of given class names should correspond to the "
            "n_classes setting of the model"
        )
        try:
            # the guard may widen the session's window before training
            self._maybe_run_recall_guard(np.asarray(dataset_train[0][0], np.float32))
        except Exception:  # noqa: BLE001 — training goes on without the probe
            logging.warning("the recall guard's probe before training failed", exc_info=True)
        train_dataloader = get_data_loader(
            dataset_train, self.settings.n_points, training_settings.batch_size,
            shuffle=True, consistent_sampling=False,
            augmentation_settings=augmentation_settings,
        )
        validation_dataloader = get_data_loader(
            dataset_validation, self.settings.n_points, training_settings.batch_size,
            shuffle=False, consistent_sampling=True,
        )
        trainer = Trainer(train_dataloader, validation_dataloader, log_dir, class_names)
        trainer.train(self, training_settings, callbacks=callbacks, pool=pool)
        return trainer

    def evaluate(
        self,
        dataset: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        class_names: Optional[List[str]] = None,
        batch_size: int = 16,
        loss_function: str = "dice",
        postprocess: bool = False,
        include_stdev: bool = False,
    ) -> Dict:
        """The 10-seed evaluation protocol on ``dataset``; with
        ``include_stdev`` each value is (mean, standard deviation)."""
        from recognizer3d_tpu_torch.training.trainer import Trainer

        self._check_knn_recall(dataset)
        dataloader = get_data_loader(
            dataset, self.settings.n_points, batch_size, shuffle=False,
            consistent_sampling=True,
        )
        bag = Trainer.evaluate(self, dataloader, class_names, loss_function, postprocess)
        return bag.as_dict(include_stdev=include_stdev)
