"""Live prediction from raw depth frames (counterpart of
``recognizer3d_tpu/models/live.py``).

The app runs this tick whenever the camera exposes raw depth. Per frame the
host uploads the raw z16 image (1.5 MB at 1024×768) and the permutation,
the device runs

    depth -> pinhole dewarp -> z-band filter -> fixed-size random subsample
          -> consistent model subsample -> forward -> softmax
          -> 1-NN upsample onto the display cloud -> threshold

and the host downloads one packed (n_display, 4) float16 array of display
cloud and mask. The program is eager PyTorch.
"""

from typing import Tuple

import numpy as np
import torch

from recognizer3d_tpu_torch.data.pipeline import (
    DepthIntrinsics,
    Z_MAX,
    Z_MIN,
    depth_to_cloud,
    z_filter_subsample,
)
from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
from recognizer3d_tpu_torch.ops.upsample import upsample as upsample_features

__all__ = ["DepthIntrinsics", "LivePredictor", "depth_to_cloud"]


class LivePredictor:
    """Fused live-frame predictor over a loaded ``Model``.

    ``predict_depth(depth_u16)`` -> (cloud (n_display, 3) float32, mask
    (n_display,) bool), the mask being class-1 confidence > threshold over
    the subsampled display cloud.

    Per frame the host does: one permutation draw (numpy's global RNG, as
    ``Model.predict``), one upload of the z16 frame from a reused pinned
    buffer and one of the permutation, one download (the packed float16
    cloud and mask: display precision, about 0.3 mm at 0.6 m). The uniform
    priorities
    of the subsample come from a ``torch.Generator`` on the model's device,
    seeded 0 (JAX draws threefry keys from ``RandomState(0)``; the two
    generators give different numbers).
    """

    def __init__(
        self,
        model,
        confidence_threshold: float = 0.5,
        n_display: int = 16384,
        intrinsics: DepthIntrinsics = DepthIntrinsics(),
        z_band: Tuple[float, float] = (Z_MIN, Z_MAX),
    ):
        self._model = model
        self.confidence_threshold = confidence_threshold
        self._intr = intrinsics
        settings = model.settings
        dev = model.device
        sample_idx = torch.from_numpy(
            np.array(consistent_sample_indices(n_display, settings.n_points), np.int64)
        ).to(dev)
        knn_approach = settings.knn if settings.knn != "kdtree" else "naive"

        @torch.inference_mode()
        def program(depth, uniform, permutation, threshold) -> torch.Tensor:
            """(H, W) z16 depth, (1, H·W) uniform draw, (n_points,)
            permutation, threshold -> (n_display, 4) float16: xyz and the
            mask. The threshold is compared in float32."""
            cloud = depth_to_cloud(depth, intrinsics)
            pts, valid = z_filter_subsample(
                uniform, cloud, n_display, z_band[0], z_band[1]
            )
            sampled = pts[sample_idx][None]  # (1, n_points, 3)
            logits = model.module(sampled, permutation)
            conf = torch.softmax(logits, dim=-2)  # (1, C, n_points)
            conf_up = upsample_features(
                conf.transpose(-1, -2),
                sampled[..., :3],
                pts[None],
                approach=settings.upsampling,
                knn_approach=knn_approach,
            )[0]  # (n_display, C)
            mask = (conf_up[:, 1] > float(np.float32(threshold))) & valid
            return torch.cat([pts, mask[:, None].to(pts.dtype)], dim=-1).to(torch.float16)

        self.program_fn = program
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(0)
        self._host_buf = None
        # warm-up: the first frame pays the one-time costs (kernel build and
        # load, allocator). The all-zero frame must not feed the recall guard.
        self._warm = False
        self.predict_depth(np.zeros((intrinsics.height, intrinsics.width), np.uint16))
        self._warm = True

    def _upload(self, depth: np.ndarray) -> torch.Tensor:
        """Copy the z16 frame into a reused uint16 buffer, pinned on a GPU
        model, and upload it in one copy."""
        dev = self._model.device
        buf = self._host_buf
        if buf is None:
            buf = torch.empty(
                (self._intr.height, self._intr.width), dtype=torch.uint16,
                pin_memory=dev.type == "cuda",
            )
            self._host_buf = buf
        buf.numpy()[:] = depth
        return buf.to(dev, non_blocking=True)

    def predict_depth(self, depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One live frame: (display cloud (n_display, 3) float32, mask)."""
        depth = np.asarray(depth)
        if depth.shape != (self._intr.height, self._intr.width):
            raise ValueError(
                f"depth of shape {depth.shape}, expected "
                f"({self._intr.height}, {self._intr.width})"
            )
        permutation = np.random.permutation(self._model.settings.n_points).astype(np.int64)
        with torch.inference_mode():
            depth_dev = self._upload(depth)
            perm_dev = torch.from_numpy(permutation).to(self._model.device)
            uniform = torch.rand(
                (1, depth.size), generator=self._gen, device=self._model.device
            )
            packed = self.program_fn(
                depth_dev, uniform, perm_dev, self.confidence_threshold
            ).cpu().numpy()
        cloud = packed[:, :3].astype(np.float32)
        if self._warm and not self._model._recall_guard_ran:
            # the session's first real frame probes the capture distribution
            self._model._maybe_run_recall_guard(cloud)
        return cloud, packed[:, 3] > 0
