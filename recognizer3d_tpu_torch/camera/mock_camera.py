"""Cameras without hardware: replay a stored ``Dataset`` as camera frames
(counterpart of ``recognizer3d_tpu/camera/mock_camera.py``).

The whole app runs with no sensor by cycling round-robin through recorded
clouds; ``DepthReplayCamera`` also hands out each cloud as a raw z16 depth
frame, so the app drives the live depth path as it would with a sensor.
"""

import numpy as np

from recognizer3d_tpu_torch.camera.base_camera import Camera
from recognizer3d_tpu_torch.data.dataset import Dataset
from recognizer3d_tpu_torch.data.pipeline import DepthIntrinsics, cloud_to_depth


class MockRealsenseCamera(Camera):
    def __init__(self, name: str, mock_dataset: Dataset):
        super().__init__(name)
        if len(mock_dataset) == 0:
            raise Exception("Please provide at least 1 mock frame.")
        self._frames = mock_dataset
        self._cursor = 0

    def start(self) -> None:
        self._cursor = 0
        super().start()

    def get(self, timeout_ms: int = 200) -> np.ndarray:
        if timeout_ms < 0:
            raise ValueError(f"timeout_ms must be >= 0, got {timeout_ms}")
        cloud = self._frames[self._cursor][0]
        self._cursor = (self._cursor + 1) % len(self._frames)
        self._last_cloud = cloud
        return cloud


class DepthReplayCamera(MockRealsenseCamera):
    """Mock camera that also replays raw z16 depth frames: each stored
    (dewarped) cloud is projected back through pinhole intrinsics into a
    depth image (``data.pipeline.cloud_to_depth``, the inverse of the
    dewarp), so the app's live depth path, driven when ``depth_intrinsics``
    is not None, runs with no sensor. The app uses it when
    ``RECOGNIZER3D_MOCK_DEPTH=1`` (``camera/__init__.py``)."""

    def __init__(self, name: str, mock_dataset: Dataset, intrinsics=None):
        super().__init__(name, mock_dataset)
        self._intrinsics = DepthIntrinsics() if intrinsics is None else intrinsics

    @property
    def depth_intrinsics(self):
        return self._intrinsics

    def get(self, timeout_ms: int = 200) -> np.ndarray:
        cloud = super().get(timeout_ms)
        self._last_depth = cloud_to_depth(cloud, self._intrinsics)
        return cloud

    def get_depth(self, timeout_ms: int = 200) -> np.ndarray:
        self.get(timeout_ms)
        return self._last_depth
