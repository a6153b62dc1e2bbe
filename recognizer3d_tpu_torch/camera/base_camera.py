"""Abstract camera interface (counterpart of
``recognizer3d_tpu/camera/base_camera.py``).

A named camera with a start/stop lifecycle, a ``get(timeout_ms)`` poll
returning the next (N, 3) float32 point cloud, a ``device_connected``
probe, and the most recent cloud cached on ``last_cloud``. Cameras that
deliver raw depth also keep the z16 frame behind that cloud on
``last_depth`` and expose their pinhole intrinsics.
"""

from typing import Optional

import numpy as np


class Camera:
    #: most recent cloud delivered by ``get`` (subclasses assign this)
    _last_cloud: np.ndarray
    #: most recent filtered raw depth frame (H, W) uint16; only cameras
    #: that expose raw depth assign this (see ``depth_intrinsics``)
    _last_depth: Optional[np.ndarray]
    #: True between ``start()`` and ``stop()``
    _running: bool

    def __init__(self, name: str):
        self.name = name
        self._running = False
        self._last_cloud = np.empty((0,), dtype=np.float64)
        self._last_depth = None

    def start(self) -> None:
        """Begin streaming; ``get`` may be called after this."""
        self._running = True

    def stop(self) -> None:
        """End streaming and release the device."""
        self._running = False

    def get(self, timeout_ms: int = 200) -> np.ndarray:
        """Block up to ``timeout_ms`` for the next (N, 3) float32 cloud."""
        raise NotImplementedError

    @property
    def device_connected(self) -> bool:
        """Whether physical hardware backs this camera (mocks: True)."""
        return True

    @property
    def last_cloud(self) -> np.ndarray:
        return self._last_cloud

    @property
    def last_depth(self) -> Optional[np.ndarray]:
        """The raw z16 depth frame behind ``last_cloud``, or None for
        cloud-only cameras. When present, the app's prediction tick uploads
        this frame and runs the live depth path (``models/live.py``) in
        place of the full-cloud ``Predictor``."""
        return self._last_depth

    @property
    def depth_intrinsics(self):
        """Pinhole intrinsics of the depth stream (a
        ``data.pipeline.DepthIntrinsics``), or None when this camera cannot
        provide raw depth frames."""
        return None
