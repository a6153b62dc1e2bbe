"""Intel RealSense L515 camera backend (counterpart of
``recognizer3d_tpu/camera/realsense_camera.py``).

Depth stream 1024×768 z16 at 30 fps with the SDK's temporal filter
(smoothing 0.33, delta 100, persistence 0) and the depth-sensor options
below; ``get()`` converts the newest depth frame to a point cloud through
the SDK, keeps the 0.05 m < z < 0.6 m band, and raises "No valid frame
received." when the mean depth looks implausible (2 m or more: the sensor
staring past the desk). The ``pyrealsense2`` import happens at
construction, so this module imports on hosts without the SDK.
"""

import numpy as np

from recognizer3d_tpu_torch.camera.base_camera import Camera
from recognizer3d_tpu_torch.data.pipeline import DepthIntrinsics

DEPTH_STREAM = dict(width=1024, height=768, fps=30)
Z_BAND = (0.05, 0.6)  # metres
_MAX_PLAUSIBLE_MEAN_Z = 2.0
_TEMPORAL_FILTER = (0.33, 100.0, 0.0)  # smoothing, delta, persistence
# option name -> value, applied to the depth sensor before streaming
_DEPTH_SENSOR_OPTIONS = {
    "min_distance": 0,
    "digital_gain": 1.0,
    "laser_power": 100,
    "receiver_gain": 9,
    "noise_filtering": 6,
}


class RealsenseCamera(Camera):
    def __init__(self, name: str, device_serial: str):
        super().__init__(name)
        from pyrealsense2 import pyrealsense2 as rs

        self._rs = rs
        self._serial = device_serial
        self._dewarp = rs.pointcloud()
        self._temporal = rs.temporal_filter(*_TEMPORAL_FILTER)

        config = rs.config()
        config.enable_device(device_serial)
        config.enable_stream(
            rs.stream.depth,
            DEPTH_STREAM["width"],
            DEPTH_STREAM["height"],
            rs.format.z16,
            DEPTH_STREAM["fps"],
        )
        self._config = config
        self._pipeline = rs.pipeline(rs.context())
        self._profile = config.resolve(rs.pipeline_wrapper(self._pipeline))
        self._depth_intrinsics = None
        product_line = self._profile.get_device().get_info(rs.camera_info.product_line)
        if str(product_line) != "L500":
            raise Exception("Expected an L515 camera")

    @property
    def serial(self) -> str:
        return self._serial

    def start(self) -> None:
        """Configure the depth sensor and start streaming (laser on)."""
        if self._running:
            return
        sensor = self._profile.get_device().first_depth_sensor()
        for option, value in _DEPTH_SENSOR_OPTIONS.items():
            sensor.set_option(getattr(self._rs.option, option), value)
        self._pipeline.start(self._config)
        super().start()

    def stop(self) -> None:
        """Stop streaming (laser off)."""
        if not self._running:
            return
        self._pipeline.stop()
        super().stop()

    @property
    def depth_intrinsics(self) -> DepthIntrinsics:
        """Calibrated pinhole intrinsics and depth scale of the live
        stream, read from the SDK (not the L515's catalogue defaults). The
        app drives the live depth path when a camera has them."""
        if self._depth_intrinsics is None:
            rs = self._rs
            stream = self._profile.get_stream(rs.stream.depth).as_video_stream_profile()
            intr = stream.get_intrinsics()
            scale = self._profile.get_device().first_depth_sensor().get_depth_scale()
            self._depth_intrinsics = DepthIntrinsics(
                width=int(intr.width),
                height=int(intr.height),
                fx=float(intr.fx),
                fy=float(intr.fy),
                cx=float(intr.ppx),
                cy=float(intr.ppy),
                depth_scale=float(scale),
            )
        return self._depth_intrinsics

    def get(self, timeout_ms: int = 200) -> np.ndarray:
        """Newest point cloud, z-band filtered; raises on missing or
        implausible frames. Keeps the temporally filtered raw depth frame
        of the same capture on ``last_depth``."""
        if not self._running:
            raise Exception("Realsense pipeline is not running.")
        depth = self._next_depth_frame(timeout_ms)
        cloud = self._frame_to_cloud(depth)
        if not _plausible(cloud):
            raise Exception("No valid frame received.")
        self._last_cloud = cloud
        self._last_depth = np.asanyarray(depth.get_data()).copy()
        return cloud

    def get_depth(self, timeout_ms: int = 200) -> np.ndarray:
        """Newest raw z16 depth frame (H, W) uint16, temporally filtered:
        the live depth path's upload. The plausibility check runs on the
        depth values (the mean nonzero z; the dewarp keeps z)."""
        if not self._running:
            raise Exception("Realsense pipeline is not running.")
        frame = self._next_depth_frame(timeout_ms)
        depth = np.asanyarray(frame.get_data()).copy()
        nonzero = depth[depth > 0]
        if nonzero.size == 0:
            raise Exception("No valid frame received.")
        mean_z = float(nonzero.mean()) * self.depth_intrinsics.depth_scale
        if mean_z >= _MAX_PLAUSIBLE_MEAN_Z:
            raise Exception("No valid frame received.")
        self._last_depth = depth
        return depth

    def _next_depth_frame(self, timeout_ms: int):
        """Wait for the next frameset; return its temporally filtered depth
        frame (SDK objects)."""
        ok, frames = self._pipeline.try_wait_for_frames(timeout_ms=timeout_ms)
        if not ok:
            raise Exception("No frame received.")
        return self._temporal.process(frames.get_depth_frame())

    def _frame_to_cloud(self, depth_frame) -> np.ndarray:
        """SDK dewarp to (N, 3) xyz, then keep the working z band."""
        vertices = self._dewarp.calculate(depth_frame).get_vertices()
        xyz = np.asanyarray(vertices).view(np.float32).reshape(-1, 3)
        z = xyz[:, 2]
        return xyz[(z > Z_BAND[0]) & (z < Z_BAND[1])]


def _plausible(cloud: np.ndarray) -> bool:
    """The mean z of the nonzero points must stay under 2 m."""
    nonzero = cloud[~np.all(cloud == 0.0, axis=1)]
    return len(nonzero) > 0 and float(np.mean(nonzero[:, 2])) < _MAX_PLAUSIBLE_MEAN_Z
