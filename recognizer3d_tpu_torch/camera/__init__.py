"""Sensor layer (counterpart of ``recognizer3d_tpu/camera``): an attached
Intel RealSense L515 when the SDK finds one, else a mock camera replaying
recorded frames. The SDK import is optional; without ``pyrealsense2`` the
mock is used directly."""

import os
from pathlib import Path
from typing import Optional

from recognizer3d_tpu_torch.camera.base_camera import Camera
from recognizer3d_tpu_torch.camera.mock_camera import DepthReplayCamera, MockRealsenseCamera
from recognizer3d_tpu_torch.data.dataset import Dataset

#: Searched in order for the mock camera's replay frames when no
#: ``mock_data_path`` is given: the ``RECOGNIZER3D_MOCK_DATA`` override,
#: then the generated fixture ``data/mock`` (``bin/make_mock_data``),
#: relative to the working directory.
MOCK_DATA_SEARCH_PATH = (
    os.environ.get("RECOGNIZER3D_MOCK_DATA"),
    Path("data") / "mock",
)


def auto_connect_camera(mock_data_path: Optional[Path] = None) -> Camera:
    """A ``RealsenseCamera`` when an L515 is attached, else a mock camera
    over ``mock_data_path`` (default: the first non-empty entry of
    ``MOCK_DATA_SEARCH_PATH``). With ``RECOGNIZER3D_MOCK_DEPTH=1`` the mock
    replays its clouds as raw depth frames (``DepthReplayCamera``), so the
    app drives the live depth path as it would with a sensor."""
    try:
        from pyrealsense2 import pyrealsense2 as rs

        from recognizer3d_tpu_torch.camera.realsense_camera import RealsenseCamera

        context = rs.context()
        for device in context.query_devices():
            if device.get_info(rs.camera_info.name) == "Intel RealSense L515":
                serial = device.get_info(rs.camera_info.serial_number)
                return RealsenseCamera(serial, serial)
    except ImportError:
        pass

    candidates = (
        [mock_data_path]
        if mock_data_path is not None
        else [Path(p) for p in MOCK_DATA_SEARCH_PATH if p]
    )
    mock_cls = (
        DepthReplayCamera
        if os.environ.get("RECOGNIZER3D_MOCK_DEPTH", "") not in ("", "0")
        else MockRealsenseCamera
    )
    for path in candidates:
        dataset = Dataset(path, only_annotated=False)
        if path.is_dir() and len(dataset) > 0:
            return mock_cls("mock", dataset)
    raise Exception(
        f"No mock frames found in any of {[str(c) for c in candidates]}; "
        "generate some with bin/make_mock_data or set RECOGNIZER3D_MOCK_DATA."
    )


__all__ = ["Camera", "DepthReplayCamera", "MockRealsenseCamera", "auto_connect_camera"]
