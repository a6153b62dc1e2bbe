"""The port's camera layer (``recognizer3d_tpu_torch/camera``) against the
JAX package's, on the same recorded frames and the same in-memory
``pyrealsense2`` stub (``tests/_pyrealsense2_stub.py``): the mock camera's
replayed clouds, ``DepthReplayCamera``'s depth frames, the RealSense
backend's journal of SDK calls, clouds and errors, and
``auto_connect_camera``'s choice.
"""

from datetime import datetime

import numpy as np
import pytest

import recognizer3d_tpu.camera as jax_camera
import recognizer3d_tpu_torch.camera as port_camera
from recognizer3d_tpu.camera.realsense_camera import RealsenseCamera as JaxRealsense
from recognizer3d_tpu.data.dataset import Dataset as JaxDataset
from recognizer3d_tpu_torch.camera.realsense_camera import RealsenseCamera as PortRealsense
from recognizer3d_tpu_torch.data.dataset import Dataset as PortDataset
from tests import _pyrealsense2_stub


@pytest.fixture()
def frames_dir(tmp_path):
    """Three recorded clouds in the on-disk dataset format."""
    root = tmp_path / "frames"
    ds = JaxDataset(root)
    rng = np.random.RandomState(0)
    for i in range(3):
        ds[datetime(2026, 1, 1, 9, 0, i)] = (rng.rand(500, 3) * [0.4, 0.3, 0.4]
                                             + [-0.2, -0.15, 0.15]).astype(np.float32)
    return root


def test_mock_camera_replays_the_frames_jax_replays(frames_dir):
    port = port_camera.MockRealsenseCamera("mock", PortDataset(frames_dir, only_annotated=False))
    ref = jax_camera.MockRealsenseCamera("mock", JaxDataset(frames_dir, only_annotated=False))
    for cam in (port, ref):
        cam.start()
    for _ in range(4):  # round-robin past the end
        np.testing.assert_array_equal(port.get(), ref.get())
        np.testing.assert_array_equal(port.last_cloud, ref.last_cloud)
    port.start()
    ref.start()  # start rewinds
    np.testing.assert_array_equal(port.get(), ref.get())
    assert port.last_depth is None and port.depth_intrinsics is None
    with pytest.raises(Exception, match="at least 1 mock frame"):
        port_camera.MockRealsenseCamera("mock", PortDataset(frames_dir / "none",
                                                            only_annotated=False))


def test_depth_replay_camera_depth_equals_jax(frames_dir):
    port = port_camera.DepthReplayCamera("mock", PortDataset(frames_dir, only_annotated=False))
    ref = jax_camera.DepthReplayCamera("mock", JaxDataset(frames_dir, only_annotated=False))
    assert vars(port.depth_intrinsics) == vars(ref.depth_intrinsics)
    for cam in (port, ref):
        cam.start()
    for _ in range(2):
        np.testing.assert_array_equal(port.get(), ref.get())
        assert port.last_depth.dtype == np.uint16
        assert port.last_depth.shape == (768, 1024)
        np.testing.assert_array_equal(port.last_depth, ref.last_depth)
        np.testing.assert_array_equal(port.get_depth(), ref.get_depth())


def _outcome(fn):
    """What a call returned, or the type and text of what it raised."""
    try:
        return "ok", fn()
    except Exception as error:  # noqa: BLE001 — the outcome is what is compared
        return "raised", (type(error).__name__, str(error))


# each script: the stub's settings and what is done to the camera
_SCRIPTS = {
    "get": (dict(frames=[0.4]), ["start", "get", "start", "stop", "stop"]),
    "get_depth": (dict(frames=[0.4]), ["start", "get_depth", "intrinsics"]),
    "get_twice_noisy": (dict(frames=[0.35, 0.5], noise=0.01), ["start", "get", "get", "get"]),
    "implausible_get": (dict(frames=[3.0]), ["start", "get"]),
    "implausible_get_depth": (dict(frames=[3.0]), ["start", "get_depth"]),
    "not_running": (dict(frames=[0.4]), ["get", "get_depth"]),
    "no_frame": (dict(frames=[]), ["start", "get"]),
    "wrong_product_line": (dict(frames=[0.4], product_line="D400"), []),
}


def _run_script(monkeypatch, cls, settings, steps):
    depths = [_pyrealsense2_stub.make_depth(z, settings.get("noise", 0.0), seed=i)
              for i, z in enumerate(settings["frames"])]
    kw = {"product_line": settings["product_line"]} if "product_line" in settings else {}
    journal, _ = _pyrealsense2_stub.install(monkeypatch, frames=depths, **kw)
    outcomes = []
    made = _outcome(lambda: cls("cam", "SER123"))
    outcomes.append(made if made[0] == "raised" else ("ok", None))
    cam = made[1]
    for step in steps:
        if step == "intrinsics":
            outcomes.append(_outcome(lambda: vars(cam.depth_intrinsics)))
        else:
            outcomes.append(_outcome(getattr(cam, step)))
    return journal, outcomes


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_realsense_camera_calls_the_sdk_as_jax_does(monkeypatch, script):
    """The same SDK calls in the same order with the same arguments, the
    same clouds and depth frames, and the same errors where JAX's raises."""
    settings, steps = _SCRIPTS[script]
    port_journal, port_out = _run_script(monkeypatch, PortRealsense, settings, steps)
    ref_journal, ref_out = _run_script(monkeypatch, JaxRealsense, settings, steps)
    assert port_journal == ref_journal
    assert len(port_out) == len(ref_out) == len(steps) + 1
    for (kind, value), (ref_kind, ref_value) in zip(port_out, ref_out):
        assert kind == ref_kind, (value, ref_value)
        if isinstance(value, np.ndarray):
            assert value.dtype == ref_value.dtype
            np.testing.assert_array_equal(value, ref_value)
        else:
            assert value == ref_value
    if script == "get":
        assert port_out[2][1].shape[0] > 0 and port_journal[-1] == ("pipeline.stop", None)


def test_auto_connect_picks_the_l515(monkeypatch):
    _pyrealsense2_stub.install(monkeypatch, frames=[_pyrealsense2_stub.make_depth(0.4)])
    cam = port_camera.auto_connect_camera()
    assert isinstance(cam, PortRealsense)
    assert cam.serial == "F0000000"
    # another RealSense model is not taken: the mock over the given frames is
    _pyrealsense2_stub.install(monkeypatch, device_name="Intel RealSense D435")
    with pytest.raises(Exception, match="No mock frames"):
        port_camera.auto_connect_camera(mock_data_path=port_camera.Path("no_such_dir"))


def test_auto_connect_falls_back_to_the_mock(monkeypatch, frames_dir):
    monkeypatch.setattr(port_camera, "MOCK_DATA_SEARCH_PATH", (None, str(frames_dir)))
    monkeypatch.delenv("RECOGNIZER3D_MOCK_DEPTH", raising=False)
    cam = port_camera.auto_connect_camera()
    assert type(cam) is port_camera.MockRealsenseCamera
    monkeypatch.setenv("RECOGNIZER3D_MOCK_DEPTH", "1")
    cam = port_camera.auto_connect_camera()
    assert type(cam) is port_camera.DepthReplayCamera
    assert cam.depth_intrinsics is not None
