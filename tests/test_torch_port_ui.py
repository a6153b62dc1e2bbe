"""The port's UI layer (``recognizer3d_tpu_torch/ui``) against the in-memory
vispy and tkinter stubs (``tests/_vispy_stub.py``, ``tests/_tk_stub.py``),
as ``tests/test_ui_headless.py`` drives the JAX package's: panels, overlays,
picking, the three linked panels, the text overlay and the control bar. The
picking math is held against the JAX package's on seeded clicks, and the
port's use of vispy, tkinter and pyrealsense2 must stay within the API
contract the stubs cover (``tests/external_api_contract.json``).
"""

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from recognizer3d_tpu.ui import annotation as jax_annotation
from recognizer3d_tpu_torch.ui import annotation as port_annotation
from tests import _external_api, _tk_stub, _vispy_stub

PORT = Path(__file__).resolve().parents[1] / "recognizer3d_tpu_torch"
UI_MODULES = ["recognizer3d_tpu_torch.ui.scene", "recognizer3d_tpu_torch.ui.controls"]


@pytest.fixture()
def ui(monkeypatch):
    """Both stubs installed and the port's UI modules imported against them."""
    for m in UI_MODULES:
        monkeypatch.delitem(sys.modules, m, raising=False)
    vispy = _vispy_stub.install(monkeypatch)
    tk = _tk_stub.install(monkeypatch)
    yield SimpleNamespace(
        vispy=vispy, tk=tk,
        scene=importlib.import_module("recognizer3d_tpu_torch.ui.scene"),
        controls=importlib.import_module("recognizer3d_tpu_torch.ui.controls"),
    )
    for m in UI_MODULES:
        sys.modules.pop(m, None)


# --- picking and the display subsample ----------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_pick_annotation_matches_jax(seed):
    """Seeded clicks on a seeded cloud, each applied to the mask the last
    one left: the same action and mask as the JAX package's, adds and
    removes both reached."""
    rng = np.random.RandomState(seed)
    cloud = rng.rand(300, 3).astype(np.float32)
    mask_port = mask_jax = None if seed % 2 else rng.rand(300) < 0.05
    actions = set()
    for _ in range(12):
        # every other click lands next to an annotated point, if any
        target = cloud[rng.randint(300)]
        if mask_port is not None and mask_port.any() and rng.rand() < 0.5:
            target = cloud[np.flatnonzero(mask_port)[0]]
        p0 = np.array([target[0] + rng.randn() * 1e-3, target[1] + rng.randn() * 1e-3, -1.0])
        p1 = p0 + np.array([0.0, 0.0, 1.0])
        action, mask_port = port_annotation.pick_annotation(p0, p1, cloud, mask_port)
        ref_action, mask_jax = jax_annotation.pick_annotation(p0, p1, cloud, mask_jax)
        assert action == ref_action
        np.testing.assert_array_equal(mask_port, mask_jax)
        actions.add(action)
    assert actions == {"add", "remove"}
    np.testing.assert_array_equal(
        port_annotation.ray_point_distances(p0, p1, cloud),
        jax_annotation.ray_point_distances(p0, p1, cloud),
    )


def test_display_subsample_is_seeded_and_capped():
    cloud = np.random.RandomState(0).rand(25_000, 3).astype(np.float32)
    a = port_annotation.display_subsample(cloud, np.random.default_rng(5))
    b = port_annotation.display_subsample(cloud, np.random.default_rng(5))
    c = port_annotation.display_subsample(cloud, np.random.default_rng(6))
    assert a.shape == (10_000, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # every shown point is a distinct point of the cloud
    rows = {tuple(r) for r in a}
    assert len(rows) == 10_000 and rows <= {tuple(r) for r in cloud}
    small = cloud[:10_000]
    assert port_annotation.display_subsample(small, np.random.default_rng(0)) is small
    assert port_annotation.display_subsample(None, np.random.default_rng(0)) is None
    assert port_annotation.display_subsample(cloud, np.random.default_rng(0), 7).shape == (7, 3)


# --- panels -------------------------------------------------------------------


def _panel(ui, **kw):
    return ui.scene.CloudPanel(_vispy_stub.ViewBox(), **kw)


def test_show_cloud_renders_red_base(ui):
    panel = _panel(ui, offset=(0, 0, 0))
    cloud = np.random.RandomState(0).rand(50, 3).astype(np.float32)
    panel.show_cloud(cloud)
    assert panel._base.visible
    assert panel._base.data["face_color"] == "red"
    np.testing.assert_array_equal(panel._base.data["pos"], cloud)
    assert panel.cloud is cloud


def test_panel_display_caps_at_10k_and_repeats(ui):
    cloud = np.random.RandomState(0).rand(12_000, 3).astype(np.float32)
    shown = []
    for _ in range(2):  # a fresh panel draws the same points for the same cloud
        panel = _panel(ui)
        panel.show_cloud(cloud)
        shown.append(panel._base.data["pos"])
    assert len(shown[0]) == 10_000
    np.testing.assert_array_equal(shown[0], shown[1])


def test_overlays_select_masked_points(ui):
    panel = _panel(ui, offset=(0, 0, 0))
    cloud = np.random.RandomState(0).rand(40, 3).astype(np.float32)
    panel.show_cloud(cloud)
    mask = np.zeros(40, bool)
    mask[[3, 7]] = True
    panel.set_overlay("prediction", mask)
    layer = panel._layers["prediction"]
    assert layer.visible and layer.data["face_color"] == "green"
    np.testing.assert_array_equal(layer.data["pos"], cloud[mask])
    panel.set_overlay("prediction", None)
    assert not layer.visible


def test_new_cloud_clears_annotation(ui):
    panel = _panel(ui, offset=(0, 0, 0))
    cloud = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    panel.show_cloud(cloud)
    panel.set_overlay("annotation", np.ones(20, bool))
    panel.show_cloud(cloud * 2)
    assert panel.get_overlay("annotation") is None


def test_camera_home_orientation(ui):
    cam = _panel(ui)._viewbox.camera
    assert cam.fov == 0 and cam.depth_value == 1.0
    assert (cam._quaternion.w, cam._quaternion.x) == (0.707, 0.707)


def _annotatable(ui, calls):
    vb = _vispy_stub.ViewBox()
    panel = ui.scene.CloudPanel(vb, on_annotation_change=calls.append, offset=(0, 0, 0))
    panel.show_cloud(np.array([[0.0, 0.0, 0.5], [0.2, 0.0, 0.5], [0.0, 0.2, 0.5]], np.float32))
    return vb, panel


def test_click_adds_then_removes(ui):
    """Middle-mouse press -> screen ray -> nearest-point toggle (the stub's
    transform is the identity: the ray runs along +z through (x, y))."""
    calls = []
    vb, panel = _annotatable(ui, calls)
    vb.events.mouse_press.fire(_vispy_stub.make_mouse_press(0.001, 0.0))
    np.testing.assert_array_equal(calls[0], [True, False, False])
    np.testing.assert_array_equal(panel.get_overlay("annotation"), [True, False, False])
    vb.events.mouse_press.fire(_vispy_stub.make_mouse_press(0.002, 0.0))
    np.testing.assert_array_equal(calls[1], [False, False, False])


def test_non_middle_button_ignored(ui):
    calls = []
    vb, _ = _annotatable(ui, calls)
    vb.events.mouse_press.fire(_vispy_stub.make_mouse_press(0.0, 0.0, button=1))
    assert calls == []


def test_click_without_cloud_is_noop(ui, capsys):
    calls = []
    vb = _vispy_stub.ViewBox()
    ui.scene.CloudPanel(vb, on_annotation_change=calls.append)
    vb.events.mouse_press.fire(_vispy_stub.make_mouse_press(0.0, 0.0))
    assert calls == []
    assert "No data captured yet." in capsys.readouterr().out


def test_three_linked_panels(ui):
    parent = ui.tk.Frame()
    trip = ui.scene.build_triptych(parent, lambda mask: None)
    assert trip.canvas.kwargs["size"] == (200, 600)
    assert trip.canvas.kwargs["parent"] is parent
    live_cam = trip.live._viewbox.camera
    assert trip.captured._viewbox.camera in live_cam.linked
    assert trip.prediction._viewbox.camera in live_cam.linked
    assert trip.captured._viewbox.events.mouse_press.callbacks  # only it is annotatable
    assert not trip.live._viewbox.events.mouse_press.callbacks


def test_text_overlay_roundtrip(ui):
    overlay = ui.scene.TextOverlay("hello", color="white")
    assert overlay.text == "hello"
    overlay.text = "bye"
    assert overlay.text == "bye"
    overlay.on_resize(None)
    assert overlay._visual.pos == (4.0, 4)


def test_lazy_exports(ui):
    import recognizer3d_tpu_torch.ui as port_ui

    assert port_ui.CloudPanel is ui.scene.CloudPanel
    assert port_ui.ControlBar is ui.controls.ControlBar
    with pytest.raises(AttributeError):
        port_ui.NoSuchWidget


# --- the control bar ----------------------------------------------------------


class _FakeJob:
    def __init__(self, percents):
        self._percents = list(percents)

    def poll(self):
        return self._percents.pop(0) if self._percents else 100


def _bar(ui, tmp_path, record, accept_predict=True):
    actions = ui.controls.AppActions(
        capture=lambda: record.append("capture"),
        count_samples=lambda: len(record),
        start_training=lambda: _FakeJob([42, 100]),
        toggle_predict=lambda enable: (record.append(("predict", enable)), accept_predict)[1],
        set_confidence=lambda v: record.append(("confidence", v)),
    )
    return ui.controls.ControlBar(ui.tk.Frame(), actions, tmp_path / "models")


def walk_buttons(widget):
    for child in widget.children:
        if type(child).__name__ == "Button":
            yield child
        yield from walk_buttons(child)


def test_capture_and_live_sample_count(ui, tmp_path):
    record = []
    bar = _bar(ui, tmp_path, record)
    bar._dataset_entry.set_text("my_set")
    assert bar.dataset_name == "my_set"
    before = bar._sample_count["text"]
    next(b for b in walk_buttons(bar) if b["text"] == "Capture").invoke()
    assert "capture" in record
    assert bar._sample_count["text"] == before + 1


def test_train_poll_cycle(ui, tmp_path):
    bar = _bar(ui, tmp_path, [])
    (tmp_path / "models" / "2026_01_01__01").mkdir(parents=True)
    (tmp_path / "models" / "2026_01_02__01").mkdir(parents=True)
    train = next(b for b in walk_buttons(bar) if b["text"] == "Train")
    train.invoke()
    assert train["state"] == "disabled" and bar._progress["value"] == 1
    _tk_stub.run_scheduled()  # the first 500 ms poll: 42%
    assert bar._progress["value"] == 42 and bar.training_job is not None
    _tk_stub.run_scheduled()  # 100%: done
    assert bar._progress["value"] == 100
    assert train["state"] == "normal" and bar.training_job is None
    assert bar.model_name == "2026_01_02__01"  # the newest by name


def test_predict_toggle_relief(ui, tmp_path):
    record = []
    bar = _bar(ui, tmp_path, record)
    bar._predict_button.invoke()
    assert ("predict", True) in record
    assert bar._predict_button.config("relief")[-1] == "sunken"
    bar._predict_button.invoke()
    assert ("predict", False) in record
    assert bar._predict_button.config("relief")[-1] == "raised"


def test_predict_toggle_rejected(ui, tmp_path):
    bar = _bar(ui, tmp_path, [], accept_predict=False)
    bar._predict_button.invoke()
    assert bar._predict_button.config("relief")[-1] == "raised"


def test_confidence_slider(ui, tmp_path):
    record = []
    bar = _bar(ui, tmp_path, record)
    assert bar.confidence == 0.5
    bar._confidence.set(0.73)
    assert ("confidence", 0.73) in record


# --- the external API surface -------------------------------------------------


def test_port_external_api_is_within_the_stubbed_contract():
    """Every vispy, tkinter and pyrealsense2 name the port touches is one
    the JAX package's contract already has, so the stubs model it."""
    files = sorted(p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts)
    surface = _external_api.extract_contract(files=files)
    contract = _external_api.load_contract()
    assert set(surface) == {"vispy", "tkinter", "pyrealsense2"}
    for root, chains in surface.items():
        assert set(chains) <= set(contract[root]), sorted(set(chains) - set(contract[root]))
