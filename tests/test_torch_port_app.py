"""The port's app (``recognizer3d_tpu_torch/app.py``) against the in-memory
tkinter and vispy stubs, as ``tests/test_ui_headless.py`` drives the JAX
package's ``main.App``: the 34 ms poll, capture, annotation, training,
the predict toggle on either camera branch, and Escape. One predicting
tick on a tiny archive gives the mask JAX's ``main.App`` gives on the same
cloud and numpy seed. And the port's ``Predictor`` keeps its warm-up cloud
out of the session recall guard of ``knn="approximate"``: the guard probes
the first cloud it predicts.
"""

import importlib
import importlib.machinery
import importlib.util
import sys
from datetime import datetime
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import recognizer3d_tpu.camera as jax_camera
import recognizer3d_tpu_torch.camera as port_camera
from recognizer3d_tpu.data.dataset import Dataset as JaxDataset
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu_torch import Model, Predictor, RandLANetSettings
from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
from recognizer3d_tpu_torch.ops import knn as port_knn
from recognizer3d_tpu_torch.ui.annotation import display_subsample as port_display_subsample
from tests import _tk_stub, _vispy_stub

ROOT = Path(__file__).resolve().parents[1]
UI_MODULES = [
    "recognizer3d_tpu_torch.app", "recognizer3d_tpu_torch.ui.scene",
    "recognizer3d_tpu_torch.ui.controls", "main", "recognizer3d_tpu.ui.scene",
    "recognizer3d_tpu.ui.controls",
]
MODEL_NAME = "2026_02_02__10_00_00_000000000"
TINY = dict(n_classes=2, n_points=64, n_features=0, n_neighbors=4, decimation=2,
            layer_sizes=[4, 8], knn="naive")


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture()
def ui(monkeypatch):
    """Both stubs installed; the apps imported against them on demand."""
    for m in UI_MODULES:
        monkeypatch.delitem(sys.modules, m, raising=False)
    vispy = _vispy_stub.install(monkeypatch)
    tk = _tk_stub.install(monkeypatch)
    yield SimpleNamespace(vispy=vispy, tk=tk,
                          app=importlib.import_module("recognizer3d_tpu_torch.app"))
    for m in UI_MODULES:
        sys.modules.pop(m, None)


@pytest.fixture()
def mock_camera_data(tmp_path, monkeypatch):
    """A small replayable mock dataset, both packages' camera search paths
    pointed at it, and the working directory set to a fresh one."""
    ds_dir = tmp_path / "mockframes"
    ds = JaxDataset(ds_dir)
    rng = np.random.RandomState(0)
    for i in range(3):
        ds[datetime(2026, 1, 1, 9, 0, i)] = rng.rand(200, 3).astype(np.float32) * 0.3
    for pkg in (port_camera, jax_camera):
        monkeypatch.setattr(pkg, "MOCK_DATA_SEARCH_PATH", (str(ds_dir),))
    monkeypatch.delenv("RECOGNIZER3D_MOCK_DEPTH", raising=False)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    return ds_dir


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data"))
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.make_frame


def _walk_buttons(widget):
    for child in widget.children:
        if type(child).__name__ == "Button":
            yield child
        yield from _walk_buttons(child)


@pytest.fixture()
def app(ui, mock_camera_data):
    window = ui.tk.Tk()
    return SimpleNamespace(window=window, app=ui.app.App(window, device="cpu"))


def test_app_refuses_a_missing_gpu(ui, mock_camera_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        ui.app.App(ui.tk.Tk())
    assert "tkinter" in ui.vispy.used  # the app pins the tk backend


def test_tick_shows_live_cloud(app):
    assert app.window.title() == "3D gesture capturing"
    _tk_stub.run_scheduled()  # the scheduled 34 ms tick
    live = app.app.scene.live
    assert live.cloud is not None and len(live.cloud) == 200
    assert [ms for ms, _ in _tk_stub.SCHEDULED] == [34]  # the tick re-armed itself


def _capture(app, name="uitest"):
    _tk_stub.run_scheduled()
    app.app.controls._dataset_entry.set_text(name)
    next(b for b in _walk_buttons(app.app.controls) if b["text"] == "Capture").invoke()


def test_capture_writes_the_dataset_format(app):
    _capture(app)
    files = list((Path("data") / "uitest").glob("*_data.npy"))
    assert len(files) == 1
    np.testing.assert_array_equal(np.load(files[0]), app.app.camera.last_cloud)
    np.testing.assert_array_equal(app.app.scene.captured.cloud, app.app.camera.last_cloud)
    assert JaxDataset(Path("data") / "uitest", only_annotated=False)[0][0].shape == (200, 3)
    # the counter counts annotated samples, as the JAX app's does
    assert app.app.controls._sample_count["text"] == 0


def test_annotation_click_persists(app):
    _capture(app)
    target = app.app.scene.captured.cloud[5]
    app.app.scene.captured._viewbox.events.mouse_press.fire(
        _vispy_stub.make_mouse_press(target[0], target[1])
    )
    anns = list((Path("data") / "uitest").glob("*_annotation.npy"))
    assert len(anns) == 1 and np.load(anns[0]).sum() >= 1


def test_train_button_launches_the_job_on_the_apps_device(app, monkeypatch):
    launched = []

    class Job:
        def poll(self):
            return 100

        def kill(self):
            launched.append("killed")

    monkeypatch.setattr(sys.modules["recognizer3d_tpu_torch.app"].TrainingJob, "launch",
                        lambda dirs, device: launched.append((dirs, device)) or Job())
    app.app.controls._dataset_entry.set_text("uitest")
    next(b for b in _walk_buttons(app.app.controls) if b["text"] == "Train").invoke()
    assert launched == [([Path("data") / "uitest"], "cpu")]
    with pytest.raises(SystemExit):  # Escape kills a running job
        app.window.fire_event("<Escape>", None)
    assert launched[-1] == "killed"


def test_predict_toggle_without_model_rejected(app, capsys):
    assert app.app._toggle_predict(True) is False
    assert "First train a model" in capsys.readouterr().out


def test_escape_quits(app):
    with pytest.raises(SystemExit):
        app.window.fire_event("<Escape>", None)
    assert app.window.withdrawn
    assert not app.app.camera._running


def _predicting_tick(module, window, seed, **kw):
    """A fresh app of ``module``: one tick, Predict on, one predicting tick
    after ``np.random.seed(seed)``. Returns the app."""
    _tk_stub.SCHEDULED.clear()
    app = module.App(window, **kw)
    app.controls.refresh_model_name()
    assert app.controls.model_name == MODEL_NAME
    _tk_stub.run_scheduled()  # the first tick: the live cloud, last_cloud set
    assert app._toggle_predict(True) is True
    app._next_prediction_due = 0.0  # due at once
    np.random.seed(seed)
    _tk_stub.run_scheduled()
    return app


def test_predict_tick_matches_the_jax_app(ui, mock_camera_data, monkeypatch):
    """The cloud branch on the bundled weights and mock frames of 3,000
    points: the prediction panel's mask equals JAX's ``main.App``'s on the
    same frame and numpy seed, away from the threshold (1e-4 of JAX's
    class-1 confidence), with JAX's panels drawing their display subsample
    off numpy's global RNG as the port's do. The archive is re-saved with ``knn="pallas"``,
    whose JAX route on the CPU computes neighbour distances as the port
    does (``tests/test_torch_port_model.py``)."""
    frames_dir = mock_camera_data.parent / "fingertip"
    ds = JaxDataset(frames_dir, only_annotated=False)
    make_frame = _make_frame()
    for i in range(2):
        ds[datetime(2026, 1, 1, 9, 0, i)] = make_frame(np.random.RandomState(40 + i), i, 3000)[0]
    for pkg in (port_camera, jax_camera):
        monkeypatch.setattr(pkg, "MOCK_DATA_SEARCH_PATH", (str(frames_dir),))
    model_dir = Path("models") / MODEL_NAME
    JaxModel.load(ROOT / "pretrained" / "mock_fingertip", knn="pallas").save(model_dir)
    main = importlib.import_module("main")
    # the JAX panels draw their display subsample from numpy's global RNG,
    # ahead of the predict's permutation; the port's panels have their own
    # generator. Give JAX's panels one too, so both predicts draw alike
    monkeypatch.setattr(
        sys.modules["recognizer3d_tpu.ui.scene"], "display_subsample",
        lambda pos, max_points=10000: port_display_subsample(pos, np.random.default_rng(0),
                                                             max_points),
    )
    port_app = _predicting_tick(ui.app, ui.tk.Tk(), 5, device="cpu")
    jax_app = _predicting_tick(main, ui.tk.Tk(), 5)
    cloud = port_app.scene.prediction.cloud
    mask = port_app.scene.prediction.get_overlay("prediction")
    frame1 = JaxDataset(frames_dir, only_annotated=False)[1][0]
    np.testing.assert_array_equal(cloud, frame1)  # the second tick's frame
    np.testing.assert_array_equal(cloud, jax_app.scene.prediction.cloud)
    assert mask.dtype == bool and mask.shape == (3000,)
    assert port_app._predictor is not None and port_app._live_predictor is None
    np.random.seed(5)
    ref = jax_app._predictor._model.predict(cloud)  # the same upload dtype
    near = np.abs(ref[1] - 0.5) <= 1e-4
    jax_mask = jax_app.scene.prediction.get_overlay("prediction")
    np.testing.assert_array_equal(jax_mask[~near], (ref[1] > 0.5)[~near])  # the same draws
    np.testing.assert_array_equal(mask[~near], (ref[1] > 0.5)[~near])
    assert 0 < mask.sum() < 3000
    port_app._set_confidence(0.9)
    assert port_app._predictor.confidence_threshold == 0.9
    assert port_app._toggle_predict(False) is True and port_app._predictor is None


def test_predict_tick_depth_branch(ui, mock_camera_data, monkeypatch):
    """With ``RECOGNIZER3D_MOCK_DEPTH=1`` the camera hands out raw depth,
    and the predicting tick runs ``LivePredictor`` on it."""
    monkeypatch.setenv("RECOGNIZER3D_MOCK_DEPTH", "1")
    model_dir = Path("models") / MODEL_NAME
    Model(RandLANetSettings(**TINY), device="cpu").save(model_dir)
    app = _predicting_tick(ui.app, ui.tk.Tk(), 5, device="cpu")
    assert isinstance(app.camera, port_camera.DepthReplayCamera)
    assert app._live_predictor is not None and app._predictor is None
    shown = app.scene.prediction.cloud
    mask = app.scene.prediction.get_overlay("prediction")
    assert shown.shape == (16_384, 3) and mask.shape == (16_384,) and mask.dtype == bool
    assert not mask[~(shown != 0).any(-1)].any()  # padding rows are never foreground


# --- C4: the recall guard probes the first predicted cloud ----------------------


def test_predictor_warm_up_does_not_feed_the_recall_guard(tmp_path, monkeypatch):
    """A default ``Predictor`` at approximate settings in the window regime
    (12,800 points): its warm-up runs no probe, its first predicted cloud
    is the one the guard probes and ``recall_guard_result`` reports, and
    the guard then counts as run."""
    settings = RandLANetSettings(n_classes=2, n_points=12_800, n_neighbors=8, decimation=4,
                                 layer_sizes=[4, 8])
    assert settings.knn == "approximate" and port_knn.window_regime_active(12_800)
    Model(settings, device="cpu").save(tmp_path / "approx")
    probed = []
    guard = port_knn.ensure_window_recall

    def spy(cloud, k, **kw):
        probed.append(np.array(cloud))
        return guard(cloud, k, **kw)

    monkeypatch.setattr(port_knn, "ensure_window_recall", spy)
    port_knn.reset_window_guard()
    try:
        predictor = Predictor(tmp_path / "approx", warmup_points=12_800, device="cpu")
        assert probed == [] and predictor.model.recall_guard_result is None
        assert not predictor.model._recall_guard_ran
        make_frame = _make_frame()
        frame = make_frame(np.random.RandomState(1), 0.3, 12_800)[0]
        mask = predictor.predict(frame)
        assert mask.shape == (12_800,)
        assert len(probed) == 1
        idx = consistent_sample_indices(12_800, 12_800)
        np.testing.assert_array_equal(probed[0], frame[idx, :3])
        result = predictor.model.recall_guard_result
        assert result["active"] and result["recall"] >= 0.9
        assert result["window_points"] == port_knn.session_window_points()
        assert predictor.model._recall_guard_ran  # no further frame probes
    finally:
        port_knn.reset_window_guard()
