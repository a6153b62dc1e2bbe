"""The port's command-line surface against the JAX package's: the
prediction CLI's ``--no-viz`` lines, ``visualize`` under the vispy stub,
the TensorBoard server of the training worker, and the profiling helpers
on the CPU.
"""

import importlib
import importlib.machinery
import importlib.util
import subprocess
import sys
from datetime import datetime
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from recognizer3d_tpu.data.dataset import Dataset as JaxDataset
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu_torch import predict as port_predict
from recognizer3d_tpu_torch import train as port_train
from recognizer3d_tpu_torch.utils import profiling
from tests import _tk_stub, _vispy_stub

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data"))
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.make_frame


@pytest.fixture()
def cli_data(tmp_path):
    """Two annotated mock clouds and the bundled weights re-saved with
    ``knn="pallas"`` (whose JAX route on the CPU computes neighbour
    distances as the port does)."""
    ds_dir = tmp_path / "ds"
    ds = JaxDataset(ds_dir)
    make_frame = _make_frame()
    for i in range(2):
        cloud, annotation = make_frame(np.random.RandomState(60 + i), 0.9 * i, 3000)
        ds[datetime(2026, 3, 1, 8, 0, i)] = cloud
        ds.set_annotation(datetime(2026, 3, 1, 8, 0, i), annotation)
    model = tmp_path / "model"
    JaxModel.load(ROOT / "pretrained" / "mock_fingertip", knn="pallas").save(model)
    return SimpleNamespace(ds=ds_dir, model=model)


def test_no_viz_lines_equal_the_jax_cli(cli_data, monkeypatch, capsys):
    """The same lines as ``predict.py --no-viz`` for the same archive,
    datasets and numpy seed (the warm-up cloud and each sample's
    permutation are drawn alike)."""
    argv = ["-m", str(cli_data.model), "-d", str(cli_data.ds), "--no-viz"]
    np.random.seed(21)
    port_predict.main(argv + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.splitlines()
    monkeypatch.delitem(sys.modules, "predict", raising=False)
    jax_cli = importlib.import_module("predict")
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    np.random.seed(21)
    jax_cli._cli()
    jax_lines = capsys.readouterr().out.splitlines()
    sys.modules.pop("predict", None)
    assert len(port_lines) == 2 and port_lines == jax_lines
    assert all(line.startswith("cloud: 3000 pts, predicted positives: ") for line in port_lines)


def test_cli_runs_without_jax(cli_data):
    """``python -m recognizer3d_tpu_torch.predict --no-viz`` in a process
    of its own: it prints a line a sample, and no module of JAX, flax or
    the JAX package is loaded when it ends."""
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['predict', '-m', {str(cli_data.model)!r}, '-d', {str(cli_data.ds)!r}, "
        "'--no-viz', '--device', 'cpu', '--transfer-dtype', 'float32']\n"
        "runpy.run_module('recognizer3d_tpu_torch.predict', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'recognizer3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert [line.split(",")[0] for line in res.stdout.splitlines()] == ["cloud: 3000 pts"] * 2


def test_cli_refuses_a_missing_gpu(cli_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_predict.main(["-m", str(cli_data.model), "-d", str(cli_data.ds), "--no-viz"])


def test_visualize_runs_and_escape_stops(monkeypatch):
    monkeypatch.delitem(sys.modules, "recognizer3d_tpu_torch.ui.scene", raising=False)
    vispy = _vispy_stub.install(monkeypatch)
    _tk_stub.install(monkeypatch)
    cloud = np.random.RandomState(0).rand(30, 3).astype(np.float32)
    ann = np.zeros(30, bool)
    ann[0] = True
    pred = np.zeros(30, bool)
    pred[1] = True

    def press(key):
        def run():
            _vispy_stub.SceneCanvas.instances[-1].events.key_press.fire(SimpleNamespace(key=key))
        return run

    try:
        monkeypatch.setattr(vispy.app, "run", press("Escape"))
        assert port_predict.visualize(cloud, ann, pred) is True
        assert vispy.used == ["tkinter"]
        canvas = _vispy_stub.SceneCanvas.instances[-1]
        assert canvas.kwargs["size"] == (1000, 600)
        (_, view), (_, overlay) = canvas.central_widget.grids[0].views
        assert "Press enter for next sample." in overlay.text
        monkeypatch.setattr(vispy.app, "run", press("Enter"))
        assert port_predict.visualize(cloud, ann, pred) is False
    finally:
        sys.modules.pop("recognizer3d_tpu_torch.ui.scene", None)


# --- the TensorBoard server of the training worker ----------------------------


def test_tensorboard_skipped_when_missing(monkeypatch, tmp_path):
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert port_train._start_tensorboard_server(tmp_path) is None


def test_tensorboard_launches_subprocess_on_logdir(monkeypatch, tmp_path):
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: object())
    calls = {}

    class FakePopen:
        def __init__(self, argv, **kwargs):
            calls["argv"] = argv

        def terminate(self):
            calls["terminated"] = True

    monkeypatch.setattr(subprocess, "Popen", FakePopen)
    server = port_train._start_tensorboard_server(tmp_path)
    assert isinstance(server, FakePopen)
    assert str(tmp_path) in calls["argv"]
    assert "tensorboard" in " ".join(calls["argv"])
    server.terminate()
    assert calls["terminated"]


def test_tensorboard_popen_failure_is_swallowed(monkeypatch, tmp_path):
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: object())

    def boom(*a, **k):
        raise OSError("no exec")

    monkeypatch.setattr(subprocess, "Popen", boom)
    assert port_train._start_tensorboard_server(tmp_path) is None


@pytest.mark.parametrize("fails", [False, True])
def test_training_worker_serves_its_log_while_it_trains(monkeypatch, fails):
    """The spawned worker serves ``training_log/`` and stops the server
    when training ends, however it ends."""
    events = []

    class Server:
        def terminate(self):
            events.append("terminated")

    def run_training(dirs, queue, device, compute_dtype):
        events.append(("train", dirs, device, compute_dtype))
        if fails:
            raise RuntimeError("training failed")

    monkeypatch.setattr(port_train, "_start_tensorboard_server",
                        lambda logdir: events.append(("serve", logdir)) or Server())
    monkeypatch.setattr(port_train, "run_training", run_training)
    if fails:
        with pytest.raises(RuntimeError, match="training failed"):
            port_train._run_training_job(["d"], None, "cpu")
    else:
        port_train._run_training_job(["d"], None, "cpu")
    assert events == [("serve", port_train.LOG_ROOT), ("train", ["d"], "cpu", "float32"),
                      "terminated"]


# --- profiling ------------------------------------------------------------------


def test_profiling_helpers_on_the_cpu():
    x = torch.arange(12.0).reshape(3, 4)
    calls = []

    def fn(t):
        calls.append(1)
        return {"sum": t.sum(), "parts": [t * 2, np.ones(2)]}

    out = profiling.warmup(fn, x)
    assert float(out["sum"]) == 66.0 and len(calls) == 1
    t = profiling.timeit(fn, x, iters=3, warmup_iters=1)
    assert t > 0 and len(calls) == 5
    t = profiling.timeit_amortized(fn, x, iters=4)
    assert t > 0 and len(calls) == 10


def test_profiling_spans_pair_each_call_s_first_and_last_kernel():
    """A route's span (``profiling.kernel_ms(..., span=True)``): each launch
    of the first kernel with the first launch of the last kernel after it
    and before the first's next launch; a call whose last launch the
    profiler dropped has no span, and a launch of the last kernel before
    any first is no call's."""
    from types import SimpleNamespace as R

    first = [R(start=0.0, end=2.0), R(start=10.0, end=12.0), R(start=20.0, end=22.0)]
    last = [R(start=-3.0, end=-1.0), R(start=1.0, end=8.0), R(start=4.0, end=9.0),
            R(start=11.0, end=17.0)]
    assert profiling._spans(first, last) == [8.0, 7.0]
    assert profiling._spans(first, []) == []
