"""The port's batch-serving CLI (``python -m recognizer3d_tpu_torch.serve``)
against the repository's ``serve.py`` on the CPU, on ``tests/test_serve.py``'s
captures and small settings, with the same archive and numpy seed.

Both CLIs draw each batch's permutation (and their warm-up batches') from
numpy's global generator, so a seed before each run gives both the same
draws. Masks threshold a continuous confidence: they are held equal where
the confidence lies more than 1e-4 from the threshold.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import serve as jax_serve
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu_torch import serve as port_serve

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = dict(n_classes=2, n_points=256, n_features=0, n_neighbors=4,
                decimation=2, layer_sizes=[4, 8, 16, 32], knn="naive")


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _make_captures(root: Path, sizes):
    """test_serve.py's captures."""
    rng = np.random.RandomState(0)
    for i, n in enumerate(sizes):
        stem = f"2026_01_01__12_00_{i:02d}_000000000"
        np.save(root / f"{stem}_data.npy", rng.rand(n, 3).astype(np.float32))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both CLIs over three 4,096-point clouds and one of 5,000 (two size
    groups, a partial batch), batch 2, each run after ``np.random.seed(0)``:
    the port's masks and confidences, the JAX CLI's confidences (its masks
    are those confidences thresholded on its device; its compiles dominate
    the file's time). Returns {(side, output): {stem: array}}."""
    tmp = tmp_path_factory.mktemp("serve")
    captures = tmp / "captures"
    captures.mkdir()
    _make_captures(captures, [4096, 4096, 4096, 5000])
    model = tmp / "model"
    JaxModel(JaxSettings(**SETTINGS), seed=0).save(model)
    outs = {}
    for side, main, extra in (("jax", jax_serve.main, []),
                              ("port", port_serve.main, ["--device", "cpu"])):
        for output, flags, suffix in (("mask", [], "_prediction.npy"),
                                      ("confidences", ["--confidences"], "_confidences.npy")):
            if (side, output) == ("jax", "mask"):
                continue
            out = tmp / f"{side}_{output}"
            np.random.seed(0)
            assert main(["-m", str(model), "-d", str(captures), "-o", str(out),
                         "--batch", "2", *flags, *extra]) == 0
            outs[side, output] = {f.name[: -len(suffix)]: np.load(f)
                                  for f in sorted(out.glob("*" + suffix))}
    return outs


def test_serve_writes_the_jax_clis_files(served):
    """One file a cloud, under the JAX CLI's names; confidences within 1e-5
    of the JAX CLI's; masks bool, one a point, equal to the JAX CLI's
    confidences thresholded where those lie more than 1e-4 from it."""
    stems = sorted(served["jax", "confidences"])
    assert len(stems) == 4
    assert sorted(served["port", "confidences"]) == sorted(served["port", "mask"]) == stems
    for stem, conf in served["jax", "confidences"].items():
        got = served["port", "confidences"][stem]
        assert got.shape == conf.shape == (2, 5000 if stem.endswith("03_000000000") else 4096)
        np.testing.assert_allclose(got, conf, rtol=0, atol=1e-5)
        mask = served["port", "mask"][stem]
        assert mask.dtype == np.bool_ and mask.shape == (conf.shape[1],)
        away = np.abs(conf[1] - 0.5) > 1e-4
        np.testing.assert_array_equal(mask[away], (conf[1] > 0.5)[away])


def test_serve_prints_the_throughput_line(tmp_path, capsys):
    captures = tmp_path / "captures"
    captures.mkdir()
    _make_captures(captures, [4096, 4096, 4096])
    model = tmp_path / "model"
    JaxModel(JaxSettings(**SETTINGS), seed=0).save(model)
    assert port_serve.main(["-m", str(model), "-d", str(captures), "-o", str(tmp_path / "o"),
                            "--batch", "2", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["clouds"] == 3 and line["clouds_per_sec"] > 0
    assert {k: line[k] for k in ("batch", "devices", "point_shards", "output")} == {
        "batch": 2, "devices": 1, "point_shards": 1, "output": "mask"}


def test_serve_empty_dir(tmp_path, capsys):
    model = tmp_path / "model"
    JaxModel(JaxSettings(**SETTINGS), seed=0).save(model)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert port_serve.main(["-m", str(model), "-d", str(empty), "-o", str(tmp_path / "o"),
                            "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip()) == {"clouds": 0, "seconds": 0.0}


def test_serve_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without --device the model loads on the GPU: on a machine without
    CUDA that raises, and does not serve on the CPU."""
    captures = tmp_path / "captures"
    captures.mkdir()
    _make_captures(captures, [4096])
    model = tmp_path / "model"
    JaxModel(JaxSettings(**SETTINGS), seed=0).save(model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_serve.main(["-m", str(model), "-d", str(captures), "-o", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists()


def test_serve_cli_runs_without_jax(tmp_path):
    """``python -m recognizer3d_tpu_torch.serve`` in a process of its own:
    one mask a cloud, the JSON line, and no module of JAX, flax or the JAX
    package loaded when it ends."""
    captures = tmp_path / "captures"
    captures.mkdir()
    _make_captures(captures, [4096, 5000])
    model = tmp_path / "model"
    JaxModel(JaxSettings(**SETTINGS), seed=0).save(model)
    out = tmp_path / "out"
    code = (
        "import sys, runpy\n"
        f"sys.argv = ['serve', '-m', {str(model)!r}, '-d', {str(captures)!r}, "
        f"'-o', {str(out)!r}, '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('recognizer3d_tpu_torch.serve', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'recognizer3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["clouds"] == 2
    assert len(list(out.glob("*_prediction.npy"))) == 2
