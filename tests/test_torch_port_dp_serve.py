"""Serving over several gloo ranks on the CPU: the port's ``DPServing``
(``recognizer3d_tpu_torch/parallel/serving.py``) against the JAX package's
``DPServing`` on 4 virtual devices and against the port's single-process
``Model.predict``, and the serve CLI's ``--devices`` and ``--point-shards``
against the JAX CLI's on the same captures, at ``tests/test_serve.py``'s
small settings, with the same weights and numpy seed.

Tolerances: confidences within 1e-5 of the JAX package's (as the single-card
CLI test holds them: both sides float32) and within 1e-6 of the port's own
``Model.predict`` (the same program on a block of the batch); masks equal
where the reference confidence lies more than 1e-4 from the threshold. The
JAX searches on the CPU compute squared distances in the expanded form
‖q‖² + ‖s‖² − 2q·s, whose rounding reaches a few 1e-7 on the unit cube, the
port's by direct differences: where a point's two nearest sampled points
(the final 1-NN upsample's support, in the uploaded coordinates: the CLI
uploads float16) lie within 1e-6 of each other, the upsample may pick
either, on one card as on several, so the JAX comparison skips those
points (near-ties: one of 9,500 on the CLI's captures) and holds the rest.

A process runs one group of ranks at a time, and the CLI starts its own:
the CLI tests come first, before the module's pool starts.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import serve as jax_serve
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.randlanet import RandLANet as JaxRandLANet
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.parallel.serving import DPServing as JaxDPServing
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch import serve as port_serve
from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.ops import _build, knn as port_knn
from recognizer3d_tpu_torch.ops.knn_kernels import knn_topk_plain
from recognizer3d_tpu_torch.parallel import mesh
from recognizer3d_tpu_torch.parallel.serving import DPServing

SETTINGS = dict(n_classes=2, n_points=256, n_features=0, n_neighbors=4, decimation=2,
                layer_sizes=[4, 8, 16, 32], knn="naive")
JAX_ATOL = 1e-5
SELF_ATOL = 1e-6
BAND = 1e-4


@pytest.fixture(autouse=True)
def _isolate_global_state():
    state = np.random.get_state()
    port_knn.reset_window_guard()
    yield
    np.random.set_state(state)
    port_knn.reset_window_guard()


@pytest.fixture(scope="module")
def weights():
    """JAX variables from a jitted init (a JAX ``Model`` without weights
    runs its init op by op, for half a minute)."""
    x = jnp.zeros((1, 256, 3), jnp.float32)
    return jax.device_get(jax.jit(JaxRandLANet(JaxSettings(**SETTINGS)).init)(
        jax.random.PRNGKey(0), x, jnp.arange(256, dtype=jnp.int32)))


def _port_model(weights):
    return Model(RandLANetSettings(**SETTINGS), weights=from_flax_variables(weights),
                 device="cpu")


def _make_captures(root, sizes):
    rng = np.random.RandomState(0)
    for i, n in enumerate(sizes):
        stem = f"2026_01_01__12_00_{i:02d}_000000000"
        np.save(root / f"{stem}_data.npy", rng.rand(n, 3).astype(np.float32))


def _near_ties(cloud: np.ndarray, upload=np.float32) -> np.ndarray:
    """(N,) bool: the squared distances of the point's two nearest
    consistently sampled points (the final upsample's support), in the
    coordinates the model receives, lie within 1e-6 of each other."""
    cloud = cloud.astype(upload).astype(np.float32)
    sampled = cloud[consistent_sample_indices(len(cloud), SETTINGS["n_points"])]
    _, d2 = knn_topk_plain(torch.from_numpy(sampled[None]), torch.from_numpy(cloud[None]), 2)
    d2 = d2[0].numpy()
    return d2[:, 1] - d2[:, 0] <= 1e-6


def _served(main, model, captures, out, *flags):
    np.random.seed(0)
    assert main(["-m", str(model), "-d", str(captures), "-o", str(out), "--batch", "2",
                 *flags]) == 0
    return {f.name[: f.name.rfind("_")]: np.load(f) for f in sorted(out.glob("*.npy"))}


@pytest.mark.parametrize("flag,n", [("--devices", 2), ("--point-shards", 4)])
def test_cli_flags_write_the_jax_clis_files(tmp_path, capsys, weights, flag, n):
    """Three captures in one bucket (two batches of 2, the second ragged) at
    batch 2: the port's CLI with ``flag n --device cpu`` writes the JAX
    CLI's files (``flag n`` on its virtual devices): confidences within
    1e-5, and with ``--devices`` (whose masks are thresholded on each
    rank's device) masks equal away from the threshold; the JSON line
    reports the ranks."""
    captures = tmp_path / "captures"
    captures.mkdir()
    _make_captures(captures, [3000, 3000, 3500])
    model = tmp_path / "model"
    _port_model(weights).save(model)
    ref = _served(jax_serve.main, model, captures, tmp_path / "jax", flag, str(n),
                  "--confidences")
    capsys.readouterr()
    conf = _served(port_serve.main, model, captures, tmp_path / "conf", flag, str(n),
                   "--device", "cpu", "--confidences")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    mask = {}
    if flag == "--devices":
        mask = _served(port_serve.main, model, captures, tmp_path / "mask", flag, str(n),
                       "--device", "cpu")
    assert len(ref) == len(conf) == 3 and len(mask) in (0, 3)
    ties = 0
    for stem, r in ref.items():
        assert conf[stem].shape == r.shape == (2, 3500 if "_02_" in stem else 3000)
        held = np.ones(r.shape[1], bool)
        if flag == "--devices":  # the point-sharded forward has no final upsample
            held = ~_near_ties(np.load(captures / f"{stem}_data.npy"), np.float16)
        ties += int((~held).sum())
        np.testing.assert_allclose(conf[stem][:, held], r[:, held], rtol=0, atol=JAX_ATOL)
        if mask:
            away = np.abs(r[1] - 0.5) > BAND
            assert mask[stem].dtype == np.bool_ and mask[stem].shape == (r.shape[1],)
            np.testing.assert_array_equal(mask[stem][away], (r[1] > 0.5)[away])
    assert ties <= 3
    summary = json.loads(line)
    assert summary["clouds"] == 3
    assert (summary["devices"], summary["point_shards"]) == (
        (n, 1) if flag == "--devices" else (1, n))


def test_cli_refuses_both_flags(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        port_serve.main(["-m", str(tmp_path / "m"), "-d", str(tmp_path), "-o",
                         str(tmp_path / "o"), "--devices", "2", "--point-shards", "2",
                         "--device", "cpu"])
    assert exc.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--devices", "--point-shards"])
def test_cli_refuses_more_ranks_than_cards(tmp_path, capsys, monkeypatch, flag):
    """On the card, N is at most the visible cards (JAX's mesh rule): 2 on a
    machine with one is refused before anything loads."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        port_serve.main(["-m", str(tmp_path / "m"), "-d", str(tmp_path), "-o",
                         str(tmp_path / "o"), flag, "2"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and "requested 2 devices, only 1 available" in err
    assert mesh.devices_for(-1, "cuda") == ["cuda:0"]


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(["cpu"] * 4) as p:
        yield p


@pytest.mark.parametrize("b", [4, 3])
def test_dp_serving_matches_jax_and_model_predict(pool, weights, b):
    """A batch of 4 clouds, and a ragged one of 3 (padded to 4 by its last
    cloud, which is dropped again), each after ``np.random.seed(0)``: the
    port's ``DPServing`` at 4 ranks against JAX's ``DPServing(model, 4)``
    and against the port's ``Model.predict`` in one process."""
    clouds = np.random.RandomState(b).rand(b, 3000, 3).astype(np.float32)
    port_model = _port_model(weights)
    jax_server = JaxDPServing(JaxModel(JaxSettings(**SETTINGS), weights=weights), 4)
    results = {}
    with DPServing(port_model, pool) as server:
        assert server.n_devices == 4
        for name, fn in (("dp", server.predict), ("dp_mask", server.predict_mask),
                         ("jax", jax_server.predict), ("single", port_model.predict)):
            np.random.seed(0)
            results[name] = fn(clouds)
    assert results["dp"].shape == results["jax"].shape == (b, 2, 3000)
    held = ~np.stack([_near_ties(c) for c in clouds])[:, None, :].repeat(2, 1)
    np.testing.assert_allclose(results["dp"][held], results["jax"][held], rtol=0,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(results["dp"], results["single"], rtol=0, atol=SELF_ATOL)
    away = np.abs(results["jax"][:, 1] - 0.5) > BAND
    assert results["dp_mask"].dtype == np.bool_ and results["dp_mask"].shape == (b, 3000)
    np.testing.assert_array_equal(results["dp_mask"][away], (results["jax"][:, 1] > 0.5)[away])


def test_workers_adopt_rank0s_session_window(pool, weights):
    """The session recall guard is per process: on every call, each worker
    takes rank 0's window and exact-fallback flag (the JAX package's shards
    share one process's)."""
    clouds = np.random.RandomState(0).rand(4, 3000, 3).astype(np.float32)
    with DPServing(_port_model(weights), pool) as server:
        assert pool.run(port_knn.session_guard_state) == [(4096, False)] * 4
        port_knn.adopt_session_guard((16384, True))
        server.predict_mask(clouds)
        assert pool.run(port_knn.session_guard_state) == [(16384, True)] * 4
        port_knn.reset_window_guard()
        server.predict_mask(clouds)
        assert pool.run(port_knn.session_guard_state) == [(4096, False)] * 4


def test_dp_launches_are_read_per_rank(pool, weights):
    """Each rank counts its own launches (none on the CPU: the wrappers run
    their plain versions) and reads its own peak memory."""
    pool.run(_build.reset_launches)
    with DPServing(_port_model(weights), pool) as server:
        server.predict(np.random.RandomState(1).rand(4, 3000, 3).astype(np.float32))
    assert pool.run(mesh.launches) == [{}] * 4
    assert pool.run(mesh.peak_memory_bytes) == [0] * 4
    assert pool.run(mesh.rank) == [0, 1, 2, 3] and pool.run(mesh.world) == [4] * 4
