"""The PyTorch port's model, weight bridge, archive I/O and predict path
against the JAX package, at the app config with the bundled weights.

The JAX oracle for the whole forward is ``knn="pallas"`` with the fused LFA
forced into interpret mode: the route the JAX package takes on its
accelerator, and one whose Pallas kernels compute neighbour distances by
direct differences, as the port's kernels do, so both sides pick the same
neighbour sets. (The JAX CPU route for ``knn="naive"`` uses the expanded
‖q‖²+‖s‖²−2q·s form, whose rounding flips near-tied neighbours.)
"""

import importlib.machinery
import importlib.util
import io
import pickle
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models import torch_compat as jax_compat
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu_torch import Model, Predictor, RandLANetSettings
from recognizer3d_tpu_torch.models import torch_compat as port_compat
from recognizer3d_tpu_torch.models.weights import from_flax_variables, to_flax_variables
from recognizer3d_tpu_torch.utils import msgpack_lite

ROOT = Path(__file__).resolve().parents[1]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data")
    )
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.make_frame


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    """Some tests seed or draw from numpy's global RNG (the facade's
    permutation contract); leave it as found for the tests that follow."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


@pytest.fixture
def force_fused():
    jax_rl.FORCE_FUSED_LFA_INTERPRET = True
    yield
    jax_rl.FORCE_FUSED_LFA_INTERPRET = False


def _archive_blob() -> bytes:
    with zipfile.ZipFile(ARCHIVE) as z:
        return z.read("model")


def _flax_variables():
    return serialization.msgpack_restore(_archive_blob())


def _assert_state_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), err_msg=key)


# --- weights and archives ------------------------------------------------------


def test_msgpack_decoder_matches_flax_on_the_archive():
    """The port's msgpack reader decodes the bundled weights blob into the
    same tree, leaf for leaf and bit for bit, as flax's own reader."""
    mine = jax.tree_util.tree_leaves_with_path(msgpack_lite.msgpack_restore(_archive_blob()))
    ref = jax.tree_util.tree_leaves_with_path(_flax_variables())
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, x), (_, y) in zip(mine, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y)


def test_weight_bridge_matches_flax_decode():
    """The port's own load of the bundled archive equals the bridge
    applied to flax's decode, and the bridge inverts exactly."""
    variables = _flax_variables()
    state = from_flax_variables(variables)
    model = Model.load(ARCHIVE, device="cpu")
    _assert_state_equal(model.module.state_dict(), state)
    back = to_flax_variables(state)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = jax.tree_util.tree_leaves_with_path(variables)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)


def test_save_load_round_trips_through_both_packages(tmp_path):
    port = Model.load(ARCHIVE, device="cpu")
    port.save(tmp_path / "from_port")
    jax_model = JaxModel.load(tmp_path / "from_port")
    ref = _flax_variables()
    for (pa, x), (pb, y) in zip(
        jax.tree_util.tree_leaves_with_path(jax.device_get(jax_model.variables)),
        jax.tree_util.tree_leaves_with_path(ref),
    ):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), y)
    assert jax_model.settings.layer_sizes == port.settings.layer_sizes
    jax_model.save(tmp_path / "from_jax")
    again = Model.load(tmp_path / "from_jax", device="cpu")
    _assert_state_equal(again.module.state_dict(), port.module.state_dict())
    assert again.settings == port.settings


def _reference_archive(path: Path, state_dict) -> Path:
    """A reference-layout archive: the bundled config beside a torch.save
    of ``{"model": state_dict}``."""
    with zipfile.ZipFile(ARCHIVE) as z:
        config = z.read("config")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}
    buf = io.BytesIO()
    torch.save({"model": tensors}, buf)
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config", config)
        z.writestr("model", buf.getvalue())
    return path


def test_torch_compat_copy_matches_the_jax_package():
    """The port's copy of the converter maps the bundled weights to the
    same reference state_dict and back to the same flax tree, leaf for leaf
    and bit for bit, as the JAX package's."""
    variables = _flax_variables()
    settings = JaxSettings(n_classes=2, layer_sizes=[16, 64, 128, 256])
    sd = port_compat.variables_to_torch_state_dict(variables, settings)
    ref_sd = jax_compat.variables_to_torch_state_dict(variables, settings)
    assert sorted(sd) == sorted(ref_sd)
    for key in sd:
        np.testing.assert_array_equal(sd[key], ref_sd[key], err_msg=key)
    back = jax.tree_util.tree_leaves_with_path(
        port_compat.torch_state_dict_to_variables(sd, settings)
    )
    ref = jax.tree_util.tree_leaves_with_path(
        jax_compat.torch_state_dict_to_variables(ref_sd, settings)
    )
    assert [p for p, _ in back] == [p for p, _ in ref]
    for (_, x), (_, y) in zip(back, ref):
        np.testing.assert_array_equal(x, y)


def test_reference_torch_archive_loads_in_both_packages(tmp_path, force_fused):
    """The JAX package's ``variables_to_torch_state_dict`` of the bundled
    weights, written as a reference torch archive, loads in the port to the
    msgpack archive's exact state, and its logits match the JAX package's
    load of the same file within 1e-4 (a 2,500-point mock cloud)."""
    jax_settings = JaxSettings(n_classes=2, layer_sizes=[16, 64, 128, 256])
    sd = jax_compat.variables_to_torch_state_dict(_flax_variables(), jax_settings)
    path = _reference_archive(tmp_path / "reference", sd)
    port = Model.load(path, device="cpu")
    _assert_state_equal(port.module.state_dict(), Model.load(ARCHIVE, device="cpu")
                        .module.state_dict())
    jax_model = JaxModel.load(path)
    frame, _ = _make_frame()(np.random.RandomState(6), 0.9, 2500)
    perm = np.random.RandomState(3).permutation(2500)
    kwargs = dict(vars(port.settings), knn="pallas")
    ref = _jax_logits(kwargs, jax_model.variables, frame[None], perm)
    with torch.inference_mode():
        out = port.module(torch.from_numpy(frame[None]), torch.from_numpy(perm))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_port_writes_reference_archives_the_jax_package_reads(tmp_path):
    """``torch_compat.save_reference_archive`` of the port's weights: the
    JAX package loads it to the bundled flax variables exactly, and the
    port reads it back to the same state. A blob that is neither msgpack
    nor a torch archive raises."""
    port = Model.load(ARCHIVE, device="cpu")
    sd = port_compat.variables_to_torch_state_dict(
        to_flax_variables(port.module.state_dict()), port.settings
    )
    path = tmp_path / "from_port"
    port_compat.save_reference_archive(path, port.settings, sd)
    jax_vars = jax.tree_util.tree_leaves_with_path(
        jax.device_get(JaxModel.load(path).variables)
    )
    ref = jax.tree_util.tree_leaves_with_path(_flax_variables())
    assert [p for p, _ in jax_vars] == [p for p, _ in ref]
    for (_, x), (_, y) in zip(jax_vars, ref):
        np.testing.assert_array_equal(np.asarray(x), y)
    again = Model.load(path, device="cpu")
    _assert_state_equal(again.module.state_dict(), port.module.state_dict())
    assert again.settings == port.settings
    with pytest.raises(pickle.UnpicklingError):
        Model._decode_weights(b"not weights", port.settings)


# --- the slice -----------------------------------------------------------------


def _jax_logits(settings_kwargs, variables, inputs, perm):
    net = jax_rl.RandLANet(JaxSettings(**settings_kwargs))
    apply = jax.jit(net.apply)  # one compile instead of op-by-op dispatch
    return np.asarray(apply(variables, jnp.asarray(inputs), jnp.asarray(perm)))


def test_logits_match_jax_at_app_config(force_fused):
    """RandLANet logits at the bundled app config (2,500 points, K=32,
    layers [16, 64, 128, 256]) on a mock frame, same permutation: 1e-4 on
    logits of order 10 (float32 sums over up to 1,024 channels)."""
    port = Model.load(ARCHIVE, device="cpu")
    frame, _ = _make_frame()(np.random.RandomState(0), 0.3, 2500)
    perm = np.random.RandomState(1).permutation(2500)
    kwargs = dict(vars(port.settings), knn="pallas")
    ref = _jax_logits(kwargs, _flax_variables(), frame[None], perm)
    with torch.inference_mode():
        out = port.module(torch.from_numpy(frame[None]), torch.from_numpy(perm))
    assert out.shape == (1, 2, 2500)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_predict_and_mask_match_jax_on_mock_cloud():
    """Model.predict / predict_mask on a seeded ~8k-point mock frame:
    consistent subsample -> forward -> softmax -> 1-NN upsample onto the
    bucket-padded cloud. Confidences within 1e-4; the mask equals the JAX
    confidences thresholded (what its ``predict_mask`` computes on the
    device) except where they lie within 1e-4 of the threshold."""
    cloud, _ = _make_frame()(np.random.RandomState(3), 1.1, 8000)
    port = Model.load(ARCHIVE, device="cpu")
    ref_model = JaxModel.load(ARCHIVE, knn="pallas")
    np.random.seed(11)
    ref = ref_model.predict(cloud)
    np.random.seed(11)
    conf = port.predict(cloud)
    assert conf.shape == (2, 8000)
    np.testing.assert_allclose(conf, ref, rtol=0, atol=1e-4)
    np.random.seed(11)
    mask = port.predict_mask(cloud, 0.5)
    near = np.abs(ref[1] - 0.5) <= 1e-4
    assert mask.dtype == bool and mask.shape == (8000,)
    np.testing.assert_array_equal(mask[~near], (ref[1] > 0.5)[~near])
    assert 0 < mask.sum() < 8000


def test_small_non_default_config_matches_jax(force_fused):
    """Two clouds with two extra features, K=16, decimation 2, three
    layers, ``upsampling="idw"`` set (unused by logits). The weights are the
    port's own random init with shifted running statistics, carried to JAX
    through the bridge."""
    kwargs = dict(
        n_classes=3, n_points=256, n_features=2, n_neighbors=16, decimation=2,
        layer_sizes=[16, 64, 32], knn="pallas", upsampling="idw",
    )
    rng = np.random.RandomState(5)
    inputs = np.concatenate(
        [rng.rand(2, 256, 3), rng.randn(2, 256, 2)], axis=-1
    ).astype(np.float32)
    perm = rng.permutation(256)
    port = Model(RandLANetSettings(**dict(kwargs, knn="naive")), device="cpu", seed=2)
    state = port.module.state_dict()
    for name, tensor in state.items():
        if name.endswith(("running_mean", "running_var")):
            tensor += 0.1
    ref = _jax_logits(kwargs, to_flax_variables(state), inputs, perm)
    with torch.inference_mode():
        out = port.module(torch.from_numpy(inputs), torch.from_numpy(perm))
    assert out.shape == (2, 3, 256)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


# --- devices, settings and imports ----------------------------------------------


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    settings = RandLANetSettings(n_classes=2, knn="naive")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(settings)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(settings, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(ARCHIVE)


def test_approximate_knn_raises_not_implemented(tmp_path):
    """The default ``knn="approximate"`` predicts; below the window regime
    (2,048 points) every search it routes is exact, so it equals
    ``knn="naive"``. ``knn="kdtree"`` predicts too, within 1e-4 of the JAX
    package's model on the same archive."""
    settings = RandLANetSettings(n_classes=2, n_points=2048)
    assert settings.knn == "approximate"
    cloud = np.random.RandomState(0).rand(2100, 3).astype(np.float32)
    model = Model(settings, device="cpu")
    np.random.seed(3)
    conf = model.predict(cloud)
    exact = Model(RandLANetSettings(n_classes=2, n_points=2048, knn="naive"), device="cpu")
    np.random.seed(3)
    np.testing.assert_array_equal(conf, exact.predict(cloud))
    assert model.recall_guard_result is None  # nothing to guard at 2,048 points
    kdtree = Model(RandLANetSettings(n_classes=2, n_points=2048, knn="kdtree"), device="cpu")
    kdtree.save(tmp_path / "kdtree")
    np.random.seed(3)
    ref = JaxModel.load(tmp_path / "kdtree").predict(cloud)
    np.random.seed(3)
    np.testing.assert_allclose(kdtree.predict(cloud), ref, rtol=0, atol=1e-4)


def test_cpu_predictor_runs_the_app_path():
    cloud, _ = _make_frame()(np.random.RandomState(4), 0.0, 5000)
    predictor = Predictor(ARCHIVE, device="cpu", warmup_points=5000)
    mask = predictor.predict(cloud)
    assert mask.shape == (5000,) and mask.dtype == bool
    assert predictor.model.transfer_dtype == "float16"


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports without JAX, flax or the JAX
    package. The UI modules and the app import vispy and tkinter, which
    need not be installed: the in-memory stubs stand in for them. A pool of
    two ranks (``parallel/mesh.RankPool``) runs a ring search, and neither
    rank has JAX loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pytest\n"
        "from tests import _tk_stub, _vispy_stub\n"
        "patch = pytest.MonkeyPatch()\n"
        "_vispy_stub.install(patch)\n"
        "_tk_stub.install(patch)\n"
        "import recognizer3d_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {p.__name__ + m for m in ('.app', '.ui.scene', '.serve', '.models.large',\n"
        "        '.benchmarks.bench_large', '.training.checkpoint', '.parallel.mesh',\n"
        "        '.parallel.ring_knn', '.parallel.serving', '.parallel.sp_lfa',\n"
        "        '.parallel.sp_model')} <= set(names), names\n"
        "import torch\n"
        "from recognizer3d_tpu_torch.parallel import mesh, ring_knn\n"
        "x = torch.rand(1, 64, 3)\n"
        "with mesh.RankPool(['cpu', 'cpu']) as pool:\n"
        "    mesh.shard_map(pool, ring_knn.ring_knn, x, x, 4)\n"
        "    loaded = pool.run(eval, 'sorted(__import__(\"sys\").modules)')\n"
        "assert len(loaded) == 2\n"
        "for modules in loaded:\n"
        "    bad = [m for m in modules if m in ('jax', 'flax', 'jaxlib')\n"
        "           or m.startswith(('jax.', 'flax.', 'recognizer3d_tpu.'))\n"
        "           or m == 'recognizer3d_tpu']\n"
        "    assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
