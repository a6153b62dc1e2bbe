"""``knn="kdtree"`` in the port: its host KD-tree (``csrc/kdtree.cpp``,
built by ``ops/_build.build_kdtree`` and loaded by ``ops/knn_cpp.py``)
against the JAX package's (``recognizer3d_tpu/native``), the same C++ code:
results bit for bit, the padding where k > N, the errors on bad input; the
route on tensors; and a ``knn="kdtree"`` model's predictions against JAX's.
"""

import importlib.machinery
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.ops import knn_cpp as jax_knn_cpp
from recognizer3d_tpu_torch import Model
from recognizer3d_tpu_torch.ops import _build
from recognizer3d_tpu_torch.ops import knn as port_knn
from recognizer3d_tpu_torch.ops import knn_cpp

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _cloud(seed, b, n):
    return np.random.RandomState(seed).rand(b, n, 3).astype(np.float32)


@pytest.mark.parametrize(
    "b,n,m,k",
    [
        (1, 2500, 2500, 32),  # the app's level-0 self-KNN shape
        (2, 700, 50, 9),
        (1, 5, 7, 9),  # k > N: the last neighbour repeats
        (3, 1, 4, 2),
        (1, 300, 300, 1),
    ],
)
def test_host_kdtree_equals_jax_bit_for_bit(b, n, m, k):
    support = _cloud(n + k, b, n)
    query = support if n == m else _cloud(m + 1, b, m)
    idx, d2 = knn_cpp.knn_kdtree_host(support, query, k)
    ref_i, ref_d = jax_knn_cpp.knn_kdtree_host(support, query, k)
    assert idx.dtype == np.int32 and d2.dtype == np.float32 and idx.shape == (b, m, k)
    np.testing.assert_array_equal(idx, ref_i)
    np.testing.assert_array_equal(d2.view(np.uint32), ref_d.view(np.uint32))
    if k > n:
        np.testing.assert_array_equal(idx[..., n:], np.repeat(idx[..., n - 1:n], k - n, -1))


@pytest.mark.parametrize(
    "support,query,k",
    [
        (np.zeros((10, 3)), np.zeros((1, 4, 3)), 2),  # not 3-D
        (np.zeros((2, 10, 3)), np.zeros((1, 4, 3)), 2),  # batch mismatch
        (np.zeros((1, 0, 3)), np.zeros((1, 4, 3)), 2),  # empty support
        (np.zeros((1, 10, 3)), np.zeros((1, 4, 3)), 0),  # k < 1
    ],
)
def test_host_kdtree_rejects_what_jax_rejects(support, query, k):
    with pytest.raises(ValueError) as port_error:
        knn_cpp.knn_kdtree_host(support, query, k)
    with pytest.raises(ValueError) as jax_error:
        jax_knn_cpp.knn_kdtree_host(support, query, k)
    assert str(port_error.value) == str(jax_error.value)


def test_kdtree_route_on_tensors():
    """``knn``/``knn_presorted`` with ``"kdtree"`` run the host tree and
    return int32 indices and float32 distances on the input's device; an
    unknown approach still raises."""
    s, q = _cloud(1, 2, 400), _cloud(2, 2, 60)
    ref_i, ref_d = jax_knn_cpp.knn_kdtree_host(s, q, 8)
    for fn in (port_knn.knn, port_knn.knn_presorted):
        idx, d2 = fn(torch.from_numpy(s), torch.from_numpy(q), 8, "kdtree")
        assert idx.dtype == torch.int32 and d2.dtype == torch.float32
        assert idx.device.type == "cpu"
        np.testing.assert_array_equal(idx.numpy(), ref_i)
        np.testing.assert_array_equal(d2.numpy(), ref_d)
    with pytest.raises(ValueError, match="not understood"):
        port_knn.knn(torch.from_numpy(s), torch.from_numpy(q), 8, "faiss")


def test_failed_build_raises(tmp_path):
    """A g++ failure raises; no library of another build is loaded in its
    place (each build's name carries the hash of its source and flags)."""
    good = _build.build_kdtree(out_dir=tmp_path)
    assert good.is_file() and good.parent == tmp_path
    broken = tmp_path / "kdtree.cpp"
    broken.write_text(_build.KDTREE_SRC.read_text() + "\nnot C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_kdtree(src=broken, out_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.glob("*.so")) == [good.name]


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data"))
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod.make_frame


def test_kdtree_model_predict_matches_jax():
    """The bundled weights at the app config with ``knn="kdtree"`` on a
    seeded 6,000-point mock frame: confidences within 1e-4 of the JAX
    package's, masks equal away from the threshold (the tolerance of
    ``tests/test_torch_port_model.py``). Both sides search every encoder
    level and decoder upsampling with the same host tree, and the final
    upsample with the exact ``"naive"`` route."""
    archive = ROOT / "pretrained" / "mock_fingertip"
    cloud, _ = _make_frame()(np.random.RandomState(9), 0.7, 6000)
    port = Model.load(archive, device="cpu", knn="kdtree")
    ref_model = JaxModel.load(archive, knn="kdtree")
    assert port.settings.knn == ref_model.settings.knn == "kdtree"
    np.random.seed(13)
    ref = ref_model.predict(cloud)
    np.random.seed(13)
    conf = port.predict(cloud)
    assert conf.shape == (2, 6000)
    np.testing.assert_allclose(conf, ref, rtol=0, atol=1e-4)
    np.random.seed(13)
    mask = port.predict_mask(cloud, 0.5)
    near = np.abs(ref[1] - 0.5) <= 1e-4
    np.testing.assert_array_equal(mask[~near], (ref[1] > 0.5)[~near])
    assert 0 < mask.sum() < 6000
