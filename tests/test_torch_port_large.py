"""The PyTorch port's chunked million-point eval forward
(``recognizer3d_tpu_torch/models/large.py``) against the JAX package's
``forward_eval_large``, at small sizes with small chunks, as
``tests/test_large.py`` exercises the JAX one.

The small config searches on ``knn="naive"``, as test_large.py's does: JAX's
CPU route computes the expanded ‖q‖² + ‖s‖² − 2q·s form, the port direct
differences, and on these seeded clouds both pick the same neighbours (a
flipped neighbour would move a logit far past the tolerance). The fused
configs search on ``knn="pallas"`` (the TPU route, whose kernel computes
direct differences too). The weights come from a jitted JAX init through
the weight bridge; the inputs from numpy seeds. The JAX oracles are jitted,
their fused levels in interpret mode where a test forces them.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import recognizer3d_tpu.models.large as jax_large
from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.ops import knn as jax_knn
from recognizer3d_tpu.ops.knn_pallas import morton_order as jax_morton_order
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.models import facade as port_facade
from recognizer3d_tpu_torch.models import large as port_large
from recognizer3d_tpu_torch.models.randlanet import RandLANet
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.ops import knn as port_knn

SMALL = dict(n_classes=2, n_points=256, n_features=0, n_neighbors=4, decimation=2,
             layer_sizes=[4, 8, 16, 32], knn="naive")
FUSED = dict(n_classes=2, n_points=512, n_features=0, n_neighbors=16, decimation=4,
             layer_sizes=[16, 64], knn="pallas")


@pytest.fixture(autouse=True)
def _isolate_global_state():
    """Leave numpy's global RNG, both packages' session recall guards and
    JAX's interpret switch as found."""
    state = np.random.get_state()
    jax_knn.reset_window_guard()
    port_knn.reset_window_guard()
    yield
    np.random.set_state(state)
    jax_knn.reset_window_guard()
    port_knn.reset_window_guard()
    jax_rl.FORCE_FUSED_LFA_INTERPRET = False


def _setup(kwargs, batch, seed):
    """JAX settings and variables (a jitted init), the port's twin module in
    eval mode through the weight bridge, and seeded inputs and permutation."""
    settings = JaxSettings(**kwargs)
    n = kwargs["n_points"]
    rng = np.random.RandomState(seed)
    inputs = rng.rand(batch, n, 3).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    variables = jax.device_get(jax.jit(jax_rl.RandLANet(settings).init)(
        jax.random.PRNGKey(0), jnp.asarray(inputs), jnp.asarray(perm)))
    net = RandLANet(RandLANetSettings(**kwargs))
    net.load_state_dict(from_flax_variables(variables))
    net.eval()
    return settings, variables, net, inputs, perm


@pytest.fixture(scope="module")
def small():
    return _setup(SMALL, 2, 0)


def _jax_large(settings, variables, inputs, perm, chunk):
    f = jax.jit(lambda v, x, p: jax_large.forward_eval_large(v, settings, x, p, chunk=chunk))
    return np.asarray(f(variables, jnp.asarray(inputs), jnp.asarray(perm)))


def _port_large(net, inputs, perm, chunk):
    with torch.inference_mode():
        return port_large.forward_eval_large(
            net, torch.from_numpy(inputs), torch.from_numpy(perm), chunk=chunk).numpy()


@pytest.mark.parametrize("chunk", [64, 100, 256])
def test_chunked_forward_matches_jax(small, chunk):
    """The port's forward_eval_large equals JAX's at tests/test_large.py's
    small config (every level chunked: K = 4 is no fused geometry), within
    1e-5: the same operations in float32, summed in another order."""
    settings, variables, net, inputs, perm = small
    got = _port_large(net, inputs, perm, chunk)
    ref = _jax_large(settings, variables, inputs, perm, chunk)
    assert got.shape == ref.shape == (2, 2, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=f"chunk={chunk}")


@pytest.mark.parametrize("chunk", [64, 100, 256])
def test_chunked_forward_matches_the_in_model_forward(small, chunk):
    """The chunked forward computes the in-model forward's function, to
    tests/test_large.py's tolerance (the in-model LocSE is the linearised
    split of mlp_rpe1, the chunked one its 10-channel concat)."""
    _, _, net, inputs, perm = small
    got = _port_large(net, inputs, perm, chunk)
    with torch.inference_mode():
        ref = net(torch.from_numpy(inputs), torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3, err_msg=f"chunk={chunk}")


def test_fused_levels_match_jax(monkeypatch):
    """At test_large.py's TestFusedLevels config both encoder levels (half 8
    and 32, K = 16) run the LFA kernels' plain versions on each chunk, and
    JAX's fused levels their Pallas kernels in interpret mode; within 1e-5."""
    settings, variables, net, inputs, perm = _setup(FUSED, 1, 1)
    monkeypatch.setattr(jax_rl, "FORCE_FUSED_LFA_INTERPRET", True)
    ref = _jax_large(settings, variables, inputs, perm, 128)
    calls = []
    orig = port_large._lfa_fused_level
    monkeypatch.setattr(port_large, "_lfa_fused_level",
                        lambda *a, **kw: calls.append(a[2].shape[0]) or orig(*a, **kw))
    got = _port_large(net, inputs, perm, 128)
    assert calls == [512, 128]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_memory_gate_sends_levels_to_the_chunked_branch(monkeypatch):
    """With the gate at 0 bytes no level takes the kernels, and the result
    is JAX's chunked forward's."""
    settings, variables, net, inputs, perm = _setup(FUSED, 1, 1)
    monkeypatch.setattr(port_large, "_FUSED_LEVEL_MAX_GATHER_BYTES", 0)
    calls = []
    orig = port_large._lfa_fused_level
    monkeypatch.setattr(port_large, "_lfa_fused_level",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    got = _port_large(net, inputs, perm, 128)
    assert calls == []
    ref = _jax_large(settings, variables, inputs, perm, 128)  # JAX chunked on the CPU
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_approximate_fused_level_matches_jax_sliced_gathers(monkeypatch):
    """JAX's fused level gathers each chunk's rows from a slice of the table
    when the self-KNN ran through the Morton window (test_large.py's
    TestSlicedGathers sizes: a 16,384-point gaussian level, K = 16, chunk
    2,048, window 4,096); the port gathers from the whole table. Both sides
    get the same neighbours, the port's window search (the same windows as
    JAX's, so every index lies in the slice JAX gathers from), and agree
    within 1e-5."""
    rng = np.random.RandomState(3)
    n, h = 16384, 8
    xyz = rng.randn(n, 3).astype(np.float32) * 0.2
    xyz = xyz[np.asarray(jax_morton_order(jnp.asarray(xyz[None]))[0])]
    feats = (rng.randn(n, 2 * h).astype(np.float32) * 0.1)[:, :8]
    _, variables, net, _, _ = _setup(dict(FUSED, knn="approximate"), 1, 4)
    p, s = variables["params"]["encoder_0"], variables["batch_stats"]["encoder_0"]
    assert jax_knn.window_regime_active(n) and jax_knn.session_window_points() == 4096
    nb, d2 = port_knn.knn_presorted(torch.from_numpy(xyz[None]), torch.from_numpy(xyz[None]),
                                    16, "approximate")
    nb_j, d2_j = jnp.asarray(nb.numpy()), jnp.asarray(d2.numpy())
    monkeypatch.setattr(jax_large, "knn_presorted", lambda *a, **kw: (nb_j, d2_j))
    monkeypatch.setattr(port_large, "knn_presorted", lambda *a, **kw: (nb, d2))
    monkeypatch.setattr(jax_rl, "FORCE_FUSED_LFA_INTERPRET", True)
    ref = np.asarray(jax.jit(lambda a, f: jax_large._lfa_fused_level(
        p, s, a, f, 16, "approximate", 2048))(jnp.asarray(xyz), jnp.asarray(feats)))
    with torch.inference_mode():
        got = port_large._lfa_fused_level(net.encoder_0, torch.from_numpy(xyz),
                                          torch.from_numpy(feats), 16, "approximate",
                                          2048).numpy()
    assert got.shape == ref.shape == (n, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_facade_routes_large_clouds_through_the_chunked_forward(small, monkeypatch):
    """Model.predict(prepostprocess=False) on a cloud past the threshold
    runs forward_eval_large (no longer a NotImplementedError), as the JAX
    facade does, and returns JAX's confidences for the same seed."""
    settings, variables, net, inputs, _ = small
    monkeypatch.setattr(port_facade, "_LARGE_FORWARD_MIN", 200)
    import recognizer3d_tpu.models.facade as jax_facade
    monkeypatch.setattr(jax_facade, "_LARGE_FORWARD_MIN", 200)
    calls = []
    orig = port_facade.forward_eval_large
    monkeypatch.setattr(port_facade, "forward_eval_large",
                        lambda *a, **kw: calls.append(a[1].shape) or orig(*a, **kw))
    model = Model(RandLANetSettings(**SMALL), weights=net.state_dict(), device="cpu")
    np.random.seed(11)
    got = model.predict(inputs, prepostprocess=False)
    assert calls == [(2, 256, 3)]
    jax_model = JaxModel(settings, weights=variables)
    np.random.seed(11)
    ref = jax_model.predict(inputs, prepostprocess=False)
    assert got.shape == ref.shape == (2, 2, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_bfloat16_model_computes_in_float32_there(small):
    """forward_eval_large reads no compute_dtype: a bfloat16 model routed
    there computes JAX's float32 function, and exactly what the same weights
    in a float32 model compute."""
    settings, variables, net, inputs, perm = small
    net16 = RandLANet(RandLANetSettings(**SMALL, compute_dtype="bfloat16"))
    net16.load_state_dict(net.state_dict())
    net16.eval()
    got = _port_large(net16, inputs, perm, 64)
    np.testing.assert_array_equal(got, _port_large(net, inputs, perm, 64))
    settings16 = JaxSettings(**SMALL, compute_dtype="bfloat16")
    ref = _jax_large(settings16, variables, inputs, perm, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_forward_eval_large_refuses_train_mode(small):
    _, _, net, inputs, perm = small
    net.train()
    try:
        with pytest.raises(RuntimeError, match="eval only"):
            port_large.forward_eval_large(net, torch.from_numpy(inputs), torch.from_numpy(perm))
    finally:
        net.eval()
