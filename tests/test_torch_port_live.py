"""The PyTorch port's live depth path against the JAX package, on the CPU:
the dewarp, the inverse projection, the z-band subsample and the whole
``LivePredictor`` program at the app config on the bundled weights.

The random inputs are drawn once and handed to both packages: JAX's
``jax.random.uniform`` of a threefry key, as numpy, is the port's uniform
draw. The JAX oracle of the program is ``knn="pallas"`` with the fused LFA
in interpret mode (the JAX package's accelerator route, whose kernels
compute distances by direct differences as the port's kernels do), run
jitted, as in ``tests/test_torch_port_model.py``.
"""

import importlib.machinery
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.data import pipeline as jax_pipeline
from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.live import LivePredictor as JaxLivePredictor
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.data import pipeline
from recognizer3d_tpu_torch.models.live import LivePredictor
from recognizer3d_tpu_torch.ops import knn as port_knn

ROOT = Path(__file__).resolve().parents[1]
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
# a small depth stream with the L515's field of view
SMALL = dict(width=160, height=120, fx=115.0, fy=115.0, cx=80.0, cy=60.0)
TINY = dict(
    n_classes=2, n_points=64, n_neighbors=4, decimation=2,
    layer_sizes=[4, 8, 16, 32], knn="naive",
)


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
    """The live path draws its permutation from numpy's global RNG; leave
    it as found for the tests that follow."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _intrinsics(**kwargs):
    return pipeline.DepthIntrinsics(**kwargs), jax_pipeline.DepthIntrinsics(**kwargs)


def _random_depth(seed, intr, zero_share=0.2):
    rng = np.random.RandomState(seed)
    depth = rng.randint(0, 1 << 16, (intr.height, intr.width)).astype(np.uint16)
    depth[rng.rand(intr.height, intr.width) < zero_share] = 0
    return depth


# --- dewarp and inverse projection ---------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, SMALL], ids=["l515", "small"])
def test_dewarp_matches_jax(kwargs):
    """Bit-exact against the eager JAX dewarp (the same float32 operation
    order); within 3e-7 relative of the jitted one, whose fusion rewrites
    the constant division (2.4e-7 at most here)."""
    intr, jintr = _intrinsics(**kwargs)
    depth = _random_depth(0, intr)
    eager = np.asarray(jax_pipeline.depth_to_cloud(jnp.asarray(depth), jintr))
    jitted = np.asarray(
        jax.jit(lambda d: jax_pipeline.depth_to_cloud(d, jintr))(jnp.asarray(depth))
    )
    cloud = pipeline.depth_to_cloud(torch.from_numpy(depth), intr).numpy()
    assert cloud.shape == (intr.height * intr.width, 3) and cloud.dtype == np.float32
    np.testing.assert_array_equal(cloud, eager)
    np.testing.assert_array_equal(cloud[:, 2], jitted[:, 2])
    assert (np.abs(cloud - jitted) <= 3e-7 * np.abs(jitted)).all()


def test_cloud_to_depth_matches_jax():
    intr, jintr = _intrinsics()
    cloud, _ = _make_frame()(np.random.RandomState(1), 0.7, 60_000)
    cloud[:50] = 0.0  # invalid points project nowhere
    depth = pipeline.cloud_to_depth(cloud, intr)
    assert depth.dtype == np.uint16 and depth.shape == (768, 1024)
    np.testing.assert_array_equal(depth, jax_pipeline.cloud_to_depth(cloud, jintr))
    assert (depth > 0).sum() > 20_000


# --- the z-band subsample ---------------------------------------------------------


def _jax_order(uniform, z, n_out, z_min=pipeline.Z_MIN, z_max=pipeline.Z_MAX):
    """The JAX package's off-TPU selection (``data/pipeline.py:108-117``)."""
    z = jnp.asarray(z)
    valid = (z > z_min) & (z < z_max)
    priority = jnp.where(valid, jnp.asarray(uniform), jnp.inf)
    return np.asarray(jax.lax.top_k(-priority, n_out)[1])


@pytest.mark.parametrize("draw", ["key3", "tied"])
def test_subsample_order_matches_jax_top_k(draw):
    """The selected indices equal ``lax.top_k(-priority, n_out)``'s on an
    L515-sized frame: a threefry draw (key 3 gives about 36k tied values
    over 786,432 pixels) and a draw rounded to 1/256 (every value tied)."""
    n_raw, n_out = 786_432, 16_384
    uniform = np.array(jax.random.uniform(jax.random.PRNGKey(3), (1, n_raw)))
    if draw == "tied":
        uniform = np.floor(uniform * 256) / 256
        assert len(np.unique(uniform)) == 256
    z = np.random.RandomState(2).uniform(0.0, 0.7, (1, n_raw)).astype(np.float32)
    order, valid = pipeline.subsample_order(
        torch.from_numpy(uniform), torch.from_numpy(z), n_out
    )
    np.testing.assert_array_equal(order.numpy(), _jax_order(uniform, z, n_out))
    np.testing.assert_array_equal(
        valid.numpy(), (z > np.float32(0.05)) & (z < np.float32(0.6))
    )


@pytest.mark.parametrize(
    "b,n_raw,n_out,in_band",
    [
        (None, 6000, 1024, 0.9),  # unbatched, mostly valid
        (None, 4000, 512, 0.02),  # fewer valid points than n_out
        (2, 3000, 700, 0.6),      # batched
    ],
)
def test_z_filter_subsample_matches_jax(b, n_raw, n_out, in_band):
    """Points and valid flags equal JAX's ``z_filter_subsample`` given its
    key's uniform draw; the padding is zero points with valid=False."""
    rng = np.random.RandomState(n_raw)
    shape = (n_raw,) if b is None else (b, n_raw)
    raw = rng.uniform(-0.3, 0.3, shape + (3,)).astype(np.float32)
    raw[..., 2] = np.where(rng.rand(*shape) < in_band, rng.uniform(0.1, 0.5, shape), 0.9)
    raw[..., :3][rng.rand(*shape) < 0.05] = 0.0
    key = jax.random.PRNGKey(n_out)
    ref_pts, ref_valid = jax_pipeline.z_filter_subsample(key, jnp.asarray(raw), n_out)
    uniform = np.array(jax.random.uniform(key, (b or 1, n_raw)))
    pts, valid = pipeline.z_filter_subsample(
        torch.from_numpy(uniform if b else uniform[0]), torch.from_numpy(raw), n_out
    )
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    n_valid = valid.numpy().sum(-1)
    if in_band < 0.1:
        assert (n_valid < n_out).all()
        assert not pts.numpy()[..., n_valid.max():, :].any()


# --- LivePredictor -----------------------------------------------------------------


@pytest.fixture
def force_fused():
    jax_rl.FORCE_FUSED_LFA_INTERPRET = True
    yield
    jax_rl.FORCE_FUSED_LFA_INTERPRET = False


def test_live_program_matches_jax(force_fused):
    """The port's ``program_fn`` against the jitted JAX program at the app
    config (bundled weights, 160×120 depth, n_display 4,096), both given
    the same depth frame, uniform draw and permutation. Packed xyz within
    one float16 ulp; masks equal wherever JAX's class-1 confidence lies
    more than 1e-4 from the threshold (read off JAX's masks at 0.5 ± 1e-4)."""
    intr, jintr = _intrinsics(**SMALL)
    n_display, thr = 4096, 0.5
    cloud, _ = _make_frame()(np.random.RandomState(5), 0.8, 60_000)
    depth = pipeline.cloud_to_depth(cloud, intr)
    key = np.array([7, 11], np.uint32)
    uniform = np.array(jax.random.uniform(jnp.asarray(key), (1, depth.size)))
    perm = np.random.RandomState(2).permutation(2500).astype(np.int32)

    jax_model = JaxModel.load(ARCHIVE, knn="pallas")
    jax_live = JaxLivePredictor(jax_model, n_display=n_display, intrinsics=jintr)

    def jax_packed(t):
        return np.asarray(jax_live._program(
            jax_model.variables, jnp.asarray(depth), key, perm, jnp.float32(t)
        ))

    ref = jax_packed(thr)
    near = (jax_packed(thr - 1e-4)[:, 3] > 0) != (jax_packed(thr + 1e-4)[:, 3] > 0)

    port_live = LivePredictor(Model.load(ARCHIVE, device="cpu"), n_display=n_display,
                              intrinsics=intr)
    out = port_live.program_fn(
        torch.from_numpy(depth), torch.from_numpy(uniform), torch.from_numpy(perm), thr
    ).numpy()
    assert out.shape == (n_display, 4) and out.dtype == np.float16
    ulp = np.spacing(np.abs(ref[:, :3]))
    assert (np.abs(out[:, :3].astype(np.float32) - ref[:, :3]) <= ulp).all()
    mask, ref_mask = out[:, 3] > 0, ref[:, 3] > 0
    np.testing.assert_array_equal(mask[~near], ref_mask[~near])
    assert 0 < ref_mask.sum() < n_display and near.sum() < 10


def _tiny_live(knn="naive", **kwargs):
    intr = pipeline.DepthIntrinsics(width=64, height=48, fx=50.0, fy=50.0,
                                    cx=32.0, cy=24.0, depth_scale=0.001)
    model = Model(RandLANetSettings(**dict(TINY, knn=knn)), device="cpu", seed=0)
    return model, LivePredictor(model, intrinsics=intr, n_display=512, **kwargs)


def test_live_frame_and_out_of_band_frame():
    """A plane at 0.3 m: every display point valid at z = 0.3, the mask a
    subset of the valid points, one host buffer reused; a frame at 5 m
    (outside the z band) gives zero points and an empty mask."""
    _, live = _tiny_live(confidence_threshold=0.5)
    pts, mask = live.predict_depth(np.full((48, 64), 300, np.uint16))
    assert pts.shape == (512, 3) and pts.dtype == np.float32
    assert mask.shape == (512,) and mask.dtype == bool
    valid = np.abs(pts).sum(-1) > 0
    assert valid.all()
    np.testing.assert_allclose(pts[:, 2], 0.3, atol=1e-3)
    buf = live._host_buf
    pts, mask = live.predict_depth(np.full((48, 64), 5000, np.uint16))
    assert not mask.any() and not pts.any()
    assert live._host_buf is buf
    with pytest.raises(ValueError, match="depth of shape"):
        live.predict_depth(np.zeros((10, 10), np.uint16))


def test_recall_guard_probes_the_first_real_frame_once(monkeypatch):
    """The all-zero warm-up frame does not feed the recall guard; the
    first real frame does, once, with the cloud sampled to n_points."""
    port_knn.reset_window_guard()
    calls = []
    monkeypatch.setattr(port_knn, "window_regime_active", lambda n: True)
    monkeypatch.setattr(
        port_knn, "ensure_window_recall",
        lambda cloud, k, **kw: calls.append(np.shape(cloud)) or {},
    )
    model, live = _tiny_live(knn="approximate")
    assert calls == []
    depth = np.full((48, 64), 300, np.uint16)
    live.predict_depth(depth)
    assert calls == [(model.settings.n_points, 3)]
    live.predict_depth(depth)
    assert len(calls) == 1
