"""The port's remaining samplers and the batched normalisation against the
JAX package's: the numpy samplers bit for bit under the same numpy seed,
the device sampler by the JAX package's own contract
(``tests/test_core_numerics.py``), and ``normalize_cloud_device``."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from recognizer3d_tpu.data import pipeline as jax_pipeline
from recognizer3d_tpu.data import preprocessing as jax_pre
from recognizer3d_tpu_torch.data import pipeline
from recognizer3d_tpu_torch.data import preprocessing as pre

LABELS = {
    "skewed": np.array([0] * 90 + [1] * 10),
    "three": np.r_[np.zeros(50), np.ones(7), 2 * np.ones(143)].astype(np.uint8),
    "single": np.ones(40, np.int32),
}


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _both(fn_port, fn_jax, seed, *args, **kwargs):
    np.random.seed(seed)
    got = fn_port(*args, **kwargs)
    after = np.random.get_state()[1].copy()
    np.random.seed(seed)
    ref = fn_jax(*args, **kwargs)
    # the same draws, and the same state of the global RNG afterwards
    np.testing.assert_array_equal(np.random.get_state()[1], after)
    return got, ref


@pytest.mark.parametrize("consistent", [False, True])
@pytest.mark.parametrize("labels", sorted(LABELS))
def test_balanced_and_equal_samplers_bit_equal_to_jax(labels, consistent):
    """``sample_points_balanced`` and ``sample_points_equal`` (ratios 1, 0.5
    and 0; sizes below and above the cloud, so quotas past a class's size
    pad with duplicates) over four seeds."""
    y = LABELS[labels]
    for seed in range(4):
        for n in (20, 333):
            got, ref = _both(pre.sample_points_balanced, jax_pre.sample_points_balanced, seed,
                             y, n, consistent=consistent)
            assert got.shape == (n,)
            np.testing.assert_array_equal(got, ref)
            for ratio in (1.0, 0.5, 0.0):
                got, ref = _both(pre.sample_points_equal, jax_pre.sample_points_equal, seed,
                                 y, n, ratio=ratio, consistent=consistent)
                assert got.shape == (n,)
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("consistent", [False, True])
def test_factor_sampler_bit_equal_to_jax(consistent):
    for seed in range(4):
        for n_points, factor in ((100, 0.25), (1000, 0.3), (50, 1.7)):
            got, ref = _both(pre.sample_points_factor, jax_pre.sample_points_factor, seed,
                             n_points, factor, consistent=consistent)
            assert got.shape == (int(n_points * factor),)
            np.testing.assert_array_equal(got, ref)


def test_device_sampler_contract():
    """The JAX package's contract (``test_device_sampler_shapes``): a
    downsample draws distinct indices; an upsample starts with every index
    once and pads with indices in range. int32, on the generator's device;
    a generator's seed fixes the draw, another seed draws another."""
    gen = torch.Generator().manual_seed(0)
    idx = pre.sample_points_device(gen, 100, 40)
    assert idx.shape == (40,) and idx.dtype == torch.int32 and idx.device == gen.device
    assert len(np.unique(idx.numpy())) == 40 and 0 <= int(idx.min()) and int(idx.max()) < 100
    idx = pre.sample_points_device(torch.Generator().manual_seed(0), 30, 100)
    assert idx.shape == (100,)
    assert sorted(idx[:30].tolist()) == list(range(30))
    assert 0 <= int(idx[30:].min()) and int(idx[30:].max()) < 30
    a = pre.sample_points_device(torch.Generator().manual_seed(5), 1000, 500)
    b = pre.sample_points_device(torch.Generator().manual_seed(5), 1000, 500)
    c = pre.sample_points_device(torch.Generator().manual_seed(6), 1000, 500)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("normalization", [None, "mean", "max", "stdev", "other"])
def test_normalize_cloud_device_matches_jax(normalization):
    """Batched (3 clouds) and single clouds, float32: within 1e-6 of the
    largest |coordinate| of JAX's result (its sums reduce in another
    order); and the batched form of each cloud equals the numpy
    ``normalize_cloud`` of that cloud to the same tolerance."""
    rng = np.random.RandomState(3)
    xyz = (rng.randn(3, 500, 3) * [0.2, 0.1, 0.05] + [0.1, -0.2, 0.5]).astype(np.float32)
    for x in (xyz, xyz[1]):
        got = pipeline.normalize_cloud_device(torch.from_numpy(x), normalization).numpy()
        ref = np.asarray(jax_pipeline.normalize_cloud_device(jnp.asarray(x), normalization))
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    got = pipeline.normalize_cloud_device(torch.from_numpy(xyz), normalization).numpy()
    for i in range(3):
        ref = pre.normalize_cloud(xyz[i], normalization)
        np.testing.assert_allclose(got[i], ref, rtol=0, atol=1e-6 * np.abs(ref).max())
