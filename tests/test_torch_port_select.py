"""The port's selection of each row's n smallest priorities
(``ops/select_kernels.select_smallest``, whose CUDA kernel is B8) against
the JAX package's ``lax.top_k(-priority, n_out)``: the off-TPU branch of
``z_filter_subsample`` and the selection of ``DeviceDatasetCache``'s
sampler. On CPU tensors the wrapper runs its plain version; the indices
must equal JAX's index for index, ties and +inf runs included. The kernel
itself is held against the plain version on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.data.pipeline import DeviceDatasetCache as JaxDeviceDatasetCache
from recognizer3d_tpu_torch.data import pipeline
from recognizer3d_tpu_torch.data.pipeline import DeviceDatasetCache, SampleDraws
from recognizer3d_tpu_torch.ops import select_kernels
from recognizer3d_tpu_torch.ops.select_kernels import select_smallest


def _jax_smallest(priority: np.ndarray, n_out: int) -> np.ndarray:
    return np.asarray(jax.lax.top_k(-jnp.asarray(priority), n_out)[1])


def _priorities(case: str):
    """(priority (B, N) float32, n_out) of each case, from a seeded draw."""
    rng = np.random.RandomState(sum(map(ord, case)))
    if case == "distinct":
        return rng.rand(1, 50_000), 1_000
    if case == "rounded":  # a draw rounded to 1/256: every value tied
        return np.floor(rng.rand(1, 50_000) * 256) / 256, 4_000
    if case == "inf_runs":  # +inf runs longer than N - n_out: 300 valid of 20,000
        u = np.full((1, 20_000), np.inf)
        keep = rng.choice(20_000, 300, replace=False)
        u[0, keep] = rng.rand(300)
        return u, 2_000
    if case == "all_inf":
        return np.full((2, 3_000), np.inf), 700
    if case == "n_out_is_n":
        return rng.rand(2, 4_099), 4_099
    if case == "n_out_is_1":
        return np.floor(rng.rand(2, 5_000) * 64) / 64, 1
    if case == "batched_valid_counts":  # rows with 6,000, 100 and 2,500 valid points
        u = rng.rand(3, 6_000)
        u[1, 100:] = np.inf
        u[2, 2_500:] = np.inf
        return u, 2_500
    raise ValueError(case)


@pytest.mark.parametrize("case", ["distinct", "rounded", "inf_runs", "all_inf", "n_out_is_n",
                                  "n_out_is_1", "batched_valid_counts"])
def test_select_smallest_matches_jax_top_k(case):
    priority, n_out = _priorities(case)
    priority = priority.astype(np.float32)
    got = select_smallest(torch.from_numpy(priority), n_out)
    assert got.dtype == torch.int64 and got.shape == (priority.shape[0], n_out)
    np.testing.assert_array_equal(got.numpy(), _jax_smallest(priority, n_out))


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_matches_the_jax_sampler_at_the_train_shape(seed):
    """``DeviceDatasetCache.assemble`` at the app recipe's shape (4 clouds ×
    2,500 points, the longest cloud 20,000) handed the JAX sampler's draws
    (its ``_sample_one`` splits: the selection's uniform priorities, the
    duplicate positions), against the JAX cache's ``sample_batch``: the
    same rows and labels, bit for bit; one cloud is shorter than 2,500
    (its tail duplicates selected points) and one holds exactly 2,500."""
    rng = np.random.RandomState(seed)
    clouds = []
    for n in (20_000, 1_800, 6_000, 2_500):
        xyz = rng.rand(n, 3).astype(np.float32)
        clouds.append((xyz, np.zeros((n, 0)), (xyz[:, 0] * 2).astype(np.uint8)))
    n_points, ids = 2_500, [0, 1, 2, 3]
    ref_cache = JaxDeviceDatasetCache(clouds, n_points)
    cache = DeviceDatasetCache(clouds, n_points, device="cpu")
    key = jax.random.PRNGKey(seed)
    ref_pts, ref_labels = jax.device_get(ref_cache.sample_batch(key, np.asarray(ids)))
    uniform, dup = [], []
    for k, i in zip(jax.random.split(key, len(ids)), ids):
        k_sel, k_dup, _ = jax.random.split(k, 3)
        uniform.append(jax.random.uniform(k_sel, (cache.n_max,)))
        n_real = max(min(len(clouds[i][0]), n_points), 1)
        dup.append(jax.random.randint(k_dup, (n_points,), 0, n_real))
    draws = SampleDraws(uniform=torch.tensor(np.stack(uniform)),
                        dup_pos=torch.tensor(np.stack(dup), dtype=torch.int64))
    pts, labels = cache.assemble(torch.tensor(ids), draws)
    np.testing.assert_array_equal(pts.numpy(), ref_pts)
    np.testing.assert_array_equal(labels.numpy(), ref_labels)


def test_pipeline_selections_call_select_smallest(monkeypatch):
    """``subsample_order`` (the live path) and ``DeviceDatasetCache.
    assemble`` (the train batches) select through ``select_smallest``,
    which the card runs on B8."""
    calls = []

    def record(priority, n_out):
        calls.append((tuple(priority.shape), n_out))
        return select_kernels.select_smallest(priority, n_out)

    monkeypatch.setattr(pipeline, "select_smallest", record)
    gen = torch.Generator()
    gen.manual_seed(0)
    uniform = torch.rand((1, 5_000), generator=gen)
    z = torch.rand((1, 5_000), generator=gen)
    order, _ = pipeline.subsample_order(uniform, z, 1_000)
    assert calls == [((1, 5_000), 1_000)]
    assert order.shape == (1, 1_000)
    rng = np.random.RandomState(0)
    clouds = [(rng.rand(n, 3).astype(np.float32), np.zeros((n, 0)), np.zeros(n, np.uint8))
              for n in (900, 300)]
    cache = DeviceDatasetCache(clouds, 512, device="cpu")
    cache.sample_batch(torch.tensor([1, 0]), gen)
    assert calls[1:] == [((2, 900), 512)]


@pytest.mark.parametrize("bad", ["float64", "1-D", "3-D", "n_out 0", "n_out > N",
                                 "not contiguous", "requires grad", "meta device"])
def test_select_smallest_refuses(bad):
    x = torch.rand(2, 100)
    n_out = 10
    error = ValueError
    if bad == "float64":
        x, error = x.double(), TypeError
    elif bad == "1-D":
        x = x[0]
    elif bad == "3-D":
        x = x[None]
    elif bad == "n_out 0":
        n_out = 0
    elif bad == "n_out > N":
        n_out = 101
    elif bad == "not contiguous":
        x = torch.rand(100, 2).t()
    elif bad == "requires grad":
        x, error = x.requires_grad_(), RuntimeError
    elif bad == "meta device":
        x = x.to("meta")
    with pytest.raises(error):
        select_smallest(x, n_out)
