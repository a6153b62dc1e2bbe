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


# B8's launch plan (``select_kernels.select_plan``), a pure function of the
# shapes and the card's SM count (an H100 SXM has 132, the PCIe card 114)


def test_select_plan_stages_the_live_row_over_16_blocks():
    plan = select_kernels.select_plan(1, 786_432, 16_384, 132)
    assert (plan.cluster, plan.staged, plan.keys_shared) == (16, True, True)
    assert plan.scratch_bytes == 0
    # the slice a block stages: 49,152 priorities
    assert plan.smem_bytes >= 786_432 // 16 * 4


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_select_plan_spreads_a_train_row_over_8_blocks(b):
    """A train row of 20,000 priorities fits one block, but its passes run
    faster over 8 (a block for every 4,096 priorities)."""
    plan = select_kernels.select_plan(b, 20_000, 2_500, 132)
    assert plan.cluster == 8
    assert plan.staged and plan.keys_shared and plan.scratch_bytes == 0


@pytest.mark.parametrize("n_out,keys_shared", [(16_384, True), (1 << 21, False)])
def test_select_plan_streams_rows_past_the_staged_capacity(n_out, keys_shared):
    """A 2^21 row does not fit 16 blocks' shared memory: every pass re-reads
    it; with n_out == N the selected keys go to a global scratch too."""
    plan = select_kernels.select_plan(1, 1 << 21, n_out, 132)
    assert plan.cluster == select_kernels.MAX_CLUSTER and not plan.staged
    assert plan.keys_shared == keys_shared
    assert plan.scratch_bytes == (0 if keys_shared else 2 * n_out * 8)


@pytest.mark.parametrize("b,n,n_out", [
    (1, 786_432, 16_384), (4, 20_000, 2_500), (2, 20_000, 2_500), (1, 1, 1), (3, 4_097, 1),
    (2, 12_345, 12_345), (1, 262_144, 65_536), (1, 262_144, 262_144), (2, 70_001, 70_001),
    (8, 5_000, 700), (1, 1 << 21, 1 << 21), (1, 1 << 24, 1 << 24), (65_535, 100, 10),
    (70_000, 100, 10), (1, 4_095, 4_000),
])
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_select_plan_fits_the_card(b, n, n_out, sms):
    """No plan asks for more shared memory than a block may use or more than
    16 blocks a cluster; its sizes are the kernel's layout of them."""
    plan = select_kernels.select_plan(b, n, n_out, sms)
    assert plan.cluster in (1, 2, 4, 8, 16)
    assert plan.smem_bytes <= 232_448
    chunk = -(-(-(-n // plan.cluster)) // 4) * 4
    kpb = -(-n_out // plan.cluster)
    # csrc/select.cu's layout: 8,192 bytes of fixed state; the cluster's bin
    # sums, 3 passes of 2,048 / cluster words; the histogram (8 KB) or key
    # buffer A; the sort's 16 x 256 digit counts; the staged slice or key
    # buffer B
    keys = 8 * kpb if plan.keys_shared else 0
    stage = 4 * (chunk + 4) if plan.staged else 0
    red = 12 * 2048 // plan.cluster if plan.cluster > 1 else 0
    assert plan.smem_bytes == (8_192 + red + -(-max(keys, 8_192) // 16) * 16 + 16_384
                               + -(-max(stage, keys) // 16) * 16)
    if plan.staged:  # the block's slice, and a 16-byte alignment's room
        assert plan.smem_bytes >= 4 * (chunk + 4)
    if plan.keys_shared:  # two buffers of the block's keys
        assert plan.smem_bytes >= 2 * 8 * kpb
    else:
        assert plan.scratch_bytes == 2 * b * n_out * 8
    assert plan == select_kernels.select_plan(b, n, n_out, sms)


@pytest.mark.parametrize("max_cluster,row_block,b,n,n_out,expected", [
    (8, 4_096, 1, 786_432, 16_384, (8, False, True)),    # the live row no longer fits 8 blocks
    (4, 4_096, 1, 786_432, 16_384, (4, False, True)),
    (4, 4_096, 1, 1 << 21, 1 << 21, (4, False, False)),  # nor its keys 4 blocks' memory
    (16, 16_384, 4, 20_000, 2_500, (2, True, True)),     # a train row over 2 blocks
    (16, 16_384, 1, 786_432, 16_384, (16, True, True)),
])
def test_select_plan_under_other_bounds(max_cluster, row_block, b, n, n_out, expected):
    """``select_plan`` under other bounds than the package's (what
    ``benchmarks/launch_ab.py B8`` times): the first form that fits, the
    keys in a global scratch only at ``max_cluster`` blocks."""
    plan = select_kernels.select_plan(b, n, n_out, 132, max_cluster=max_cluster,
                                      row_block=row_block)
    assert (plan.cluster, plan.staged, plan.keys_shared) == expected
    assert plan.smem_bytes <= select_kernels.MAX_SMEM
