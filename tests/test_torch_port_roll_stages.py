"""The port's bitonic roll-stage kernel (B7) against the JAX package's
Pallas kernel ``benchmarks/bench_roll_stages.py::_kernel``, on the CPU.

The Pallas kernel runs in interpret mode through ``pl.pallas_call`` as the
benchmark builds it; the port's wrapper runs its plain version on CPU
tensors. The two must agree bit for bit, ties and the kernel's payload
duplication on equal values included.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from benchmarks import bench_roll_stages as jax_bench
from recognizer3d_tpu_torch.benchmarks import bench_roll_stages
from recognizer3d_tpu_torch.ops import _build
from recognizer3d_tpu_torch.ops.bitonic_kernels import (
    roll_stages,
    roll_stages_plain,
    stage_distances,
)


def _pallas(x: np.ndarray, stages: int) -> np.ndarray:
    n_blocks, qb, ts = x.shape
    spec = pl.BlockSpec((1, qb, ts), lambda i: (i, 0, 0))
    f = pl.pallas_call(
        functools.partial(jax_bench._kernel, stages=stages, ts=ts),
        grid=(n_blocks,),
        in_specs=[spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("stages", [1, 5, 15, 45])
def test_plain_matches_pallas_kernel(stages, tied):
    """(2, 8, 128) float32, uniform in [0, 1) or rounded to eighths (heavy
    ties): bit-exact."""
    x = np.random.RandomState(stages).rand(2, 8, 128).astype(np.float32)
    if tied:
        x = np.round(x * 8) / 8
    out = roll_stages(torch.from_numpy(x), stages)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_array_equal(out.numpy(), _pallas(x, stages))


def test_equal_values_duplicate_the_min_lanes_payload():
    """On v == partner both lanes keep the min-lane's payload, as the
    Pallas kernel does: one stage at d = 1 over equal values leaves the
    even lane's payload in both lanes of a pair below lane 32 (keep-min on
    the even lane) and the odd lane's above it."""
    x = np.zeros((1, 2, 64), np.float32)
    out = roll_stages_plain(torch.from_numpy(x), 1).numpy()
    lane = np.arange(64)
    payload = np.where(lane < 32, lane & ~1, lane | 1).astype(np.float32)
    np.testing.assert_array_equal(out[0, 0], payload * np.float32(1e-12))
    np.testing.assert_array_equal(out, _pallas(x, 1))


def test_stage_distances_follow_the_kernel():
    assert stage_distances(0) == []
    assert stage_distances(1) == [1]
    assert stage_distances(3) == [1, 2, 4]
    assert stage_distances(8) == [1, 2, 4, 8, 16, 32, 1, 2]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    _build.reset_launches()
    x = torch.zeros(3, 64)
    assert torch.equal(roll_stages(x, 0), roll_stages_plain(x, 0))
    with pytest.raises(ValueError, match="multiple of 64"):
        roll_stages(torch.zeros(2, 96), 3)
    with pytest.raises(ValueError, match="multiple of 64"):
        roll_stages(torch.zeros(2, 2048), 3)
    with pytest.raises(TypeError, match="float32"):
        roll_stages(torch.zeros(2, 64, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="stages"):
        roll_stages(x, -1)
    assert _build.LAUNCHES == {}  # CPU tensors launch nothing


def test_benchmark_table_arithmetic(monkeypatch):
    """The entry point's table on fixed times (seconds per call = 1 ms +
    0.1 ms a stage): total ms, µs per block, and the marginal µs per stage
    and block over the 1-stage run."""
    calls = []

    def fake_run(stages, n_blocks, **kwargs):
        calls.append((stages, n_blocks, kwargs))
        return 1e-3 + 1e-4 * stages

    monkeypatch.setattr(bench_roll_stages, "run", fake_run)
    rows = bench_roll_stages.table(n_blocks=100, iters=3)
    assert calls[0] == (1, 100, {"iters": 3})
    assert [c[0] for c in calls[1:]] == list(bench_roll_stages.STAGES)
    for stages, total_ms, per_block, per_stage in rows:
        dt = 1e-3 + 1e-4 * stages
        np.testing.assert_allclose(total_ms, dt * 1e3)
        np.testing.assert_allclose(per_block, dt / 100 * 1e6)
        np.testing.assert_allclose(per_stage, 0.0 if stages == 1 else 1.0, atol=1e-9)


def test_benchmark_runs_on_the_card_only(monkeypatch):
    """Without CUDA the entry point raises instead of timing the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_roll_stages.run(1, n_blocks=1, qb=1, ts=64, iters=1)
