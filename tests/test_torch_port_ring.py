"""The port's ring exchanges (``recognizer3d_tpu_torch/parallel/ring_knn.py``)
at 4 gloo ranks on the CPU against the JAX package's on a 4-device
``point_sharded_mesh``, on the same seeded inputs.

The JAX ring step computes distances in the expanded form ‖q‖² + ‖s‖² −
2q·s, the port's by direct differences: on points in the unit cube the two
differ by a few float32 ulps of ‖q‖² + ‖s‖² (≤ 3), so squared distances are
held to 1e-5 absolute, and indices and rows equal on these distinct seeded
points (no two candidates of a query lie within that rounding of each
other). One rank (no pool: every exchange is the identity) is the
single-process exact search, bit for bit.

The workers are spawned once for the module (about 3 s here).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from recognizer3d_tpu.parallel import ring_knn as jax_ring
from recognizer3d_tpu_torch.ops.knn import gather_neighbors, knn
from recognizer3d_tpu_torch.parallel import mesh, ring_knn

D2_ATOL = 1e-5


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(["cpu"] * 4) as p:
        yield p


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_ring.point_sharded_mesh(4)


def _clouds(seed, b, n, m, c=None):
    rng = np.random.RandomState(seed)
    out = [rng.rand(b, n, 3).astype(np.float32), rng.rand(b, m, 3).astype(np.float32)]
    if c is not None:
        out.append(rng.randn(b, n, c).astype(np.float32))
    return out


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("k", [8, 1])
def test_ring_knn_matches_jax(pool, jax_mesh, k):
    support, query = _clouds(0, 2, 256, 256)
    idx, d2 = mesh.shard_map(pool, ring_knn.ring_knn, *_torch(support, query), k)
    ref_i, ref_d = jax_ring.ring_knn(jnp.asarray(support), jnp.asarray(query), k, jax_mesh)
    assert idx.dtype == np.int32 and idx.shape == d2.shape == (2, 256, k)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_allclose(d2, np.asarray(ref_d), rtol=0, atol=D2_ATOL)


def test_ring_knn_gather_matches_jax(pool, jax_mesh):
    support, query, table = _clouds(1, 2, 256, 256, 5)
    idx, d2, rows = mesh.shard_map(pool, ring_knn.ring_knn_gather,
                                   *_torch(support, query, table), 8)
    ref_i, ref_d, ref_rows = jax_ring.ring_knn_gather(
        jnp.asarray(support), jnp.asarray(query), jnp.asarray(table), 8, jax_mesh)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_allclose(d2, np.asarray(ref_d), rtol=0, atol=D2_ATOL)
    np.testing.assert_array_equal(rows, np.asarray(ref_rows))
    np.testing.assert_array_equal(rows, table[np.arange(2)[:, None, None], idx])


def test_ring_gather_matches_jax(pool, jax_mesh):
    rng = np.random.RandomState(2)
    table = rng.randn(2, 256, 6).astype(np.float32)
    idx = rng.randint(0, 256, (2, 256, 5)).astype(np.int32)
    rows = mesh.shard_map(pool, ring_knn.ring_gather, *_torch(table, idx))
    ref = jax_ring.ring_gather(jnp.asarray(table), jnp.asarray(idx), jax_mesh)
    np.testing.assert_array_equal(rows, np.asarray(ref))
    np.testing.assert_array_equal(rows, table[np.arange(2)[:, None, None], idx])


def test_k_larger_than_local_shard(pool, jax_mesh):
    """k = 20 > 16 points a rank: each step adds fewer than k candidates
    (JAX's test_k_larger_than_local_shard)."""
    support, query = _clouds(3, 1, 64, 64)
    idx, d2 = mesh.shard_map(pool, ring_knn.ring_knn, *_torch(support, query), 20)
    ref_i, ref_d = jax_ring.ring_knn(jnp.asarray(support), jnp.asarray(query), 20, jax_mesh)
    np.testing.assert_array_equal(idx, np.asarray(ref_i))
    np.testing.assert_allclose(d2, np.asarray(ref_d), rtol=0, atol=D2_ATOL)


def test_self_knn_finds_each_point_first(pool):
    cloud = _clouds(4, 1, 128, 1)[0]
    idx, d2 = mesh.shard_map(pool, ring_knn.ring_knn, *_torch(cloud, cloud), 4)
    np.testing.assert_array_equal(idx[0, :, 0], np.arange(128))
    np.testing.assert_array_equal(d2[0, :, 0], 0.0)


def test_one_rank_is_the_single_process_search():
    support, query, table = _torch(*_clouds(5, 2, 96, 80, 7))
    assert mesh.world() == 1
    ref_i, ref_d = knn(support, query, 8, "naive")
    idx, d2 = ring_knn.ring_knn(support, query, 8)
    assert torch.equal(idx, ref_i) and torch.equal(d2, ref_d)
    idx, d2, rows = ring_knn.ring_knn_gather(support, query, table, 8)
    assert torch.equal(idx, ref_i) and torch.equal(d2, ref_d)
    assert torch.equal(rows, gather_neighbors(table, ref_i))
    assert torch.equal(ring_knn.ring_gather(table, ref_i), gather_neighbors(table, ref_i))
