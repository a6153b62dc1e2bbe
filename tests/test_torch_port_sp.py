"""The port's point-sharded model (``recognizer3d_tpu_torch/parallel/``:
``sp_model.py``, ``sp_lfa.py``, ``SPServing``) at 4 gloo ranks on the CPU
against the JAX package's on a 4-device ``point_sharded_mesh``, at JAX's
test settings (``tests/test_parallel.py``: 256 points, K 4, decimation 2,
layers [4, 8, 16, 32], ``knn="naive"``), with the same weights through the
weight bridge and the same seeded inputs.

Tolerances: the port's ring searches compute squared distances by direct
differences, JAX's by the expanded form, which moves the LocSE distances by
float32 rounding; on these seeded clouds both pick the same neighbours, and
the outputs agree to 1e-5 absolute and 1e-4 relative (the SP LFA block,
logits and confidences of order one), four to fifty times inside JAX's own
SP-against-single-device tolerances (atol 2e-5 / rtol 1e-4 for a block,
5e-4 / 1e-3 for the model). The port's point-sharded forward is held to the
port's own single-device forward to 1e-5 absolute: the same distances, a
different order of summation in the merge-free parts.

The workers are spawned once for the module.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.models.randlanet import LocalFeatureAggregation as JaxLFA
from recognizer3d_tpu.models.randlanet import RandLANet as JaxRandLANet
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.parallel import serving as jax_serving
from recognizer3d_tpu.parallel import sp_model as jax_sp
from recognizer3d_tpu.parallel.ring_knn import point_sharded_mesh
from recognizer3d_tpu.parallel.sp_lfa import sp_lfa_eval as jax_sp_lfa_eval
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.models.randlanet import LocalFeatureAggregation, RandLANet
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.parallel import mesh, sp_lfa, sp_model
from recognizer3d_tpu_torch.parallel.serving import SPServing

SETTINGS = dict(n_classes=2, n_points=256, n_features=0, n_neighbors=4, decimation=2,
                layer_sizes=[4, 8, 16, 32], knn="naive")
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(["cpu"] * 4) as p:
        yield p


@pytest.fixture(scope="module")
def jax_mesh():
    return point_sharded_mesh(4)


def _with_stats(variables):
    """Non-trivial BatchNorm running statistics, so that eval mode matters."""
    stats = jax.tree.map(
        lambda v: v + 0.05 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape) / v.size,
        variables["batch_stats"],
    )
    return {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("n,shards,n_target", [(300, 8, 0), (300, 4, 4096), (384, 8, 0),
                                               (1000, 3, 1500), (5, 2, 0)])
def test_sharding_multiple_and_padding_match_jax(n, shards, n_target):
    s = RandLANetSettings(**SETTINGS)
    js = JaxSettings(**SETTINGS)
    assert sp_model.sharding_multiple(s, shards) == jax_sp.sharding_multiple(js, shards)
    cloud = np.random.RandomState(n).rand(n, 3).astype(np.float32)
    got, n_got = sp_model.pad_for_sharding(cloud, s, shards, n_target,
                                           rng=np.random.RandomState(7))
    ref, n_ref = jax_sp.pad_for_sharding(cloud, js, shards, n_target,
                                         rng=np.random.RandomState(7))
    assert n_got == n_ref == n
    np.testing.assert_array_equal(got, ref)
    assert got.shape[0] % sp_model.sharding_multiple(s, shards) == 0


def test_check_level_sizes_refuses_as_jax(monkeypatch, jax_mesh):
    """Levels 80, 40, 20, 10, 5 over 4 ranks: JAX's backend and the port's
    refuse the same sizes with the same message."""
    levels = [80, 40, 20, 10, 5]
    with pytest.raises(ValueError) as ref:
        jax_sp.SPBackend(jax_mesh).check_level_sizes(levels)
    monkeypatch.setitem(mesh._place, "world", 4)
    with pytest.raises(ValueError) as got:
        sp_model.SPBackend().check_level_sizes(levels)
    assert str(got.value) == str(ref.value)
    sp_model.SPBackend().check_level_sizes([80, 40, 20])


def test_sp_lfa_block_matches_jax(pool, jax_mesh):
    rng = np.random.RandomState(3)
    xyz = rng.rand(1, 256, 3).astype(np.float32)
    feats = rng.randn(1, 256, 8).astype(np.float32)
    block = JaxLFA(16, 8, "naive")
    variables = _with_stats(jax.jit(block.init)(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                                jnp.asarray(feats)))
    ref = jax_sp_lfa_eval(variables, jnp.asarray(xyz), jnp.asarray(feats), 8, jax_mesh)
    port = LocalFeatureAggregation(8, 16, 8, "naive")
    port.load_state_dict(from_flax_variables(jax.device_get(variables)))
    port.eval()
    got = mesh.shard_map(pool, sp_lfa.sp_lfa_eval, port, torch.from_numpy(xyz),
                         torch.from_numpy(feats))
    assert got.shape == (1, 256, 32)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    port.train()
    with pytest.raises(NotImplementedError, match="A9b"):
        sp_lfa.sp_lfa_eval(port, torch.from_numpy(xyz), torch.from_numpy(feats))


@pytest.fixture(scope="module")
def model_pair():
    """JAX's RandLANet variables (a jitted init, non-trivial statistics) and
    the port's twin in eval mode, with seeded inputs and permutation."""
    rng = np.random.RandomState(0)
    inputs = rng.rand(2, 256, 3).astype(np.float32)
    perm = rng.permutation(256).astype(np.int32)
    single = JaxRandLANet(JaxSettings(**SETTINGS))
    variables = _with_stats(jax.jit(single.init)(jax.random.PRNGKey(0), jnp.asarray(inputs),
                                                 jnp.asarray(perm)))
    port = RandLANet(RandLANetSettings(**SETTINGS))
    port.load_state_dict(from_flax_variables(jax.device_get(variables)))
    port.eval()
    return variables, port, inputs, perm


def test_sp_forward_matches_jax_and_the_single_device_forward(pool, jax_mesh, model_pair):
    """The port's point-sharded forward takes the cloud permuted on the host
    and returns its logits in that order; un-permuted, they match JAX's
    ``point_sharded_model`` and the port's single-device forward."""
    variables, port, inputs, perm = model_pair
    sharded = jax_sp.point_sharded_model(JaxSettings(**SETTINGS), jax_mesh)
    backend = jax_sp.SPBackend(jax_mesh)
    ref = np.asarray(jax.jit(lambda v, x, p: sharded.apply(v, x, p, train=False))(
        variables, backend.shard_inputs(jnp.asarray(inputs)), jnp.asarray(perm)))
    got_perm = mesh.shard_map(pool, port, torch.from_numpy(inputs[:, perm]), None,
                              backend=sp_model.SPBackend(), out_axis=2)
    got = np.empty_like(got_perm)
    got[..., perm] = got_perm
    assert got.shape == (2, 2, 256)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    with torch.inference_mode():
        single = port(torch.from_numpy(inputs), torch.from_numpy(perm)).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=ATOL)
    blocks = pool.run(sp_model.SPBackend().shard_inputs, torch.from_numpy(inputs))
    assert torch.equal(torch.cat(blocks, dim=1), torch.from_numpy(inputs))


def test_sp_forward_is_eval_only(model_pair):
    _, port, inputs, _ = model_pair
    port.train()
    try:
        with pytest.raises(NotImplementedError, match="A9b"):
            port(torch.from_numpy(inputs), None, backend=sp_model.SPBackend())
    finally:
        port.eval()


def test_sp_serving_matches_jax(pool, model_pair):
    """``SPServing`` on a 300-point cloud (padded to its 4,096-point bucket
    with duplicates, then permuted, from the server's ``RandomState(0)``)
    against JAX's ``SPServing(model, 4)``, the same weights through the
    bridge; twice, so the second call's draws follow the first's. JAX's
    server reads only the model's settings and variables, so it gets those
    (a JAX ``Model`` would spend half a minute compiling its own programs)."""
    variables = model_pair[0]
    jax_model = SimpleNamespace(settings=JaxSettings(**SETTINGS), variables=variables)
    port_model = Model(RandLANetSettings(**SETTINGS),
                       weights=from_flax_variables(jax.device_get(variables)), device="cpu")
    rng = np.random.RandomState(1)
    clouds = [rng.rand(300, 3).astype(np.float32), rng.rand(1, 300, 3).astype(np.float32)]
    ref_server = jax_serving.SPServing(jax_model, 4)
    with SPServing(port_model, pool) as server:
        assert server.n_shards == 4
        for cloud in clouds:
            got = server.predict(cloud)
            ref = ref_server.predict(cloud)
            assert got.shape == ref.shape == cloud.shape[:-2] + (2, 300)
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        mask = server.predict_mask(clouds[0], 0.5)
    assert mask.dtype == np.bool_ and mask.shape == (300,)
    # the server dropped its model from every rank when it closed
    assert pool.run(mesh.local) == [{}] * 4
