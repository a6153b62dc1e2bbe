"""The port's point-sharded train step and DP×SP grid on 4 gloo ranks on
the CPU (``parallel/collectives.py``, the ring backward of
``parallel/ring_knn.py``, ``SPBackend.constrain``'s inverse exchange,
``RandLANet`` in train mode with ``backend=SPBackend()``), against the JAX
package's ``point_sharded_model`` on a 4-device mesh and against the port's
one-rank step, at JAX's test settings (``tests/test_parallel.py``: 256
points, K 4, decimation 2, layers [4, 8, 16, 32], ``knn="naive"``).

Tolerances: the train step against JAX's, in float32, those of JAX's own
``test_train_step_parity`` (loss 1e-5 absolute / 1e-4 relative, running
statistics 1e-4 / 1e-3, gradients 5e-4 / 5e-3); in float64 against the
port's one-rank step, the loss within 1e-12 relative, every gradient within
1e-9 of its tensor's largest |g|, the running statistics within 1e-12 of
their tensor's largest value (the same float64 sums in other orders). The
ring backward against autograd through the one-rank gather: 1e-6 of the
largest value (float32 sums in another order). The grid forward: JAX's
``test_dp_sp_2d_mesh_forward_parity`` tolerance (5e-4 / 1e-3).

The workers are spawned once for the module; JAX's programs are jitted.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as flax_nn
from jax.sharding import Mesh

from recognizer3d_tpu.models.randlanet import RandLANet as JaxRandLANet
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.parallel import sp_model as jax_sp
from recognizer3d_tpu.parallel.ring_knn import point_sharded_mesh
from recognizer3d_tpu.training import losses as jax_losses
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distance
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.ops.knn import gather_neighbors, knn
from recognizer3d_tpu_torch.parallel import collectives, mesh, ring_knn, sp_model
from recognizer3d_tpu_torch.parallel.serving import SPServing
from recognizer3d_tpu_torch.training import data_parallel, losses
from tests import test_torch_port_rank_helpers as helpers

#: ``test_train_step_parity``'s dropout key
DROPOUT_KEY = jax.random.PRNGKey(7)
SETTINGS = dict(n_classes=2, n_points=256, n_features=0, n_neighbors=4, decimation=2,
                layer_sizes=[4, 8, 16, 32], knn="naive")


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(["cpu"] * 4) as p:
        yield p


# --- the collectives on four ranks -----------------------------------------------


def test_replicated_sum_and_to_ranks_on_four_ranks(pool):
    """``replicated_sum`` of each rank's block is the sum of the blocks on
    every rank, and its backward hands each rank the cotangent once (JAX's
    ``psum``: a replicated value's cotangent is already whole); ``to_ranks``
    is the identity whose backward sums the ranks' cotangents (JAX's
    ``pbroadcast``)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4, 3, 5))  # float64: exact sums
    ct = torch.from_numpy(rng.randn(1, 3, 5))
    out, (grad,), _ = helpers.vjp(pool, collectives.replicated_sum, x, cotangent=ct,
                                     axis=0, out_axis=3)
    np.testing.assert_allclose(out, x.sum(0, keepdim=True).numpy(), rtol=1e-15)
    np.testing.assert_array_equal(grad, np.broadcast_to(ct.numpy(), x.shape))
    ct4 = torch.from_numpy(rng.randn(4, 3, 5))
    out, (grad,), _ = helpers.vjp(pool, collectives.to_ranks, x, cotangent=ct4, axis=0)
    np.testing.assert_array_equal(out, x.numpy())
    np.testing.assert_allclose(grad, np.broadcast_to(ct4.sum(0, keepdim=True).numpy(), x.shape),
                               rtol=1e-15)
    sums = pool.run(helpers.map_rank, collectives.all_reduce_sum, (x,), {}, 0)
    for s in sums:  # the same bits on every rank
        np.testing.assert_array_equal(s, sums[0])


def test_a_replicated_loss_counts_once(pool):
    """The dice loss of a batch over 4 ranks (each one cloud) seeds its
    backward with 1 on every rank; the logits' gradient equals the
    one-process gradient of the whole batch's loss, not 4 times it."""
    rng = np.random.RandomState(1)
    logits = torch.from_numpy((2 * rng.randn(4, 2, 64)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 2, (4, 64)).astype(np.int64))
    dice = losses.get_loss("dice")
    x = logits.clone().requires_grad_(True)
    ref = dice(x, labels)
    ref.backward()
    got, (grad, _), _ = helpers.vjp(pool, dice, logits, labels, cotangent=torch.tensor(1.0),
                                       axis=0)
    assert float(got) == pytest.approx(float(ref.detach()), rel=1e-6)
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=0,
                               atol=1e-6 * float(x.grad.abs().max()))


# --- the ring backward ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 6])
def test_ring_knn_gather_backward(pool, k):
    """The rows' cotangents of ``ring_knn_gather`` (4 ranks) travel back to
    the ranks owning the rows: the table's gradient equals autograd's through
    the one-rank search and gather on the whole cloud."""
    rng = np.random.RandomState(2)
    support = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32))
    query = torch.from_numpy(rng.rand(2, 32, 3).astype(np.float32))
    table = torch.from_numpy(rng.randn(2, 64, 5).astype(np.float32))
    ct = torch.from_numpy(rng.randn(2, 32, k, 5).astype(np.float32))
    rows, (_, _, g_table, _), _ = helpers.vjp(pool, ring_knn.ring_knn_gather, support, query,
                                                 table, k, cotangent=ct, out_index=2)
    idx, _ = knn(support, query, k, "naive")
    t = table.clone().requires_grad_(True)
    ref = gather_neighbors(t, idx)
    ref.backward(ct)
    np.testing.assert_array_equal(rows, ref.detach().numpy())
    np.testing.assert_allclose(g_table, t.grad.numpy(), rtol=0,
                               atol=1e-6 * float(t.grad.abs().max()))


def test_ring_gather_backward(pool):
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(1, 40 * 4, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 40 * 4, (1, 24 * 4, 5)).astype(np.int32))
    ct = torch.from_numpy(rng.randn(1, 24 * 4, 5, 3).astype(np.float32))
    out, (g_feats, _), _ = helpers.vjp(pool, ring_knn.ring_gather, feats, idx, cotangent=ct)
    f = feats.clone().requires_grad_(True)
    ref = gather_neighbors(f, idx)
    ref.backward(ct)
    np.testing.assert_array_equal(out, ref.detach().numpy())
    np.testing.assert_allclose(g_feats, f.grad.numpy(), rtol=0,
                               atol=1e-6 * float(f.grad.abs().max()))


@pytest.mark.parametrize("n", [64, 32, 16, 4])
def test_constrain_backward(pool, n):
    """``SPBackend.constrain`` to the first ``n`` of 64 rows over 4 ranks:
    the forward is the prefix, and each received row's cotangent returns to
    its sender, the rows past the prefix getting zeros."""
    rng = np.random.RandomState(n)
    x = torch.from_numpy(rng.randn(2, 64, 3).astype(np.float32))
    ct = torch.from_numpy(rng.randn(2, n, 3).astype(np.float32))
    out, (grad, _), _ = helpers.vjp(pool, sp_model.SPBackend().constrain, x, n, cotangent=ct)
    np.testing.assert_array_equal(out, x[:, :n].numpy())
    expected = np.zeros_like(x.numpy())
    expected[:, :n] = ct.numpy()
    np.testing.assert_array_equal(grad, expected)


# --- the point-sharded train step -------------------------------------------------


def test_sp_train_forward_runs_inside_whole_batch(monkeypatch):
    """The point-sharded forward in train mode outside
    ``collectives.whole_batch()`` would take each rank's BatchNorm
    statistics alone: it refuses, before any exchange."""
    model = Model(RandLANetSettings(**dict(SETTINGS, n_points=64)), seed=0, device="cpu")
    monkeypatch.setitem(mesh._place, "world", 2)
    with pytest.raises(ValueError, match="whole_batch"):
        model.module.train()(torch.zeros(1, 32, 3), None, backend=sp_model.SPBackend())


def _recording_dropout(kept: list):
    """Make flax's ``Dropout`` draw its mask as it does (``make_rng`` of
    its collection, then ``bernoulli(1 − rate)``) and append it to
    ``kept``."""

    def intercept(next_fn, args, kwargs, context):
        module = context.module
        if isinstance(module, flax_nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            keep = jax.random.bernoulli(module.make_rng(module.rng_collection),
                                        1.0 - module.rate, x.shape)
            kept.append(np.asarray(keep))
            return jnp.where(keep, x / (1.0 - module.rate), jnp.zeros_like(x))
        return next_fn(*args, **kwargs)

    return intercept


@functools.lru_cache(maxsize=None)
def _case():
    """JAX's ``test_train_step_parity`` inputs: 2 clouds of 256 points, the
    permutation, seed-1 labels, the variables of a jitted init, and the keep
    mask flax's ``Dropout`` draws under its dropout key 7 (in the clouds'
    own order), read from one single-device train forward."""
    rng = np.random.RandomState(0)
    inputs = rng.rand(2, 256, 3).astype(np.float32)
    perm = rng.permutation(256).astype(np.int32)
    labels = np.random.RandomState(1).randint(0, 2, (2, 256)).astype(np.int32)
    single = JaxRandLANet(JaxSettings(**SETTINGS))
    variables = jax.device_get(jax.jit(single.init)(jax.random.PRNGKey(0), jnp.asarray(inputs),
                                                    jnp.asarray(perm)))
    kept = []
    with flax_nn.intercept_methods(_recording_dropout(kept)):
        single.apply(variables, jnp.asarray(inputs), jnp.asarray(perm), train=True,
                     rngs={"dropout": DROPOUT_KEY}, mutable=["batch_stats"])
    return variables, inputs, perm, labels, np.array(kept[0])


def test_sp_train_step_matches_jax_and_the_one_rank_step(pool):
    """The port's point-sharded train step over 4 ranks (each its block of
    the cloud permuted on the host, with the labels and the keep mask
    permuted alike; ``data_parallel.step(axis=1)``), the dice loss, against
    JAX's ``test_train_step_parity`` steps under flax's own dropout draw from
    key 7, whose mask the port is handed, from the same weights, batch and
    permutation: ``point_sharded_model``'s step on a 4-device mesh for the
    loss and the running statistics, and the single-device step that JAX's
    test holds it to, jitted, for the gradients. The two JAX steps' gradients
    lie 9.3 times the gradient tolerance apart, about as far as the jitted
    and the op-by-op runs of the same single-device step (8.9 times; JAX's
    test runs it op-by-op, and its point-sharded step sits within 0.026 of
    that run, on 8, 4 and 2 devices within 0.31): the spread of float32
    rounding between JAX's programs, with no near-tie in the searches, which
    no point-sharded setup escapes (``tests/test_torch_port_sp_oracle.py``,
    PERF.md §7). The port sits within 0.0018 of the jitted run. Then, in float64,
    the port's step over 4 ranks against its one-rank step on the unpermuted
    batch."""
    variables, inputs, perm, labels, kept = _case()
    jmesh = point_sharded_mesh(4)
    backend = jax_sp.SPBackend(jmesh)
    criterion = jax_losses.get_loss("dice")

    def jax_step(net):
        @jax.jit
        def run(v, x, y, p):
            def loss_fn(params):
                logits, upd = net.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                        p, train=True, rngs={"dropout": DROPOUT_KEY},
                                        mutable=["batch_stats"])
                return criterion(logits, y), upd["batch_stats"]

            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
            return loss, stats, grads

        return run

    args = (jnp.asarray(labels), jnp.asarray(perm))
    loss, stats, _ = jax.device_get(jax_step(
        jax_sp.point_sharded_model(JaxSettings(**SETTINGS), jmesh))(
        variables, backend.shard_inputs(jnp.asarray(inputs)), *args))
    _, _, grads = jax.device_get(jax_step(JaxRandLANet(JaxSettings(**SETTINGS)))(
        variables, jnp.asarray(inputs), *args))

    model = Model(RandLANetSettings(**SETTINGS), weights=from_flax_variables(variables),
                  device="cpu")
    p = torch.from_numpy(perm).long()
    permuted = (torch.from_numpy(inputs)[:, p], torch.from_numpy(labels).long()[:, p], None,
                torch.from_numpy(kept)[:, p])
    pool.run(data_parallel.adopt, "sp-step", data_parallel.payload(model, "dice"))
    got = pool.run(data_parallel.step, "sp-step", *permuted, axis=1)
    got_loss, got_grads, got_stats = got[0][:3]
    assert got_loss == pytest.approx(float(loss), abs=1e-5, rel=1e-4)
    assert all(r[0] == got_loss for r in got)
    assert all(torch.equal(r[1][k], got_grads[k]) for r in got for k in got_grads)
    for name, ref in from_flax_variables({"batch_stats": stats}).items():
        np.testing.assert_allclose(got_stats[name].numpy(), ref.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    for name, ref in from_flax_variables({"params": grads}).items():
        np.testing.assert_allclose(got_grads[name].numpy(), ref.numpy(), atol=5e-4, rtol=5e-3,
                                   err_msg=name)

    spec64 = data_parallel.payload(model, "dice", dtype=torch.float64)
    pool.run(data_parallel.adopt, "sp-step", spec64)
    four = pool.run(data_parallel.step, "sp-step", *permuted, axis=1)[0]
    pool.run(mesh.forget, "sp-step")
    with mesh.RankPool(["cpu"]) as single:
        single.run(data_parallel.adopt, "sp-step", spec64)
        one = single.run(data_parallel.step, "sp-step", torch.from_numpy(inputs),
                         torch.from_numpy(labels).long(), p, torch.from_numpy(kept))[0]
        single.run(mesh.forget, "sp-step")
    assert four[0] == pytest.approx(one[0], rel=1e-12)
    assert grad_distance(four[1], one[1])[0] < 1e-9
    for name, ref in one[2].items():
        assert float((four[2][name] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


# --- the DP×SP grid ---------------------------------------------------------------------


def test_dp_sp_grid_forward_matches_jax(pool):
    """JAX's ``test_dp_sp_2d_mesh_forward_parity``: the batch of 2 clouds of
    128 points over 2 rows and each cloud's points over the 2 ranks of its
    row (``SPBackend(batch_shards=2)``), eval forward, against JAX's
    ``point_sharded_model`` on its ("batch", "points") mesh of 2 × 2 and
    against the one-device forward; the same through
    ``SPServing.confidences_permuted``."""
    s = dict(SETTINGS, n_points=128)
    rng = np.random.RandomState(3)
    inputs = rng.rand(2, 128, 3).astype(np.float32)
    perm = rng.permutation(128).astype(np.int32)
    single = JaxRandLANet(JaxSettings(**s))
    variables = jax.device_get(jax.jit(single.init)(jax.random.PRNGKey(0), jnp.asarray(inputs),
                                                    jnp.asarray(perm)))
    grid = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), axis_names=("batch", "points"))
    sharded = jax_sp.point_sharded_model(JaxSettings(**s), grid, batch_axis="batch")
    backend = jax_sp.SPBackend(grid, batch_axis="batch")
    ref = np.asarray(jax.jit(lambda v, x, p: sharded.apply(v, x, p, train=False))(
        variables, backend.shard_inputs(jnp.asarray(inputs)), jnp.asarray(perm)))
    ref_single = np.asarray(jax.jit(lambda v, x, p: single.apply(v, x, p, train=False))(
        variables, jnp.asarray(inputs), jnp.asarray(perm)))
    np.testing.assert_allclose(ref, ref_single, atol=5e-4, rtol=1e-3)

    model = Model(RandLANetSettings(**s), weights=from_flax_variables(variables), device="cpu")
    port = model.module
    x_perm = torch.from_numpy(inputs[:, perm])
    got_perm = helpers.grid_map(pool, port, x_perm, None,
                                backend=sp_model.SPBackend(batch_shards=2), out_axis=2,
                                batch_shards=2)
    got = np.empty_like(got_perm)
    got[..., perm] = got_perm
    assert got.shape == (2, 2, 128)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    blocks = pool.run(sp_model.SPBackend(batch_shards=2).shard_inputs, torch.from_numpy(inputs))
    assert [tuple(b.shape) for b in blocks] == [(1, 64, 3)] * 4
    assert torch.equal(torch.cat([torch.cat(blocks[:2], 1), torch.cat(blocks[2:], 1)], 0),
                       torch.from_numpy(inputs))
    with SPServing(model, pool) as server:
        conf = server.confidences_permuted(inputs[:, perm], batch_shards=2)
    ref_conf = np.asarray(jax.nn.softmax(jnp.asarray(ref), axis=-2))[..., perm]
    np.testing.assert_allclose(conf, ref_conf, atol=5e-4, rtol=1e-3)
