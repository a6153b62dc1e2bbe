"""Data-parallel training in the port (``training/data_parallel.py``,
``parallel/collectives.py``, whole-batch ``BatchNorm``, losses and metrics)
on 2 gloo ranks on the CPU, against the JAX package on the whole batch or on
a 2-device ``data_parallel_mesh``, and against the port's one-rank run.

The JAX oracles are jitted. The module's pool of 2 ranks is spawned once,
after the first test, which goes through ``TrainingSettings(
data_parallel_devices=2)`` alone: the trainer then starts (and closes) its
own pool, and a process runs one pool at a time.

Tolerances, each with its reason:

- ``Model.train`` over 2 ranks against 1: JAX's own envelope
  (``tests/test_parallel.py::test_dp_epoch_scan_matches_single_device``):
  the first step's loss within 1e-5 relative; after Adam's first step, the
  95% quantile of |Δparam| below 1e-4, none beyond 2.1·lr (a sign flip of
  a gradient near 0), fewer than 2% beyond 1e-3.
- one train step over 2 ranks against JAX's step over a 2-device mesh, in
  float32: ``test_train_step_parity``'s tolerances (loss 1e-5 absolute /
  1e-4 relative, running statistics 1e-4 / 1e-3, gradients 5e-4 / 5e-3);
  in float64 against the port's one-rank step: the loss within 1e-12
  relative, every gradient within 1e-9 of its tensor's largest |g|, the
  running statistics within 1e-12 of their tensor's largest value (two
  summation orders of the same float64 sums).
- BatchNorm over 2 ranks against flax's on the whole batch: the bounds of
  the one-rank tests (``test_torch_port_train.py``,
  ``test_torch_port_train_bf16.py``), κ = max E[x²]/var; gradients 1e-5 of
  their largest value in float32; in bfloat16 the output equal to the
  port's one-rank output bit for bit (the float64 sums round to the same
  float32 statistics) and the gradients within one bfloat16 ulp of the
  largest value of the port's one-rank gradients.
- the losses and their gradients over 2 ranks against JAX's on the whole
  batch: 1e-6 relative (float32 sums in two orders).
"""

import functools
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as flax_nn

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.parallel.mesh import data_parallel_mesh, shard_batch_fn
from recognizer3d_tpu.training import losses as jax_losses
from recognizer3d_tpu.training import metrics as jax_metrics
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distance
from recognizer3d_tpu_torch.models.randlanet import BatchNorm
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.parallel import collectives, mesh
from recognizer3d_tpu_torch.training import data_parallel, losses, metrics
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from tests import test_torch_port_rank_helpers as helpers

TINY = dict(n_classes=2, n_points=64, n_features=0, n_neighbors=4, decimation=2,
            layer_sizes=[4, 8, 16, 32], knn="naive")
NAMES = ["bg", "fg"]
LOSSES = ["cross_entropy", "focal", "dice", "tversky", "focal_tversky"]
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _clouds(seed, sizes, annotated=5):
    """Clouds of ``sizes`` points, 0.1·randn, ``annotated`` points labelled 1
    (JAX's ``TestDataParallelEpochFusion`` data)."""
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        cloud = rng.randn(n, 3).astype(np.float32) * 0.1
        labels = np.zeros(n, dtype=np.uint8)
        labels[rng.choice(n, annotated, replace=False)] = 1
        out.append((cloud, np.zeros((n, 0), np.float32), labels))
    return out


def _train(train, val, settings, pool=None, seed=123):
    """``Model.train`` of the seed-0 tiny model on the CPU: (trainer, the
    initial and the trained parameters by name)."""
    model = Model(RandLANetSettings(**TINY), seed=0, device="cpu")
    init = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    np.random.seed(seed)
    trainer = model.train(train, val, settings, class_names=NAMES, pool=pool)
    return trainer, init, {n: p.detach().clone() for n, p in model.module.named_parameters()}


def test_model_train_over_two_ranks_matches_one_rank():
    """JAX's envelope test, transplanted: 2 training clouds, batch 2, one
    epoch (one step) on the device pipeline, ``data_parallel_devices`` 2
    (the trainer starts its own 2 CPU ranks) against 1, under one numpy
    seed: the same batch, permutation and dropout mask, so the same loss,
    and parameters after Adam's first step inside JAX's envelope. The two
    ranks end bit-identical (the trainer checks it: ``rank_digests``)."""
    data = _clouds(0, [150 + 17 * i for i in range(3)])
    runs = {}
    for n in (1, 2):
        settings = TrainingSettings(epochs=1, batch_size=2, early_stopping=False,
                                    device_pipeline=True, data_parallel_devices=n)
        runs[n] = _train(data[:2], data[2:], settings)
    (one, init, single), (two, _, dp) = runs[1], runs[2]
    assert one.history[0]["steps"] == two.history[0]["steps"] == 1
    assert one.rank_digests == [] and len(two.rank_digests) == 2
    assert len(set(two.rank_digests)) == 1
    loss1, loss2 = one.history[0]["step_losses"][0], two.history[0]["step_losses"][0]
    assert np.isfinite(loss1) and loss2 == pytest.approx(loss1, rel=1e-5)
    diffs = np.concatenate([(dp[n] - single[n]).abs().numpy().ravel() for n in single])
    lr = 1e-2
    assert np.quantile(diffs, 0.95) < 1e-4, np.quantile(diffs, 0.95)
    assert diffs.max() < 2 * lr * 1.05, diffs.max()
    assert (diffs > 1e-3).mean() < 0.02, (diffs > 1e-3).mean()
    assert any(not torch.equal(init[n], single[n]) for n in init)


@pytest.fixture(scope="module")
def pool():
    with mesh.RankPool(["cpu"] * 2) as p:
        yield p


def test_gcd_clamp_trains_unsharded(pool, caplog):
    """Batch 3 over 2 ranks: gcd(2, 3) = 1, so the run trains on one device
    with JAX's warning, and the parameters move (JAX's
    ``test_ragged_batch_size_still_trains``)."""
    data = _clouds(1, [150] * 4)
    settings = TrainingSettings(epochs=1, batch_size=3, early_stopping=False,
                                device_pipeline=True, data_parallel_devices=2)
    with caplog.at_level(logging.WARNING, logger="trainer"):
        trainer, init, trained = _train(data[:3], data[3:], settings, pool=pool)
    assert "running without data-parallel sharding" in caplog.text
    assert trainer.rank_digests == [] and trainer.history[0]["steps"] == 1
    assert np.isfinite(trainer.history[0]["metrics"]["loss"])
    assert any(not torch.equal(init[n], trained[n]) for n in init)


@pytest.mark.parametrize("device_pipeline", [False, True])
def test_ragged_batches_are_dropped(pool, device_pipeline):
    """5 training clouds at batch 2 over 2 ranks: the host loader's ragged
    last batch, or the device pipeline's remainder, is dropped (2 steps, as
    JAX's mesh drops them), and the first step's loss is the one-rank run's
    (the host loader's batches drawn on rank 0 and scattered)."""
    data = _clouds(2, [100 + 10 * i for i in range(6)])
    settings = TrainingSettings(epochs=1, batch_size=2, early_stopping=False,
                                device_pipeline=device_pipeline)
    one, _, _ = _train(data[:5], data[5:], settings)
    two, _, _ = _train(data[:5], data[5:], settings, pool=pool)
    assert one.history[0]["steps"] == 3 and two.history[0]["steps"] == 2
    assert len(set(two.rank_digests)) == 1
    assert two.history[0]["step_losses"][0] == pytest.approx(
        one.history[0]["step_losses"][0], rel=1e-5)
    # the pool is the caller's: the trainer dropped its replicas, the pool runs on
    assert not pool.closed and pool.run(mesh.local) == [{}, {}]


# --- the collectives on one rank ---------------------------------------------------


def test_collectives_are_the_identity_on_one_rank():
    x = torch.randn(3, 4, requires_grad=True)
    assert collectives.all_reduce_sum(x) is x
    assert collectives.replicated_sum(x) is x and collectives.to_ranks(x) is x
    y, z = collectives.replicated_sum(x, 2 * x)
    assert y is x
    x.grad = torch.ones_like(x)
    collectives.all_reduce_grads([torch.nn.Parameter(x.detach())])
    with mesh.RankPool(["cpu"]) as one:
            out, grads, _ = helpers.vjp(one, collectives.replicated_sum, x.detach(),
                                    cotangent=torch.ones(3, 4), axis=0)
    np.testing.assert_array_equal(out, x.detach().numpy())
    np.testing.assert_array_equal(grads[0], np.ones((3, 4)))


def test_whole_batch_is_the_callers_choice(pool):
    """Inside a group the layers reduce over the ranks only within
    ``collectives.whole_batch()``: outside it (the default) ``batch_ranks``
    is 1 and a train-mode BatchNorm on each rank takes its own block's
    statistics, as on one device; within it, the whole batch's."""
    assert pool.run(collectives.batch_ranks) == [1, 1]
    assert pool.run(helpers.map_rank, collectives.batch_ranks, (), {}) == [2, 2]
    x, _, params, stats = _bn_case((4, 50, 8), 2)
    local = pool.run(mesh.shard_map_rank, _port_bn(params, stats), (torch.from_numpy(x),), {},
                     0)
    whole = pool.run(helpers.map_rank, _port_bn(params, stats), (torch.from_numpy(x),), {}, 0)
    for r, block in enumerate(torch.from_numpy(x).chunk(2)):
        with torch.inference_mode():
            own = _port_bn(params, stats)(block).numpy()
        np.testing.assert_array_equal(local[r], own)
        assert np.abs(whole[r] - own).max() > 1e-3


# --- whole-batch BatchNorm -------------------------------------------------------


def _bn_case(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) + 5.0).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    params = dict(scale=rng.rand(c).astype(np.float32) + 0.5, bias=rng.randn(c).astype(np.float32))
    stats = dict(mean=rng.randn(c).astype(np.float32), var=rng.rand(c).astype(np.float32) + 0.5)
    return x, ct, params, stats


def _port_bn(params, stats):
    bn = BatchNorm(params["scale"].shape[0])
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    bn.train()
    return bn


def _flax_bn(params, stats, x, ct, dtype=jnp.float32):
    """flax's train-mode BatchNorm on the whole batch, jitted: (output,
    updated statistics, gradients of (params, x) for the cotangent)."""
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.01, epsilon=1e-6, dtype=dtype)

    def run(p, xx, c):
        def apply(pp, x2):
            return bn.apply({"params": pp, "batch_stats": stats}, x2, mutable=["batch_stats"])

        y, upd = apply(p, xx)
        _, vjp = jax.vjp(lambda pp, x2: apply(pp, x2)[0], p, xx)
        return y, upd, vjp(c.astype(y.dtype))

    return jax.device_get(jax.jit(run)(params, x, ct))


@pytest.mark.parametrize("shape", [(4, 300, 8), (2, 100, 16, 8)])
def test_whole_batch_batchnorm_matches_flax_float32(pool, shape):
    """Train-mode BatchNorm over 2 ranks (each its half of the batch) against
    flax's on the whole batch: output, the input's, scale's and bias's
    gradients for one cotangent, and the running statistics."""
    x, ct, params, stats = _bn_case(shape, 0)
    y_ref, upd, (g_params, g_x) = _flax_bn(params, stats, jnp.asarray(x), jnp.asarray(ct))
    y, (gx,), module = helpers.vjp(pool, _port_bn(params, stats), torch.from_numpy(x),
                                      cotangent=torch.from_numpy(ct), axis=0)
    x64 = x.reshape(-1, x.shape[-1]).astype(np.float64)
    kappa = ((x64 * x64).mean(0) / x64.var(0)).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-6 * kappa * np.abs(y_ref).max())
    np.testing.assert_allclose(module["buffers"]["running_mean"], upd["batch_stats"]["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(module["buffers"]["running_var"], upd["batch_stats"]["var"],
                               rtol=1e-6 * kappa)
    for got, ref in ((gx, g_x), (module["grads"]["weight"], g_params["scale"]),
                     (module["grads"]["bias"], g_params["bias"])):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _bf16_ulp(a):
    """One bfloat16 ulp of each |a| (2^(⌊log2 |a|⌋ − 7))."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


def test_whole_batch_batchnorm_bfloat16(pool):
    """A bfloat16 input over 2 ranks: the statistics' float64 sums are
    summed over the ranks in float64, so the output is the port's one-rank
    output bit for bit, and so within flax's ``BatchNorm(dtype=bfloat16)``
    bounds of the one-rank test (an ulp plus 5e-6·κ of the largest |y|; the
    running statistics 1e-6 and 1e-5·κ relative). The gradients: within one
    bfloat16 ulp of the largest one-rank gradient of their tensor (the
    cotangents' float32 sums over the ranks in another order), and the
    statistics float32."""
    x, ct, params, stats = _bn_case((4, 200, 8), 1)
    xb = torch.from_numpy(x).to(BF16)
    ctb = torch.from_numpy(ct).to(BF16)
    y, (gx,), module = helpers.vjp(pool, _port_bn(params, stats), xb, cotangent=ctb, axis=0)
    one = _port_bn(params, stats)
    x1 = xb.clone().requires_grad_(True)
    y1 = one(x1)
    y1.backward(ctb)
    np.testing.assert_array_equal(y, y1.detach().float().numpy())
    for name in ("running_mean", "running_var"):
        assert module["buffers"][name].dtype == np.float32
        np.testing.assert_array_equal(module["buffers"][name], getattr(one, name).numpy())
    for got, ref in ((gx, x1.grad), (module["grads"]["weight"], one.weight.grad),
                     (module["grads"]["bias"], one.bias.grad)):
        ref = ref.float().numpy()
        assert np.abs(got - ref).max() <= _bf16_ulp(np.abs(ref).max())
    y_ref, upd, _ = _flax_bn(params, stats, jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(ct), dtype=jnp.bfloat16)
    x64 = xb.double().reshape(-1, 8).numpy()
    kappa = ((x64 * x64).mean(0) / x64.var(0)).max()
    ref = np.asarray(y_ref.astype(jnp.float32), np.float64)
    d = np.abs(y1.detach().float().numpy() - ref)
    assert (d <= _bf16_ulp(ref) + 5e-6 * kappa * np.abs(ref).max()).all(), d.max()
    np.testing.assert_allclose(module["buffers"]["running_mean"], upd["batch_stats"]["mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(module["buffers"]["running_var"], upd["batch_stats"]["var"],
                               rtol=1e-5 * kappa)


# --- whole-batch losses and metrics ------------------------------------------------


def _logits_labels(seed, b=4, c=3, n=64):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(b, c, n)).astype(np.float32)
    labels = rng.randint(0, c, (b, n)).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("name", LOSSES)
def test_losses_over_two_ranks_match_jax_on_the_whole_batch(pool, name):
    """Each loss over 2 ranks (each its half of the batch) against JAX's
    ``get_loss`` on the whole batch: the value, the same on both ranks, and
    the gradient of the logits (a replicated loss seeds 1 on every rank and
    still counts once)."""
    logits, labels = _logits_labels(3)
    ref, ref_grad = jax.jit(jax.value_and_grad(jax_losses.get_loss(name)))(
        jnp.asarray(logits), jnp.asarray(labels))
    got, (grad, _), _ = helpers.vjp(pool, losses.get_loss(name), torch.from_numpy(logits),
                                       torch.from_numpy(labels), cotangent=torch.tensor(1.0),
                                       axis=0)
    assert float(got) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(ref_grad)).max())
    values = pool.run(helpers.map_rank, losses.get_loss(name),
                      (torch.from_numpy(logits), torch.from_numpy(labels)), {}, 0)
    assert values[0] == values[1]


def test_batch_metrics_are_the_whole_batch(pool):
    """``batch_metric_arrays`` over 2 ranks: JAX's accuracy and IoU arrays of
    the whole batch, the same on both ranks; on one rank, the port's
    ``accuracy_array`` and ``iou_array`` bit for bit. Class 2 is absent from
    the labels (the fallbacks of an empty class)."""
    logits, labels = _logits_labels(4)
    labels = np.minimum(labels, 1)
    ranks = pool.run(helpers.map_rank, metrics.batch_metric_arrays,
                     (torch.from_numpy(logits), torch.from_numpy(labels)), {}, 0)
    ref = [np.asarray(a) for a in jax_metrics.accuracy_array(jnp.asarray(logits),
                                                             jnp.asarray(labels))]
    ref += [np.asarray(a) for a in jax_metrics.iou_array(jnp.asarray(logits),
                                                        jnp.asarray(labels))]
    for a, b, r in zip(ranks[0], ranks[1], ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, r, rtol=1e-6)
    one = metrics.batch_metric_arrays(torch.from_numpy(logits), torch.from_numpy(labels))
    local = (metrics.accuracy_array(torch.from_numpy(logits), torch.from_numpy(labels))
             + metrics.iou_array(torch.from_numpy(logits), torch.from_numpy(labels)))
    for a, b in zip(one, local):
        assert torch.equal(a, b)
    for a, b in zip(ranks[0], one):
        np.testing.assert_array_equal(a, b.numpy())


# --- one data-parallel train step ------------------------------------------------


def _keep_mask_interceptor(kept):
    """Make flax's ``Dropout`` apply ``kept`` in place of its own draw."""

    def intercept(next_fn, args, kwargs, context):
        if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            return jnp.where(kept, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        return next_fn(*args, **kwargs)

    return intercept


@functools.lru_cache(maxsize=None)
def _step_case():
    """JAX's tiny settings: variables (jitted init, statistics moved off
    their init), a batch of 4 clouds of 64 points, labels, a permutation and
    a keep mask, all seeded."""
    rng = np.random.RandomState(0)
    x = rng.rand(4, 64, 3).astype(np.float32)
    labels = (x[..., 0] > 0.6).astype(np.int32)
    perm = rng.permutation(64).astype(np.int32)
    kept = rng.rand(4, 64, 32) < 0.5
    net = jax_rl.RandLANet(JaxSettings(**TINY))
    variables = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                                 jnp.asarray(perm)))
    variables = jax.tree.map(np.array, variables)
    stats = variables["batch_stats"]
    for leaf in jax.tree.leaves(stats):
        leaf += 0.3 * rng.rand(*leaf.shape).astype(np.float32)
    return variables, x, labels, perm, kept


def _port_model(variables):
    return Model(RandLANetSettings(**TINY), weights=from_flax_variables(variables), device="cpu")


def test_dp_train_step_matches_jax_on_a_two_device_mesh(pool):
    """One train step over 2 ranks (``data_parallel.step``, 2 clouds a rank)
    against the JAX trainer's step (``value_and_grad`` of ``apply(train=True)``
    and ``get_loss("dice")``) jitted over the batch sharded on a 2-device
    ``data_parallel_mesh``, same weights, batch, permutation and keep mask:
    loss, gradients and running statistics. Then the same step in float64
    over 2 ranks against the port's one-rank step."""
    variables, x, labels, perm, kept = _step_case()
    jmesh = data_parallel_mesh(2)
    shard = shard_batch_fn(jmesh)
    net = jax_rl.RandLANet(JaxSettings(**TINY))
    criterion = jax_losses.get_loss("dice")

    @jax.jit
    def jax_step(variables, xx, yy, pp, kk):
        def loss_fn(params):
            with flax_nn.intercept_methods(_keep_mask_interceptor(kk)):
                logits, upd = net.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                        xx, pp, train=True, mutable=["batch_stats"])
            return criterion(logits, yy), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables["params"])
        return loss, stats, grads

    loss, stats, grads = jax.device_get(jax_step(variables, shard(x), shard(labels),
                                                 jnp.asarray(perm), shard(kept)))
    model = _port_model(variables)
    spec = data_parallel.payload(model, "dice")
    pool.run(data_parallel.adopt, "dp-step", spec)
    args = (torch.from_numpy(x), torch.from_numpy(labels).long(), torch.from_numpy(perm).long(),
            torch.from_numpy(kept))
    got = pool.run(data_parallel.step, "dp-step", *args)
    got_loss, got_grads, got_stats = got[0][:3]
    assert got_loss == pytest.approx(float(loss), abs=1e-5, rel=1e-4)
    assert got[1][0] == got_loss
    assert all(torch.equal(got_grads[k], got[1][1][k]) for k in got_grads)
    ref_grads = from_flax_variables({"params": grads})
    for name, ref in ref_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), ref.numpy(), atol=5e-4, rtol=5e-3,
                                   err_msg=name)
    for name, ref in from_flax_variables({"batch_stats": stats}).items():
        np.testing.assert_allclose(got_stats[name].numpy(), ref.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=name)

    spec64 = data_parallel.payload(model, "dice", dtype=torch.float64)
    pool.run(data_parallel.adopt, "dp-step", spec64)
    two = pool.run(data_parallel.step, "dp-step", *args)[0]
    pool.run(mesh.forget, "dp-step")
    with mesh.RankPool(["cpu"]) as single:
        single.run(data_parallel.adopt, "dp-step", spec64)
        one = single.run(data_parallel.step, "dp-step", *args)[0]
        single.run(mesh.forget, "dp-step")
    assert two[0] == pytest.approx(one[0], rel=1e-12)
    assert grad_distance(two[1], one[1])[0] < 1e-9
    for name, ref in one[2].items():
        assert float((two[2][name] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
