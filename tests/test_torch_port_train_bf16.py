"""Training in the bfloat16 compute mode: the port against the JAX package.

Train-mode BatchNorm against flax's ``BatchNorm(dtype=bfloat16)``; one whole
bfloat16 train step against the JAX package's bfloat16 step, with the
port's float32 step as the control that must miss the same tolerance; the
float32 master weights (every gradient float32, a second step reading the
updated weights); ``Model.train`` for one epoch; ``--compute-dtype``
through ``train.run_training``.

The JAX oracles are jitted with ``xla_allow_excess_precision`` off, as in
``tests/test_torch_port_bf16.py``, so that every bfloat16 operation rounds
where the program says.
"""

import functools
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import linen as flax_nn

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.training import losses as jax_losses
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.benchmarks.train_precision import grad_distances
from recognizer3d_tpu_torch.models.randlanet import BatchNorm, bn_absorbed_biases
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.training import losses
from recognizer3d_tpu_torch.training import trainer as trainer_module
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step
from recognizer3d_tpu_torch.utils.tb import JsonlSummaryWriter
from tests.test_torch_port_train import SMALL, _keep_mask_interceptor, _step_inputs
from tests.test_torch_port_train_loop import NAMES, _clouds

BF16 = torch.bfloat16
_jit_bf16 = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})

# the bfloat16 step's tolerances against the oracle (see the step test):
# the median over the gradient tensors of ``grad_distances``, and every
# tensor's but the BatchNorm-absorbed biases'
STEP_GRAD_MEDIAN = 0.04
STEP_GRAD_MAX = 0.15


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each |a| (2^(⌊log2 |a|⌋ − 7); normal range)."""
    a = np.maximum(np.abs(np.asarray(a, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


# --- train-mode BatchNorm --------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 300, 8), (2, 100, 16, 8)])
def test_train_batchnorm_bf16_matches_flax(shape):
    """Train-mode BatchNorm on a bfloat16 input (mean 5, unit spread)
    against flax's ``BatchNorm(dtype=bfloat16)`` in train mode. Both take
    the statistics in float32 from the upcast input, normalise in float32
    and round the output once; the port's statistics are the exact ones
    rounded (float64 sums), flax's are float32 sums in XLA's order, which
    on the 25,600-row input read the variance up to 1.14e-4 (about 4.4e-6·κ,
    κ = max E[x²]/var, about 26 here) off the exact one. So: the running
    mean within 1e-6 relative of flax's, the running variance within
    1e-5·κ; the output within one bfloat16 ulp of flax's plus 5e-6·κ of its
    largest |y| (a float32 difference moves a rounding by at most one ulp;
    the variance's error moves y by up to half of it relatively). Against
    the exact statistics (float64) the port's running statistics lie
    within 1e-6 relative. Everything the port keeps is float32, its output
    bfloat16."""
    rng = np.random.RandomState(1)
    c = shape[-1]
    x = torch.from_numpy((rng.randn(*shape) + 5.0).astype(np.float32)).to(BF16)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    ra_mean = rng.randn(c).astype(np.float32)
    ra_var = rng.rand(c).astype(np.float32) + 0.5
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.01, epsilon=1e-6,
                           dtype=jnp.bfloat16)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    y_ref, upd = _jit_bf16(functools.partial(bn.apply, mutable=["batch_stats"]))(
        variables, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    )
    port = BatchNorm(c)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(ra_mean),
                          "running_var": torch.from_numpy(ra_var)})
    port.train()
    y = port(x)
    assert y.dtype == BF16 and y_ref.dtype == jnp.bfloat16
    assert all(t.dtype == torch.float32 for t in port.state_dict().values())
    x64 = x.double().reshape(-1, c).numpy()
    kappa = ((x64 * x64).mean(0) / x64.var(0)).max()
    ref = np.asarray(y_ref.astype(jnp.float32), np.float64)
    d = np.abs(y.detach().float().numpy() - ref)
    assert (d <= _bf16_ulp(ref) + 5e-6 * kappa * np.abs(ref).max()).all(), d.max()
    np.testing.assert_allclose(port.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), upd["batch_stats"]["var"],
                               rtol=1e-5 * kappa)
    np.testing.assert_allclose(port.running_mean.numpy(), 0.01 * ra_mean + 0.99 * x64.mean(0),
                               rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), 0.01 * ra_var + 0.99 * x64.var(0),
                               rtol=1e-6)


# --- one bfloat16 train step -------------------------------------------------------


def _exact_batchnorm(next_fn, args, kwargs, context):
    """flax's train-mode ``BatchNorm`` with its float32 statistics and its
    ``rsqrt(var + eps)`` taken in float64 and rounded to float32 (under
    ``jax.enable_x64``); everything else as flax computes it."""
    mod = context.module
    if not (isinstance(mod, flax_nn.BatchNorm) and context.method_name == "__call__"):
        return next_fn(*args, **kwargs)
    if kwargs.get("use_running_average", mod.use_running_average):
        return next_fn(*args, **kwargs)
    x = args[0]
    axes = tuple(range(x.ndim - 1))
    xs = x.astype(jnp.float64)
    mean = xs.mean(axes)
    var = jnp.maximum(0.0, (xs * xs).mean(axes) - mean * mean)
    mean, var = mean.astype(jnp.float32), var.astype(jnp.float32)
    if not mod.is_initializing():
        for name, value in (("mean", mean), ("var", var)):
            ra = mod.get_variable("batch_stats", name)
            mod.put_variable("batch_stats", name,
                             mod.momentum * ra + (1 - mod.momentum) * value)
    inv = jax.lax.rsqrt((var + mod.epsilon).astype(jnp.float64)).astype(jnp.float32)
    y = (x.astype(jnp.float32) - mean) * (inv * mod.get_variable("params", "scale"))
    return (y + mod.get_variable("params", "bias")).astype(mod.dtype)


@functools.lru_cache(maxsize=None)
def _jax_bf16_step():
    """The JAX trainer's step at SMALL in bfloat16 (``knn="pallas"``, its
    Pallas KNN in interpret mode), the keep mask an input, every train-mode
    BatchNorm through :func:`_exact_batchnorm`. Call under
    ``jax.enable_x64``."""
    net = jax_rl.RandLANet(JaxSettings(**dict(SMALL, knn="pallas", compute_dtype="bfloat16")))
    criterion = jax_losses.get_loss("dice")

    @_jit_bf16
    def step(variables, inputs, labels, permutation, kept):
        keep = _keep_mask_interceptor(kept)

        def intercept(next_fn, args, kwargs, context):
            if isinstance(context.module, flax_nn.Dropout):
                return keep(next_fn, args, kwargs, context)
            return _exact_batchnorm(next_fn, args, kwargs, context)

        def loss_fn(p):
            with flax_nn.intercept_methods(intercept):
                logits, updates = net.apply(
                    {"params": p, "batch_stats": variables["batch_stats"]}, inputs,
                    permutation, train=True, mutable=["batch_stats"],
                )
            return criterion(logits, labels), (logits, updates["batch_stats"])

        (loss, (logits, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"]
        )
        return loss, logits, grads, new_bs

    return step


def _port_step(variables, xyz, labels, perm, kept, compute_dtype):
    model = Model(RandLANetSettings(**SMALL, compute_dtype=compute_dtype),
                  weights=from_flax_variables(variables), device="cpu")
    module = model.module
    module.train()
    optimizer = make_optimizer(module, 1e-2)
    loss, logits = train_step(module, optimizer, losses.get_loss("dice"),
                              torch.from_numpy(xyz), torch.from_numpy(labels),
                              torch.from_numpy(perm), torch.from_numpy(kept))
    grads = {n: p.grad.detach().double() for n, p in module.named_parameters()}
    stats = {n: b.detach().double() for n, b in module.named_buffers()}
    return float(loss), logits.numpy(), grads, stats


def test_one_bf16_train_step_matches_jax():
    """One bfloat16 step of the port against the JAX package's bfloat16
    step (``_jax_bf16_step``), from the same weights, batch (2 × 512
    points, layers [16, 64], K = 16), permutation and keep mask as the
    float32 step test (``tests/test_torch_port_train.py``).

    The oracle's train-mode BatchNorms take their float32 statistics and
    ``rsqrt(var + eps)`` exactly (float64, rounded), as the port's do. The
    JAX step as it stands reduces in XLA's float32 order: its running
    variances there lie up to 8e-5 (relative) from the exact ones, which
    flips about 1% of a BatchNorm's bfloat16 outputs; the flips cascade,
    and that step then lies a median 0.106 of max |g| from the port's
    bfloat16 step and 0.151 from its float32 step, too close to tell them
    apart. Against the oracle the port's bfloat16 forward is the same bit
    for bit (measured: logits equal), and what is left comes from the
    backward's sums (XLA reduces a bfloat16 bias gradient and the
    softmax's normaliser gradient in bfloat16 partial sums, the port in
    float32; scatter orders).

    Tolerances, with what was measured: the loss within 1e-6 relative
    (5.5e-8); the logits within one bfloat16 ulp of the largest |logit|
    (0); the new running statistics within 1e-5 of each tensor's largest
    value (1.2e-6); over the gradient tensors (``grad_distances``: each
    relative to its JAX tensor's largest |g|, a Dense bias before a
    BatchNorm, whose exact gradient is 0, to its weight's) a median within
    ``STEP_GRAD_MEDIAN`` (0.014) and every tensor but those biases within
    ``STEP_GRAD_MAX`` (largest 0.060). The port's float32 step, the
    control, must miss the gradients' median, the logits' and the
    statistics' tolerances (measured: 0.140, 0.102, 1.0e-2)."""
    variables, xyz, labels, perm, kept = _step_inputs()
    with jax.enable_x64(True):
        loss, logits, grads, new_bs = jax.device_get(
            _jax_bf16_step()(variables, xyz, labels, perm, kept)
        )
    assert logits.dtype == np.float32
    ref_grads = from_flax_variables({"params": grads})
    ref_bs = from_flax_variables({"batch_stats": new_bs})
    absorbed = bn_absorbed_biases(ref_grads)
    logit_tol = float(_bf16_ulp(np.abs(logits).max()))

    def distances(compute_dtype):
        got_loss, got_logits, got_grads, got_bs = _port_step(
            variables, xyz, labels, perm, kept, compute_dtype
        )
        d = grad_distances(got_grads, ref_grads)
        bs = max(float((got_bs[n] - r.double()).abs().max() / r.abs().max())
                 for n, r in ref_bs.items())
        return (abs(got_loss - float(loss)) / abs(float(loss)),
                float(np.abs(got_logits - logits).max()), d, bs)

    loss_err, logit_err, d, bs_err = distances("bfloat16")
    assert loss_err <= 1e-6 and logit_err <= logit_tol and bs_err <= 1e-5, (
        loss_err, logit_err, bs_err)
    assert np.median(list(d.values())) <= STEP_GRAD_MEDIAN, sorted(d.items(), key=lambda kv: kv[1])
    worst = {k: v for k, v in d.items() if k not in absorbed and v > STEP_GRAD_MAX}
    assert not worst, worst

    _, logit_err, d, bs_err = distances("float32")
    assert np.median(list(d.values())) > STEP_GRAD_MEDIAN
    assert logit_err > logit_tol and bs_err > 1e-5, (logit_err, bs_err)


def test_bf16_step_updates_float32_masters():
    """In bfloat16 every parameter gets a float32 gradient, the parameters,
    Adam's moments and the running statistics stay float32, and a second
    step reads the updated weights: its loss and gradients are those of a
    fresh model loaded with the weights after the first step (a forward that
    read the Dense copies cast before the update would not be)."""
    variables, xyz, labels, perm, kept = _step_inputs()
    args = [torch.from_numpy(a) for a in (xyz, labels, perm, kept)]
    model = Model(RandLANetSettings(**SMALL, compute_dtype="bfloat16"),
                  weights=from_flax_variables(variables), device="cpu")
    module = model.module
    module.train()
    optimizer = make_optimizer(module, 1e-2)
    criterion = losses.get_loss("dice")
    train_step(module, optimizer, criterion, *args)
    for name, p in module.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        state = optimizer.state[p]
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32, name
    assert all(b.dtype == torch.float32 for b in module.buffers())
    after_one = {k: v.clone() for k, v in module.state_dict().items()}
    loss2, _ = train_step(module, optimizer, criterion, *args)
    grads2 = {n: p.grad.clone() for n, p in module.named_parameters()}

    fresh = Model(RandLANetSettings(**SMALL, compute_dtype="bfloat16"), weights=after_one,
                  device="cpu").module
    fresh.train()
    xyz_t, labels_t, perm_t, kept_t = args
    loss_fresh = criterion(fresh(xyz_t, perm_t, kept_t), labels_t)
    loss_fresh.backward()
    assert float(loss2) == float(loss_fresh.detach())
    for name, p in fresh.named_parameters():
        assert torch.equal(p.grad, grads2[name]), name


def test_model_train_runs_in_bf16(tmp_path):
    """``Model.train`` in bfloat16 for one epoch, as the JAX package's
    ``test_short_training_runs_in_bfloat16``: the loss finite, every
    parameter float32 and moved. The saved archive loads in both dtypes in
    both packages, to the same variables."""
    clouds = _clouds(0, 5)
    model = Model(RandLANetSettings(**dict(SMALL, n_classes=2, n_points=256, n_neighbors=8),
                                    compute_dtype="bfloat16"), device="cpu")
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    seen = []
    model.train(clouds[:4], clouds[4:],
                TrainingSettings(epochs=1, batch_size=2, early_stopping=False),
                class_names=NAMES, callbacks=[lambda epoch, metrics: seen.append(metrics)])
    assert len(seen) == 1 and np.isfinite(seen[0]["loss"]) and np.isfinite(seen[0]["val_loss"])
    params = dict(model.module.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(not torch.equal(p, init[n]) for n, p in params.items())
    path = tmp_path / "model"
    model.save(path)
    state = model.module.state_dict()
    for dtype in ("float32", "bfloat16"):
        port = Model.load(path, device="cpu", compute_dtype=dtype)
        assert port.settings.compute_dtype == dtype
        for key, value in port.module.state_dict().items():
            assert torch.equal(value, state[key]), key
        jax_model = JaxModel.load(path, compute_dtype=dtype)
        assert jax_model.settings.compute_dtype == dtype
        ref = from_flax_variables(jax.device_get(jax_model.variables))
        for key, value in ref.items():
            assert torch.equal(value, state[key]), key


def test_compute_dtype_reaches_the_model(tmp_path, monkeypatch):
    """``--compute-dtype bfloat16`` goes from the CLI to the spawned job,
    and ``run_training(..., compute_dtype="bfloat16")`` trains a bfloat16
    model (the small config in place of the app's), whose saved archive
    says so."""
    from datetime import datetime, timedelta

    from recognizer3d_tpu_torch import train as port_train
    from recognizer3d_tpu_torch.data.dataset import Dataset

    launched = []

    class Job:
        succeeded = True

        @classmethod
        def launch(cls, dirs, device="cuda", compute_dtype="float32"):
            launched.append(compute_dtype)
            return cls()

        def poll(self):
            return 100

    monkeypatch.setattr(port_train, "TrainingJob", Job)
    monkeypatch.setattr(sys, "argv", ["train", "-d", "x", "--compute-dtype", "bfloat16"])
    port_train._cli()
    assert launched == ["bfloat16"]

    monkeypatch.setattr(port_train, "app_model_config",
                        lambda: RandLANetSettings(**dict(SMALL, n_classes=2, n_points=256,
                                                         n_neighbors=8)))
    monkeypatch.setattr(trainer_module, "make_summary_writer", JsonlSummaryWriter)
    ds = Dataset(tmp_path / "a")
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    for i, (xyz, _, labels) in enumerate(_clouds(5, 5)):
        ds[t0 + timedelta(seconds=i)] = xyz
        ds.set_annotation(t0 + timedelta(seconds=i), labels)
    np.random.seed(0)
    path, model, trainer = port_train.run_training(
        [tmp_path / "a"], training=TrainingSettings(epochs=1, batch_size=4,
                                                     early_stopping=False),
        models_dir=tmp_path / "models", log_root=tmp_path / "log", device="cpu",
        compute_dtype="bfloat16",
    )
    assert model.settings.compute_dtype == "bfloat16"
    assert model.module.compute_dtype == BF16
    assert np.isfinite(trainer.history[0]["metrics"]["loss"])
    assert Model.load(path, device="cpu").settings.compute_dtype == "bfloat16"
