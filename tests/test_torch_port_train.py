"""The port's training pieces against the JAX package: the initialisation
bounds, the five losses, the metric arrays, train-mode BatchNorm, one whole
train step (forward, loss, backward, Adam) and the Adam update itself.

The one-step oracle is a jitted JAX step in float64 built from the JAX
package's own pieces: ``module.apply(train=True, mutable=["batch_stats"])``,
``get_loss``, ``optax.scale_by_adam`` and ``-lr·u``, as its trainer builds
it. It runs ``knn="pallas"`` (the Pallas KNN kernel in interpret mode),
whose direct differences pick the same neighbours as the port's exact
search; the port runs the app's ``knn="naive"``. Both sides start from the
same weights (through the bridge) with the same batch, permutation and
dropout mask: JAX's mask, read from the captured output of its ``Dropout``
layer.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import linen as flax_nn

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.training import losses as jax_losses
from recognizer3d_tpu.training import metrics as jax_metrics
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.models.randlanet import BatchNorm, RandLANet, bn_absorbed_biases
from recognizer3d_tpu_torch.models.weights import (
    adam_state_from_optax,
    adam_state_to_optax,
    from_flax_variables,
)
from recognizer3d_tpu_torch.training import losses, metrics
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from recognizer3d_tpu_torch.training.trainer import make_optimizer, step_lr, train_step

APP = dict(n_classes=2, n_features=0, knn="naive", n_points=2500, n_neighbors=32, decimation=4)
SMALL = dict(n_classes=3, n_features=0, knn="naive", n_points=512, n_neighbors=16,
             decimation=4, layer_sizes=[16, 64])
LOSSES = ["cross_entropy", "focal", "dice", "tversky", "focal_tversky"]


def _flat(tree, prefix=""):
    """A nested dict -> {"a/b/c": leaf}; numpy leaves stay the same objects."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


# --- initialisation -------------------------------------------------------------


def test_init_bounds_match_jax_at_app_config(monkeypatch):
    """Every layer's initial draw at the app config: the JAX init is run
    with its torch-style uniform initialiser replaced by one that fills each
    leaf with its bound, which gives the bound of every Dense kernel and
    bias exactly; BatchNorm scales and biases and the running statistics
    are flax's (ones and zeros). The port's draws over 50 seeds must stay
    within each bound and reach 0.9 of it (the largest of 100 or more
    uniform draws falls below 0.9 of the bound with probability below
    3e-5), and its BatchNorm leaves must be the same ones and zeros."""

    def bound_init(fan):
        bound = 1.0 / fan**0.5
        return lambda key, shape, dtype=jnp.float32: jnp.full(shape, bound, dtype)

    monkeypatch.setattr(jax_rl, "_torch_uniform_init", bound_init)
    settings = JaxSettings(**APP)
    n = settings.min_n_points
    net = jax_rl.RandLANet(settings)
    variables = jax.jit(functools.partial(net.init, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, n, 3)), jnp.arange(n, dtype=jnp.int32)
    )
    bounds = from_flax_variables(jax.device_get(variables))

    port_settings = RandLANetSettings(**APP)
    peak = {}
    for seed in range(50):
        torch.manual_seed(seed)
        state = RandLANet(port_settings).state_dict()
        if seed == 0:
            assert sorted(state) == sorted(bounds)
        for name, value in state.items():
            peak[name] = torch.maximum(peak.get(name, torch.zeros(())), value.abs().max())
    bn = {k for k in bounds if k.endswith(("running_mean", "running_var"))}
    bn |= {k.rsplit(".", 1)[0] + leaf for k in bn for leaf in (".weight", ".bias")}
    for name, ref in bounds.items():
        if name in bn:
            np.testing.assert_array_equal(state[name].numpy(), ref.numpy(), err_msg=name)
            continue
        bound = float(ref.flatten()[0])
        assert torch.all(ref == bound), name
        got = float(peak[name])
        assert 0.9 * bound <= got <= bound * (1 + 1e-6), (name, got, bound)


# --- losses and metrics ------------------------------------------------------------


def _logits_labels(seed, b=2, c=3, n=64, absent=None):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, c, n) * 2).astype(np.float32)
    labels = rng.randint(0, c, (b, n)).astype(np.int32)
    if absent is not None:
        labels[labels == absent] = (absent + 1) % c
    return logits, labels


@pytest.mark.parametrize("name", LOSSES)
@pytest.mark.parametrize("absent", [None, 2])
def test_losses_match_jax(name, absent):
    """Each loss on the same logits and labels, with and without an absent
    class: 1e-6 relative."""
    logits, labels = _logits_labels(3, absent=absent)
    ref = float(jax_losses.get_loss(name)(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(losses.get_loss(name)(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert got == pytest.approx(ref, rel=1e-6)


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        losses.get_loss("hinge")


@pytest.mark.parametrize("case", ["random", "absent_class", "empty_union"])
def test_metric_arrays_match_jax(case):
    """accuracy_array and iou_array, exactly: an absent class (no labels,
    some predictions) and an empty union (a class neither labelled nor
    predicted) take the fallback values."""
    logits, labels = _logits_labels(5, c=4)
    if case == "absent_class":
        labels[labels == 1] = 0
    elif case == "empty_union":
        labels[labels == 3] = 0
        logits[:, 3] = -1e3
    for fn_port, fn_jax in ((metrics.accuracy_array, jax_metrics.accuracy_array),
                            (metrics.iou_array, jax_metrics.iou_array)):
        got = fn_port(torch.from_numpy(logits), torch.from_numpy(labels))
        ref = fn_jax(jnp.asarray(logits), jnp.asarray(labels))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # one cloud (C, N), as postprocess evaluation scores it
    for fn_port, fn_jax in ((metrics.accuracy_array, jax_metrics.accuracy_array),
                            (metrics.iou_array, jax_metrics.iou_array)):
        got = fn_port(torch.from_numpy(logits[0]), torch.from_numpy(labels[0]))
        ref = fn_jax(jnp.asarray(logits[0]), jnp.asarray(labels[0]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_metric_collectors_match_jax():
    """MetricCollector and MetricCollectorBag give the JAX package's keys
    and values on the same pushes."""
    names = ["background", "fingerpoint"]
    bags = []
    for mod in (metrics, jax_metrics):
        collectors = []
        for _ in range(3):
            mc = mod.MetricCollector()
            for row in np.random.RandomState(1).rand(4, 7):
                mc.push(row[0], row[1], row[2:4], row[4], row[5:7])
            collectors.append(mc)
        bags.append(mod.MetricCollectorBag(collectors, names))
    for tag, stdev in (("", True), ("val", False)):
        a, b = (bag.as_dict(tag, include_stdev=stdev) for bag in bags)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, err_msg=k)


# --- train-mode BatchNorm ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 300, 8), (2, 100, 16, 8)])
def test_train_batchnorm_matches_flax(shape):
    """Train-mode BatchNorm against flax's on inputs with a large mean (5)
    and unit spread, reducing over (B, N) or (B, N, K). The variance is
    E[x²] − E[x]² in float32 on both sides (flax's fast variance), summed
    in different orders, so each side's error is that of a float32 sum of
    E[x²]: the tolerances are 1e-6 relative to E[x²], i.e. 1e-6 × κ with
    κ = max E[x²]/var (about 26 here), on the running variance and on the
    output (times its largest |y|), and 1e-6 relative on the running mean.
    torch's own BatchNorm (unbiased running variance, momentum 0.1) is off
    by 2e-3 and more."""
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = (rng.randn(*shape) + 5.0).astype(np.float32)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    ra_mean = rng.randn(c).astype(np.float32)
    ra_var = rng.rand(c).astype(np.float32) + 0.5
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.01, epsilon=1e-6)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    y_ref, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(c)
    port.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(ra_mean),
                          "running_var": torch.from_numpy(ra_var)})
    port.train()
    y = port(torch.from_numpy(x)).detach().numpy()
    x64 = x.reshape(-1, c).astype(np.float64)
    kappa = ((x64 * x64).mean(0) / x64.var(0)).max()
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=0,
                               atol=1e-6 * kappa * np.abs(y_ref).max())
    np.testing.assert_allclose(port.running_mean.numpy(), upd["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), upd["batch_stats"]["var"],
                               rtol=1e-6 * kappa)


# --- one train step ---------------------------------------------------------------


def _keep_mask_interceptor(kept):
    """A flax method interceptor that makes the ``Dropout`` layer apply
    ``kept`` (kept features doubled, the rest zeroed) instead of its own
    draw."""

    def intercept(next_fn, args, kwargs, context):
        if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
            x = args[0]
            return jnp.where(kept, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        return next_fn(*args, **kwargs)

    return intercept


@functools.lru_cache(maxsize=None)
def _jax_step64(loss_name):
    """The JAX trainer's step (trainer.py's train_step) at SMALL in float64,
    jitted: the JAX package's module with ``compute_dtype`` float64 (its
    geometry and neighbour search stay float32, as the model casts xyz),
    ``get_loss``, ``optax.scale_by_adam`` and ``-lr·u``. The keep mask is
    an input. Build and call it under ``jax.enable_x64``."""
    settings = JaxSettings(**dict(SMALL, knn="pallas"))
    settings.compute_dtype = "float64"  # past the settings' own check
    net = jax_rl.RandLANet(settings)
    criterion = jax_losses.get_loss(loss_name)
    tx = optax.scale_by_adam()

    @jax.jit
    def step(variables, inputs, labels, permutation, kept, lr):
        params, batch_stats = variables["params"], variables["batch_stats"]

        def loss_fn(p):
            with flax_nn.intercept_methods(_keep_mask_interceptor(kept)):
                logits, updates = net.apply(
                    {"params": p, "batch_stats": batch_stats}, inputs, permutation, train=True,
                    mutable=["batch_stats"],
                )
            return criterion(logits, labels), (logits, updates["batch_stats"])

        (loss, (logits, new_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt = tx.update(grads, tx.init(params))
        new_params = optax.apply_updates(params, jax.tree.map(lambda u: -lr * u, updates))
        return loss, logits, grads, new_bs, opt, new_params

    return step


@functools.lru_cache(maxsize=None)
def _step_inputs():
    """Weights, batch (2 × 512 points), permutation and JAX's own keep mask:
    its float32 train forward's ``Dropout`` output, captured."""
    rng = np.random.RandomState(0)
    n = SMALL["n_points"]
    xyz = rng.rand(2, n, 3).astype(np.float32)
    labels = (xyz[..., 0] > 0.6).astype(np.int32) + (xyz[..., 1] > 0.8).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    # the variables do not depend on the KNN route: init on the plain one
    variables = jax.jit(functools.partial(jax_rl.RandLANet(JaxSettings(**SMALL)).init,
                                          train=False))(
        jax.random.PRNGKey(1), jnp.zeros((1, n, 3)), jnp.arange(n, dtype=jnp.int32)
    )
    # running statistics away from their init, so the update rule shows
    variables = jax.tree.map(np.array, jax.device_get(variables))
    for path, leaf in _flat(variables["batch_stats"]).items():
        leaf += (0.3 if path.endswith("mean") else 0.7) * rng.rand(*leaf.shape).astype(np.float32)

    net = jax_rl.RandLANet(JaxSettings(**dict(SMALL, knn="pallas")))

    @jax.jit
    def dropout_out(variables, inputs, permutation, key):
        _, state = net.apply(variables, inputs, permutation, train=True, rngs={"dropout": key},
                             capture_intermediates=True,
                             mutable=["batch_stats", "intermediates"])
        return state["intermediates"]["Dropout_0"]["__call__"][0]

    kept = np.asarray(dropout_out(variables, xyz, perm, jax.random.PRNGKey(7))) != 0
    return variables, xyz, labels, perm, kept


@pytest.mark.parametrize("loss_name", ["dice", "cross_entropy"])
def test_one_train_step_matches_jax(loss_name):
    """One float32 step of the port against the JAX package's step in
    float64 (``_jax_step64``), from the same weights, batch (2 × 512
    points, 3 classes, layers [16, 64], K = 16), permutation and keep mask:
    JAX's own, read from its float32 train forward's ``Dropout`` output and
    handed to the float64 step through a flax method interceptor (under
    x64, threefry's uniforms are float64 and would draw another mask). The
    oracle is float64 because a float32 step is itself about 1e-3 of max
    |g| off the exact gradients at encoder 1's ``mlp_rpe1`` and ``mlp_rpe2``
    with this batch (BatchNorm over large-mean inputs cancels), JAX's jitted
    step included; the port's float32 step is within 1e-5.

    Tolerances: the loss 1e-5 relative; the logits 1e-4 absolute (order
    1); every gradient within 1e-4 of the largest |g| of its JAX tensor;
    a Dense bias before a BatchNorm, whose gradient is 0 in exact
    arithmetic and float32 noise in the port, within 1e-4 of its weight's
    (``bn_absorbed_biases``); the new running statistics within 1e-5 of
    each tensor's largest value (a batch mean can sit near zero). Adam's
    mu and nu, read through the bridge, are 0.1·g and 0.001·g² at t = 1:
    mu within 0.1 of the gradient's tolerance, nu within 0.001·(2|g| + that
    tolerance)·that tolerance. The updated parameters within 1e-6 where |g|
    exceeds 1e-2 of the tensor's scale (elsewhere Adam's first step
    g/(|g| + 1e-8) turns float32 noise into an arbitrary fraction of lr)."""
    lr = 1e-2
    variables, xyz, labels, perm, kept = _step_inputs()
    with jax.enable_x64(True):
        as64 = functools.partial(jax.tree.map, lambda a: np.asarray(a, np.float64))
        loss, logits, grads, new_bs, opt, new_params = jax.device_get(_jax_step64(loss_name)(
            as64(variables), xyz, labels, perm, kept, np.float64(lr)
        ))
    model = Model(RandLANetSettings(**SMALL), weights=from_flax_variables(variables),
                  device="cpu")
    module = model.module
    module.train()
    optimizer = make_optimizer(module, lr)
    got_loss, got_logits = train_step(
        module, optimizer, losses.get_loss(loss_name), torch.from_numpy(xyz),
        torch.from_numpy(labels), torch.from_numpy(perm), torch.from_numpy(kept),
    )
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), logits, rtol=0, atol=1e-4)

    ref_grads = {k: v.numpy() for k, v in from_flax_variables({"params": grads}).items()}
    ref_params = from_flax_variables({"params": new_params})
    state = module.state_dict()
    absorbed = bn_absorbed_biases(state)
    grad_tol = {name: 1e-4 * np.abs(ref_grads[absorbed.get(name, name)]).max()
                for name in ref_grads}
    for name, param in module.named_parameters():
        ref = ref_grads[name]
        np.testing.assert_allclose(param.grad.numpy(), ref, rtol=0, atol=grad_tol[name],
                                   err_msg=name)
        big = np.abs(ref) > 1e2 * grad_tol[name]
        np.testing.assert_allclose(state[name].numpy()[big], ref_params[name].numpy()[big],
                                   rtol=0, atol=1e-6, err_msg=name)
    ref_bs = from_flax_variables({"batch_stats": new_bs})
    for name, value in ref_bs.items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(value.numpy()).max(), err_msg=name)

    mine = adam_state_to_optax(optimizer, module)
    assert int(mine["count"]) == int(opt.count) == 1
    for field in ("mu", "nu"):
        ref_state = from_flax_variables({"params": getattr(opt, field)})
        got_state = from_flax_variables({"params": mine[field]})
        assert sorted(got_state) == sorted(ref_state)
        for name, ref in ref_state.items():
            tol = grad_tol[name]
            tol = 0.1 * tol if field == "mu" else 1e-3 * (2 * np.abs(ref_grads[name]) + tol) * tol
            np.testing.assert_array_less(np.abs(got_state[name].numpy() - ref.numpy()), tol,
                                         err_msg=f"{field} {name}")


# --- Adam and the schedule ----------------------------------------------------------


def test_adam_matches_optax_and_step_lr():
    """torch Adam against ``optax.scale_by_adam`` and ``-lr·u`` on
    identical gradients (spread over six decades), after steps 1 and 3:
    the moments mu and nu within 1e-6 relative (and 1e-6 of the tensor's
    largest, where the sum b1·mu + (1 − b1)·g cancels); the parameter updates
    within 1e-5 of their own size, plus 1e-6 of the tensor's largest
    update (where the moments cancel to a small update) and a float32 ulp
    of the parameter (the rounding of p + Δ). optax takes the bias corrections
    1 − b^t in float32, and float32(0.999) = 0.99900001 makes 1 − 0.999
    1.29e-5 small, so its update at t = 1 is 6.5e-6 larger than the exact
    one that torch computes in double. The lr is StepLR's at epochs 1, 10
    and 11 (lr0, lr0, lr0·0.9). The optax state, loaded into a fresh torch
    Adam through the bridge, continues the same way."""
    settings = TrainingSettings(learning_rate=1e-2, learning_rate_decay=0.9)
    assert step_lr(settings, 1) == step_lr(settings, 10) == 1e-2
    assert step_lr(settings, 11) == pytest.approx(9e-3, rel=1e-15)
    assert step_lr(settings, 21) == pytest.approx(8.1e-3, rel=1e-15)

    rng = np.random.RandomState(0)
    module = RandLANet(RandLANetSettings(**SMALL))
    names = [name for name, _ in module.named_parameters()]
    tx = optax.scale_by_adam()
    update = jax.jit(tx.update)
    opt_state = tx.init({k: p.detach().numpy().copy() for k, p in module.named_parameters()})
    optimizer = make_optimizer(module, settings.learning_rate)

    def check_update(before, torch_params, jax_update, label):
        # the parameters after the step; one float32 ulp of the parameter
        # for the rounding of p + Δ on each side
        for name, p in torch_params:
            ref = np.asarray(jax_update[name])
            after = (before[name] + ref).astype(np.float32)
            np.testing.assert_array_less(np.abs(p.detach().numpy() - after),
                                         1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max()
                                         + np.spacing(np.abs(after)),
                                         err_msg=f"{label} {name}")

    def grads_like(params):
        return {k: (rng.randn(*v.shape) * 10.0 ** rng.uniform(-6, 0)).astype(np.float32)
                for k, v in params}

    for t, epoch in enumerate((1, 10, 11), start=1):
        lr = step_lr(settings, epoch)
        grads = grads_like((k, p) for k, p in module.named_parameters())
        updates, opt_state = update(grads, opt_state)
        updates = jax.device_get(updates)
        before = {k: p.detach().numpy().copy() for k, p in module.named_parameters()}
        for group in optimizer.param_groups:
            group["lr"] = lr
        for name, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[name])
        optimizer.step()
        if t in (1, 3):
            check_update(before, module.named_parameters(),
                         {k: -lr * updates[k] for k in names}, f"step {t}")
            for name, p in module.named_parameters():
                st = optimizer.state[p]
                for mine, ref in ((st["exp_avg"], opt_state.mu[name]),
                                  (st["exp_avg_sq"], opt_state.nu[name])):
                    ref = np.asarray(ref)
                    np.testing.assert_allclose(mine.numpy(), ref, rtol=1e-6,
                                               atol=1e-6 * np.abs(ref).max(), err_msg=name)
    # the bridge: optax's state into a fresh Adam, one more identical step
    fresh = RandLANet(RandLANetSettings(**SMALL))
    fresh.load_state_dict(module.state_dict())
    opt2 = make_optimizer(fresh, 1e-3)
    jax_tree = {"count": np.asarray(opt_state.count),
                "mu": to_tree(opt_state.mu, fresh), "nu": to_tree(opt_state.nu, fresh)}
    adam_state_from_optax(opt2, fresh, jax_tree)
    back = adam_state_to_optax(opt2, fresh)
    assert int(back["count"]) == 3
    for field in ("mu", "nu"):
        for path, ref in _flat(jax_tree[field]).items():
            np.testing.assert_array_equal(_flat(back[field])[path], ref)
    grads = grads_like((k, p) for k, p in fresh.named_parameters())
    updates = jax.device_get(update(grads, opt_state)[0])
    before = {k: p.detach().numpy().copy() for k, p in fresh.named_parameters()}
    for name, p in fresh.named_parameters():
        p.grad = torch.from_numpy(grads[name])
    opt2.step()
    check_update(before, fresh.named_parameters(), {k: -1e-3 * updates[k] for k in names},
                 "bridged step 4")


def to_tree(flat_by_name, module):
    """A {state_dict name: array} dict -> the flax params tree."""
    from recognizer3d_tpu_torch.models.weights import to_flax_variables

    state = {k: torch.as_tensor(np.array(v)) for k, v in flat_by_name.items()}
    state.update(dict(module.named_buffers()))
    return to_flax_variables(state)["params"]
