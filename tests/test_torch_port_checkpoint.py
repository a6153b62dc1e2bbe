"""Training checkpoints of the port against the JAX package's: the blob's
layout (flax's msgpack of ``{"params", "batch_stats", "opt_state", "epoch",
"step"}``, ``opt_state`` as optax's ``scale_by_adam`` state serialises),
a port checkpoint restored into the JAX trainer's trees, a JAX checkpoint
loaded into the port's model and Adam, ``keep`` pruning, and
``Trainer.train`` saving and resuming at the JAX trainer's points."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization as flax_serialization

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.training import checkpoint as jax_ckpt
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.models.weights import adam_state_to_optax, from_flax_variables
from recognizer3d_tpu_torch.training import checkpoint as ckpt
from recognizer3d_tpu_torch.training import losses
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step
from recognizer3d_tpu_torch.utils import msgpack_lite
from tests.test_torch_port_train_loop import NAMES, SMALL, _clouds

TINY = dict(SMALL, layer_sizes=[8, 16])


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _layout(tree):
    """{path: (shape, dtype)} of a decoded blob; ints as ("int",)."""
    return {k: (np.shape(v), np.asarray(v).dtype.name) if isinstance(v, np.ndarray)
            else (type(v).__name__,) for k, v in _flat(tree).items()}


def _port_state(steps=2, seed=0):
    """A port model at TINY and its Adam after ``steps`` steps on the CPU."""
    model = Model(RandLANetSettings(**TINY), device="cpu", seed=seed)
    module = model.module
    module.train()
    optimizer = make_optimizer(module, 1e-2)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        xyz = torch.from_numpy(rng.rand(2, 256, 3).astype(np.float32))
        labels = (xyz[..., 0] > 0.5).long()
        keep = torch.from_numpy(rng.rand(2, 256, 32) < 0.5)
        train_step(module, optimizer, losses.get_loss("dice"), xyz, labels,
                   torch.from_numpy(rng.permutation(256)), keep)
    return module, optimizer


@functools.lru_cache(maxsize=None)
def _jax_shapes():
    """Shapes and dtypes of the JAX model's variables at TINY."""
    settings = JaxSettings(**TINY)
    n = settings.min_n_points
    return jax.eval_shape(functools.partial(jax_rl.RandLANet(settings).init, train=False),
                          jax.random.PRNGKey(0), jnp.zeros((1, n, 3)),
                          jnp.arange(n, dtype=jnp.int32))


def _jax_trees(seed=3):
    """The JAX trainer's trees at TINY: params, batch_stats (seeded draws in
    the shapes of the JAX model's init) and ``optax.scale_by_adam()``'s
    state, as its ``Trainer.train`` makes it."""
    rng = np.random.RandomState(seed)
    variables = jax.tree.map(lambda s: (rng.rand(*s.shape) + 0.5).astype(s.dtype),
                             _jax_shapes())
    params = variables["params"]
    return params, variables["batch_stats"], optax.scale_by_adam().init(params)


def test_port_blob_has_flax_layout(tmp_path):
    """The port's blob, decoded, has the layout flax's ``to_bytes`` gives
    the JAX trainer's state (``trainer.py``'s ``save_checkpoint`` call):
    the same keys, shapes and dtypes, ``opt_state`` a ``{"count", "mu",
    "nu"}`` map (optax's ``ScaleByAdamState`` as flax serialises it),
    ``epoch`` and ``step`` plain ints."""
    params, batch_stats, opt_state = _jax_trees()
    jax_blob = flax_serialization.to_bytes(jax.device_get({
        "params": params, "batch_stats": batch_stats, "opt_state": opt_state,
        "epoch": 4, "step": 17,
    }))
    reference = msgpack_lite.msgpack_restore(jax_blob)
    assert sorted(reference["opt_state"]) == ["count", "mu", "nu"]
    module, optimizer = _port_state()
    path = ckpt.save_checkpoint(tmp_path, 4, ckpt.training_state(module, optimizer, 4, 17))
    assert path.name == "ckpt_00004.msgpack"
    ours = msgpack_lite.msgpack_restore(path.read_bytes())
    assert _layout(ours) == _layout(reference)
    assert ours["epoch"] == 4 and ours["step"] == 17 and int(ours["opt_state"]["count"]) == 2
    # and flax itself reads the port's blob
    assert _layout(flax_serialization.msgpack_restore(path.read_bytes())) == _layout(reference)


def test_port_checkpoint_restores_into_jax_trees(tmp_path):
    """A port checkpoint, restored by the JAX package's
    ``restore_checkpoint`` and ``from_state_dict`` into the JAX trainer's
    ``params``, ``batch_stats`` and ``opt_state`` (as its resume does),
    equals the port's state through the weight bridge, bit for bit."""
    module, optimizer = _port_state()
    ckpt.save_checkpoint(tmp_path, 2, ckpt.training_state(module, optimizer, 2, 9))
    params, batch_stats, opt_state = _jax_trees()
    assert jax_ckpt.latest_checkpoint(tmp_path) == 2
    restored = jax_ckpt.restore_checkpoint(tmp_path)
    params = flax_serialization.from_state_dict(params, restored["params"])
    batch_stats = flax_serialization.from_state_dict(batch_stats, restored["batch_stats"])
    opt_state = flax_serialization.from_state_dict(opt_state, restored["opt_state"])
    assert int(restored["epoch"]) == 2 and int(restored["step"]) == 9
    assert isinstance(opt_state, optax.ScaleByAdamState) and int(opt_state.count) == 2
    state = module.state_dict()
    got = from_flax_variables(jax.device_get({"params": params, "batch_stats": batch_stats}))
    assert sorted(got) == sorted(state)
    for name, value in got.items():
        assert torch.equal(value, state[name]), name
    adam = adam_state_to_optax(optimizer, module)
    for field in ("mu", "nu"):
        ref = _flat(adam[field])
        for path, value in _flat(jax.device_get(getattr(opt_state, field))).items():
            np.testing.assert_array_equal(value, ref[path], err_msg=f"{field} {path}")


def test_jax_checkpoint_loads_into_port(tmp_path):
    """A JAX checkpoint (its trainer's trees after two Adam updates,
    written by its ``save_checkpoint``) loaded into a port model and Adam:
    the weights, running statistics, Adam's count, mu and nu equal the JAX
    trees bit for bit; epoch and step come back. The port's Adam then takes
    a step from that state."""
    params, batch_stats, opt_state = _jax_trees()
    update = jax.jit(optax.scale_by_adam().update)
    rng = np.random.RandomState(0)
    for _ in range(2):
        grads = jax.tree.map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
        _, opt_state = update(grads, opt_state)
    batch_stats = jax.tree.map(lambda a: a + 0.25, batch_stats)
    jax_ckpt.save_checkpoint(tmp_path, 6, {"params": params, "batch_stats": batch_stats,
                                           "opt_state": opt_state, "epoch": 6, "step": 30})
    model = Model(RandLANetSettings(**TINY), device="cpu", seed=1)
    optimizer = make_optimizer(model.module, 1e-2)
    assert ckpt.latest_checkpoint(tmp_path) == 6
    epoch, step = ckpt.load_training_state(ckpt.restore_checkpoint(tmp_path), model.module,
                                           optimizer)
    assert (epoch, step) == (6, 30)
    state = model.module.state_dict()
    ref = from_flax_variables(jax.device_get({"params": params, "batch_stats": batch_stats}))
    for name, value in ref.items():
        assert torch.equal(state[name], value), name
    adam = adam_state_to_optax(optimizer, model.module)
    assert int(adam["count"]) == 2
    for field in ("mu", "nu"):
        mine = _flat(adam[field])
        for path, value in _flat(jax.device_get(getattr(opt_state, field))).items():
            np.testing.assert_array_equal(mine[path], value, err_msg=f"{field} {path}")
    for p in model.module.parameters():
        p.grad = torch.ones_like(p)
    optimizer.step()
    assert int(adam_state_to_optax(optimizer, model.module)["count"]) == 3


def test_keep_prunes_old_checkpoints(tmp_path):
    """``keep`` newest files stay; both packages read the marker."""
    module, optimizer = _port_state(steps=0)
    for epoch in range(1, 6):
        ckpt.save_checkpoint(tmp_path, epoch, ckpt.training_state(module, optimizer, epoch, 0),
                             keep=2)
    assert [p.name for p in sorted(tmp_path.glob("ckpt_*.msgpack"))] == [
        "ckpt_00004.msgpack", "ckpt_00005.msgpack"]
    assert ckpt.latest_checkpoint(tmp_path) == jax_ckpt.latest_checkpoint(tmp_path) == 5
    assert ckpt.latest_checkpoint(tmp_path / "none") is None
    assert int(ckpt.restore_checkpoint(tmp_path, 4)["epoch"]) == 4


def test_trainer_checkpoints_and_resumes(tmp_path, monkeypatch):
    """As the JAX package's ``test_trainer_checkpoints_and_resumes``: two
    epochs with ``checkpoint_every=1`` leave ``latest`` at 2; a fresh model
    (another seed) with ``resume=True, epochs=3`` runs only epoch 3, at
    epoch 3's learning rate, from the restored state: its weights, running
    statistics, Adam state and step counter equal the checkpoint's bit for
    bit at the start of epoch 3. The epoch-3 checkpoint counts the steps
    of all three epochs."""
    from recognizer3d_tpu_torch.training import trainer as trainer_module
    from recognizer3d_tpu_torch.utils.tb import JsonlSummaryWriter

    monkeypatch.setattr(trainer_module, "make_summary_writer", JsonlSummaryWriter)
    clouds = _clouds(0, 6)
    settings = TrainingSettings(epochs=2, batch_size=2, early_stopping=False,
                                checkpoint_every=1)
    model = Model(RandLANetSettings(**TINY), device="cpu", seed=0)
    model.train(clouds[:4], clouds[4:], settings, log_dir=tmp_path / "run", class_names=NAMES)
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert ckpt.latest_checkpoint(ckpt_dir) == 2
    saved = ckpt.restore_checkpoint(ckpt_dir, 2)
    assert saved["step"] == 4 and int(saved["opt_state"]["count"]) == 4

    restored = {}
    load = ckpt.load_training_state

    def spy(state, module, optimizer):
        out = load(state, module, optimizer)
        restored["state"] = ckpt.training_state(module, optimizer, *out)
        return out

    monkeypatch.setattr(ckpt, "load_training_state", spy)
    lrs, step_lr = [], trainer_module.step_lr
    monkeypatch.setattr(trainer_module, "step_lr",
                        lambda s, epoch: lrs.append(epoch) or step_lr(s, epoch))
    epochs_seen = []
    model2 = Model(RandLANetSettings(**TINY), device="cpu", seed=1)
    settings2 = TrainingSettings(epochs=3, batch_size=2, early_stopping=False,
                                 checkpoint_every=1, resume=True)
    model2.train(clouds[:4], clouds[4:], settings2, log_dir=tmp_path / "run", class_names=NAMES,
                 callbacks=[lambda e, m: epochs_seen.append(e)])
    assert epochs_seen == [3] and lrs == [3]
    got, ref = _flat(restored["state"]), _flat(saved)
    assert sorted(got) == sorted(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)
    third = ckpt.restore_checkpoint(ckpt_dir, 3)
    assert third["step"] == 6 and int(third["opt_state"]["count"]) == 6
