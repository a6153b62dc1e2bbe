"""The port's training loop against the JAX package: ``Trainer.evaluate``
and ``Model.evaluate`` on the same weights and data, and a two-epoch
``Model.train`` on the CPU through both input paths, whose saved archive
the JAX package loads and predicts with as the port does.

JAX's side runs ``knn="pallas"`` (its Pallas KNN kernel in interpret mode),
whose direct differences pick the same neighbours as the port's exact
search; the port runs ``knn="naive"``.
"""

import functools
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from recognizer3d_tpu.models import randlanet as jax_rl
from recognizer3d_tpu.models.facade import Model as JaxModel
from recognizer3d_tpu.models.settings import RandLANetSettings as JaxSettings
from recognizer3d_tpu.training import metrics as jax_metrics
from recognizer3d_tpu.training.trainer import Trainer as JaxTrainer
from recognizer3d_tpu.data.loader import get_data_loader as jax_get_data_loader
from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.data.loader import get_data_loader
from recognizer3d_tpu_torch.models.weights import from_flax_variables
from recognizer3d_tpu_torch.training.settings import TrainingSettings
from recognizer3d_tpu_torch.training import trainer as trainer_module
from recognizer3d_tpu_torch.training.trainer import Trainer
from recognizer3d_tpu_torch.utils.tb import JsonlSummaryWriter

SMALL = dict(n_classes=2, n_features=0, knn="naive", n_points=256, n_neighbors=8,
             decimation=4, layer_sizes=[16, 64])
NAMES = ["background", "fingerpoint"]


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _clouds(seed, n_clouds, n=400):
    """Clouds with a learnable class: a dense blob labelled 1 in a plane."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_clouds):
        plane = np.c_[rng.rand(n - 60, 2), 0.02 * rng.randn(n - 60)]
        blob = 0.03 * rng.randn(60, 3) + [rng.rand(), rng.rand(), 0.1]
        xyz = np.r_[plane, blob].astype(np.float32)
        labels = np.r_[np.zeros(n - 60), np.ones(60)].astype(np.uint8)
        order = rng.permutation(n)
        out.append((xyz[order], np.zeros((n, 0)), labels[order]))
    return out


def _jax_model(seed=0):
    """A JAX facade Model on the ``knn="pallas"`` route with weights drawn
    by a jitted init of the same network on the ``"naive"`` route (the
    variables do not depend on the route; the facade's own init would run
    the interpret-mode kernel op by op), running statistics shifted away
    from their init so that eval mode reads them."""
    settings = JaxSettings(**SMALL)
    n = settings.min_n_points
    net = jax_rl.RandLANet(settings)
    variables = jax.jit(functools.partial(net.init, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, n, 3)), jnp.arange(n, dtype=jnp.int32)
    )
    variables = jax.tree.map(np.array, jax.device_get(variables))
    rng = np.random.RandomState(seed)

    def shift(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                shift(value)
            else:
                value += (0.2 if key == "mean" else 0.5) * rng.rand(*value.shape).astype(np.float32)

    shift(variables["batch_stats"])
    return JaxModel(JaxSettings(**dict(SMALL, knn="pallas")), weights=variables), variables


def _assert_metrics_close(got, ref):
    assert list(got) == list(ref)
    for key in ref:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(ref[key], np.float64), rtol=0, atol=1e-5,
                                   err_msg=key)


def test_evaluate_matches_jax():
    """Model.evaluate (the 10-seed protocol over a consistent, unshuffled
    loader, a ragged last batch) and Trainer.evaluate with postprocess
    (batch 1, predictions upsampled onto the raw clouds) on the same
    weights: the same keys, every value (loss, accuracies, IoUs, their
    standard deviations) within 1e-5."""
    jax_model, variables = _jax_model()
    port = Model(RandLANetSettings(**SMALL), weights=from_flax_variables(variables),
                 device="cpu")
    data = _clouds(1, 3)
    ref = jax_model.evaluate(data, NAMES, batch_size=2, include_stdev=True)
    got = port.evaluate(data, NAMES, batch_size=2, include_stdev=True)
    _assert_metrics_close(got, ref)
    assert 0 < got["mIoU"][0] < 1

    ref_bag = JaxTrainer.evaluate(jax_model, jax_get_data_loader(data[:2], 256, 1), NAMES,
                                  "cross_entropy", postprocess=True, n_evaluations=2)
    got_bag = Trainer.evaluate(port, get_data_loader(data[:2], 256, 1), NAMES,
                               "cross_entropy", postprocess=True, n_evaluations=2)
    _assert_metrics_close(got_bag.as_dict("val", include_stdev=True),
                          ref_bag.as_dict("val", include_stdev=True))


def _jax_metric_keys():
    """The keys the JAX trainer hands its callbacks, from its own
    collectors."""
    mc = jax_metrics.MetricCollector(NAMES)
    mc.push(0.0, 0.0, [0.0, 0.0], 0.0, [0.0, 0.0])
    keys = list(mc.as_dict())
    keys += list(jax_metrics.MetricCollectorBag([mc], NAMES).as_dict("val"))
    return keys


@pytest.mark.parametrize("device_pipeline", [False, True])
def test_two_epoch_train_on_cpu(tmp_path, monkeypatch, device_pipeline):
    """Model.train for two epochs (host loader, or the device pipeline on
    the CPU), early stopping watching val_mIoU: the losses finite, the
    callbacks given the JAX trainer's metric keys, the best epoch's weights
    restored, the per-epoch scalars logged (through the JSONL writer, as on
    the card's machine, which has no tensorboard), and the saved archive
    loads in the JAX package, whose predictions on a 700-point cloud equal
    the port's within 1e-4."""
    monkeypatch.setattr(trainer_module, "make_summary_writer", JsonlSummaryWriter)
    np.random.seed(0)
    model = Model(RandLANetSettings(**SMALL), device="cpu", seed=1)
    seen = []

    def callback(epoch, metrics):
        state = {k: v.clone() for k, v in model.module.state_dict().items()}
        seen.append((epoch, dict(metrics), state))

    settings = TrainingSettings(epochs=2, batch_size=2, early_stopping=True,
                                early_stopping_patience=5, device_pipeline=device_pipeline)
    trainer = model.train(_clouds(2, 5), _clouds(3, 2), settings, log_dir=tmp_path / "log",
                          class_names=NAMES, callbacks=[callback])
    assert [s[0] for s in seen] == [1, 2]
    assert [h["steps"] for h in trainer.history] == [3, 3]
    assert [h["metrics"] for h in trainer.history] == [s[1] for s in seen]
    for _, metrics, _ in seen:
        assert list(metrics) == _jax_metric_keys()
        assert all(math.isfinite(float(v)) for v in metrics.values())
    best = max(range(2), key=lambda i: (seen[i][1]["val_mIoU"], i))
    for key, value in model.module.state_dict().items():
        assert torch.equal(value, seen[best][2][key]), key
    assert not model.module.training
    scalars = [json.loads(line) for line in (tmp_path / "log" / "scalars.jsonl").open()]
    assert [s["step"] for s in scalars if s["tag"] == "Learning rate"] == [1, 2]
    assert {s["tag"] for s in scalars} >= {"mIoU/Train", "mIoU/Validation", "loss/Train"}

    path = tmp_path / "model"
    model.save(path)
    jax_model = JaxModel.load(path, knn="pallas")
    cloud = _clouds(4, 1, n=700)[0][0]
    np.random.seed(5)
    ref = jax_model.predict(cloud)
    np.random.seed(5)
    got = Model.load(path, device="cpu").predict(cloud)
    assert got.shape == ref.shape == (2, 700)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("field,value", [("data_parallel_devices", 2)])
def test_trainer_refuses_what_is_not_ported(field, value):
    model = Model(RandLANetSettings(**SMALL), device="cpu")
    settings = TrainingSettings(epochs=1, **{field: value})
    dl = get_data_loader(_clouds(0, 2), 256, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Trainer(dl, dl).train(model, settings)


def test_run_training_recipe_on_cpu(tmp_path, monkeypatch):
    """The port's ``train.run_training`` end to end on the CPU, at the small
    config in place of the app's: two dataset directories with broadened
    annotations merged and split (8 / 2), one epoch on the device
    pipeline, the archive saved under ``models_dir`` and the scalars under
    ``log_root``; the JAX package loads the archive to the trained state,
    and the progress queue gets 100."""
    from datetime import datetime, timedelta

    from recognizer3d_tpu_torch import train as port_train
    from recognizer3d_tpu_torch.data.dataset import Dataset

    monkeypatch.setattr(port_train, "app_model_config", lambda: RandLANetSettings(**SMALL))
    monkeypatch.setattr(trainer_module, "make_summary_writer", JsonlSummaryWriter)
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    for d, seed in (("a", 5), ("b", 6)):
        ds = Dataset(tmp_path / d)
        for i, (xyz, _, labels) in enumerate(_clouds(seed, 5)):
            ds[t0 + timedelta(seconds=i)] = xyz
            ds.set_annotation(t0 + timedelta(seconds=i), labels)

    class Queue(list):
        put = list.append

    progress = Queue()
    np.random.seed(0)
    path, model, trainer = port_train.run_training(
        [tmp_path / "a", tmp_path / "b"], progress,
        training=TrainingSettings(epochs=1, batch_size=4, early_stopping=False,
                                  device_pipeline=True),
        models_dir=tmp_path / "models", log_root=tmp_path / "log", device="cpu",
    )
    assert progress == [100]
    assert path.parent == tmp_path / "models" and path.is_file()
    assert [h["steps"] for h in trainer.history] == [2]
    assert list((tmp_path / "log").glob("*/scalars.jsonl"))
    state = model.module.state_dict()
    ref = from_flax_variables(jax.device_get(JaxModel.load(path).variables))
    assert sorted(ref) == sorted(state)
    for key, value in ref.items():
        np.testing.assert_array_equal(value.numpy(), state[key].numpy(), err_msg=key)
