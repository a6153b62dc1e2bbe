"""The port's profiler ranges, on the CPU under ``torch.profiler``: the
serving entry points record ``r3d.prep`` then ``r3d.forward`` once a call,
a training epoch on the device pipeline one ``r3d.train.batch`` before each
``r3d.train.step`` with ``r3d.forward`` inside the step, and each path
returns with no profiler attached what the same seeded call returns under
one."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from recognizer3d_tpu_torch import Model, RandLANetSettings
from recognizer3d_tpu_torch.models import facade
from recognizer3d_tpu_torch.training.settings import TrainingSettings

SMALL = dict(n_classes=2, n_features=0, knn="naive", n_points=256, n_neighbors=8,
             decimation=4, layer_sizes=[16, 64])
NAMES = ["background", "foreground"]


@pytest.fixture(autouse=True)
def _restore_global_numpy_rng():
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _ranges(prof):
    """The ``r3d.`` ranges the session recorded, as (name, start, end) in
    the order they opened."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("r3d.")), key=lambda r: r[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _ranges(prof)


def _clouds(seed, n_clouds, n=400):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_clouds):
        xyz = rng.rand(n, 3).astype(np.float32)
        out.append((xyz, np.zeros((n, 0), np.float32), (xyz[:, 0] > 0.5).astype(np.uint8)))
    return out


def _calls(model, method, inputs, seeds, **kwargs):
    outs = []
    for seed in seeds:
        np.random.seed(seed)
        outs.append(getattr(model, method)(inputs, **kwargs))
    return outs


def test_predict_mask_records_prep_then_forward_once_a_call():
    model = Model(RandLANetSettings(**SMALL), device="cpu", seed=3)
    batch = np.stack([c[0] for c in _clouds(1, 2)])
    plain = _calls(model, "predict_mask", batch, (7, 8))
    traced, ranges = _traced(lambda: _calls(model, "predict_mask", batch, (7, 8)))
    assert [r[0] for r in ranges] == ["r3d.prep", "r3d.forward"] * 2
    assert all(a[2] <= b[1] for a, b in zip(ranges, ranges[1:]))  # one after the other
    for got, want in zip(traced, plain):
        np.testing.assert_array_equal(got, want)


def test_large_predict_records_prep_then_forward(monkeypatch):
    """``predict(prepostprocess=False)`` past the large-forward threshold:
    ``r3d.prep``, then ``forward_eval_large``'s ``r3d.forward``."""
    monkeypatch.setattr(facade, "_LARGE_FORWARD_MIN", 200)
    calls = []
    orig = facade.forward_eval_large
    monkeypatch.setattr(facade, "forward_eval_large",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    model = Model(RandLANetSettings(**SMALL), device="cpu", seed=3)
    room = _clouds(2, 1, n=256)[0][0]
    plain = _calls(model, "predict", room, (5,), prepostprocess=False)
    traced, ranges = _traced(lambda: _calls(model, "predict", room, (5,),
                                            prepostprocess=False))
    assert len(calls) == 2
    assert [r[0] for r in ranges] == ["r3d.prep", "r3d.forward"]
    assert ranges[0][2] <= ranges[1][1]
    np.testing.assert_array_equal(traced[0], plain[0])


def _train(seed):
    np.random.seed(seed)
    model = Model(RandLANetSettings(**SMALL), device="cpu", seed=1)
    settings = TrainingSettings(epochs=1, batch_size=2, early_stopping=False,
                                device_pipeline=True)
    trainer = model.train(_clouds(2, 5), _clouds(3, 2), settings, class_names=NAMES)
    return model, trainer


def test_a_device_pipeline_epoch_records_a_batch_before_each_step():
    """One epoch of 3 steps: each ``r3d.train.step`` follows its one
    ``r3d.train.batch`` and holds one ``r3d.forward``; one more batch range
    closes the epoch (the fetch that finds it spent), and the validation's
    forwards run outside every step."""
    plain_model, plain = _train(4)
    (model, trainer), ranges = _traced(lambda: _train(4))
    assert [h["steps"] for h in trainer.history] == [3]
    outer = [r for r in ranges if r[0] in ("r3d.train.batch", "r3d.train.step")]
    assert [r[0] for r in outer] == ["r3d.train.batch", "r3d.train.step"] * 3 + [
        "r3d.train.batch"]
    assert all(a[2] <= b[1] for a, b in zip(outer, outer[1:]))  # closed before the next
    forwards = [r for r in ranges if r[0] == "r3d.forward"]
    for _, s, e in (r for r in outer if r[0] == "r3d.train.step"):
        assert sum(s <= f[1] and f[2] <= e for f in forwards) == 1
    assert len(forwards) > 3  # the validation's
    assert trainer.history[0]["step_losses"] == plain.history[0]["step_losses"]
    for key, value in model.module.state_dict().items():
        assert torch.equal(value, plain_model.module.state_dict()[key]), key
