"""A whole run on the CPU at a tiny size: everything but the look for a card.
A sound program comes out correct; the program broken underneath, in each
way a cell's timed path can be, comes out not correct. Without a card the
command exits with code 2 and prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run, spec

ROOT = Path(__file__).resolve().parents[2]
BASE = dict(n_classes=2, n_features=0, n_neighbors=32, decimation=4,
            layer_sizes=[16, 64, 128, 256], knn="naive", upsampling="nni",
            compute_dtype="float32")


def _limits(cell):
    return json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())


def serve_cell():
    return spec.Cell("tiny-serve", dict(BASE, n_points=2048),
                     dict(kind="serve", batch=2, captures=4, capture_points=3000, scale=0.2,
                          threshold=0.5, verify_calls=2, trace_calls=1),
                     _limits("rl64k-serve-b8"), 1,
                     [dict(name="clouds_per_s", unit="clouds/s"), dict(name="setup_s", unit="s")],
                     [dict(name="batch_p50_ms.serve", unit="ms"), dict(name="mfu.serve", unit="%")])


def scan_cell():
    return spec.Cell("tiny-scan", dict(BASE, n_points=2048),
                     dict(kind="scan", rooms=2, room_points=2048, scale=0.2, verify_calls=1,
                          trace_calls=1),
                     _limits("rl1m-scan"), 1,
                     [dict(name="scans_per_s", unit="scans/s"),
                      dict(name="scan_p90_ms", unit="ms"), dict(name="setup_s", unit="s")],
                     [dict(name="scan_p50_ms.scan", unit="ms")])


def _run(cell, capsys, traced=False):
    torch.set_num_threads(2)
    assert run.execute(cell, 2**31 + 77, 0.5, traced, device="cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("make", [serve_cell, scan_cell])
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(make, traced, capsys):
    out = _run(make(), capsys, traced)
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {m["name"] for m in
                                   (make().per_layer if traced else make().end_to_end)}


def _half_batch(predict_mask):
    def broken(self, xyz, threshold=0.5, features=None):
        half = predict_mask(self, xyz[: len(xyz) // 2], threshold)
        return np.concatenate([half, half])[: len(xyz)]
    return broken


def _flip(predict_mask):
    def broken(self, xyz, threshold=0.5, features=None):
        mask = predict_mask(self, xyz, threshold)
        mask[:, ::50] = ~mask[:, ::50]
        return mask
    return broken


def _shift(predict):
    def broken(self, xyz, features=None, prepostprocess=True):
        return predict(self, xyz, prepostprocess=prepostprocess) + 1e-3
    return broken


@pytest.mark.parametrize("make,method,fault", [
    (serve_cell, "predict_mask", _half_batch),
    (serve_cell, "predict_mask", _flip),
    (scan_cell, "predict", _shift),
])
def test_a_broken_program_is_not_correct(make, method, fault, capsys, monkeypatch):
    from recognizer3d_tpu_torch.models.facade import Model

    monkeypatch.setattr(Model, method, fault(getattr(Model, method)))
    assert _run(make(), capsys)["correct"] is False


def test_without_a_card_the_run_exits_2_and_prints_nothing():
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rl64k-serve-b8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 2 and res.stdout == ""


def train_cell():
    traffic = json.loads((ROOT / "portbench" / "traffic" / "train-b4.json").read_text())
    traffic.update(train_clouds=8, val_clouds=4, cloud_points=2500, verify_steps=2)
    return spec.Cell("tiny-train", dict(BASE, n_points=2048), traffic,
                     _limits("rl64k-train-b4"), 1,
                     [dict(name="train_step_ms", unit="ms"), dict(name="setup_s", unit="s")],
                     [dict(name="validate_share.train", unit="%")])


def test_a_sound_training_run_is_correct(capsys):
    out = _run(train_cell(), capsys)
    assert out["correct"] is True
    assert set(out["checks"]) == set(_limits("rl64k-train-b4"))
    assert out["metrics"]["train_step_ms"]["value"] > 0


def _unchanged(train_step):
    def broken(module, optimizer, criterion, inputs, labels, permutation, keep_mask,
               backend=None):
        saved = {k: v.detach().clone() for k, v in module.state_dict().items()}
        out = train_step(module, optimizer, criterion, inputs, labels, permutation, keep_mask)
        module.load_state_dict(saved)
        return out
    return broken


def _half_of_the_batch(train_step):
    def broken(module, optimizer, criterion, inputs, labels, permutation, keep_mask,
               backend=None):
        # the first half twice: the loss and gradients are the first half's
        h = len(inputs) // 2

        def twice(x):
            return torch.cat([x[:h], x[:h]])
        return train_step(module, optimizer, criterion, twice(inputs), twice(labels),
                          permutation, twice(keep_mask))
    return broken


def _labels_altered(train_step):
    def broken(module, optimizer, criterion, inputs, labels, permutation, keep_mask,
               backend=None):
        labels = labels.clone()
        labels[:, ::10] = 1 - labels[:, ::10]
        return train_step(module, optimizer, criterion, inputs, labels, permutation, keep_mask)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_of_the_batch, _labels_altered])
def test_a_broken_train_step_is_not_correct(fault, capsys, monkeypatch):
    from recognizer3d_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "train_step", fault(trainer.train_step))
    assert _run(train_cell(), capsys)["correct"] is False
