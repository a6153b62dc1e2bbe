"""The traffic generators: one driver for each ``kind`` a traffic file names,
reading the rest of its parameters from that file.

A driver makes every input in set-up, from the run's seed, on the device in
large draws; builds the program's model on seeded weights
(:mod:`portbench.weights`); warms up the one shape its calls use; then serves
``call(j)``, the j-th call of the closed loop, keeping what the call
returned. After the window, :meth:`verify` draws a sample of the calls from
the seed and compares each with the plain reference
(:mod:`portbench.reference`).

Each call's random-sampling permutation is the program's own draw from the
global numpy generator, which the driver seeds before the call
(:func:`call_seed`), so the reference draws the same permutation again.
"""

import logging
import math
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from portbench import trace, weights
from portbench.reference import model as ref

Check = Tuple[str, float, float]  # (name, number compared, limit)


def call_seed(seed: int, j: int) -> int:
    return (seed * 1_000_003 + j + 7) % 2**32


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 8 + stream) % 2**63)
    return g


def settings(cfg: dict):
    from recognizer3d_tpu_torch.models.settings import RandLANetSettings

    fields = RandLANetSettings.__dataclass_fields__
    return RandLANetSettings(**{k: v for k, v in cfg.items() if k in fields})


def reference_mode(tf32: bool) -> None:
    """The reference's matmul precision: float32 (TF32 off), or TF32 for the
    control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@dataclass
class Window:
    """What a run's window gave: when set-up ended (host clock), the calls
    completed in it and its length, the calls that failed, each call's wall
    seconds (where calls are timed one by one), and the traced session that
    followed it, over ``traced_calls`` calls."""

    setup_end: float
    calls: int
    window_s: float
    failed: int
    times: List[float]
    trace: Optional["trace.Trace"] = None
    traced_calls: int = 0


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100.0
    lo = int(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def closed_loop(driver, seconds: float):
    """Calls 0, 1, ... until ``seconds`` have passed; returns (the calls'
    wall seconds, the window's length, calls failed)."""
    times, failed, sync = [], 0, driver.device.type == "cuda"
    t_start = time.perf_counter()
    j = 0
    while True:
        t = time.perf_counter()
        try:
            driver.call(j)
        except Exception as exc:  # noqa: BLE001 — a failed call is counted, the loop goes on
            print(f"call {j} failed: {exc!r}", file=sys.stderr)
            failed += 1
        if sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        times.append(now - t)
        j += 1
        if now - t_start >= seconds:
            return times, now - t_start, failed


class Driver:
    """Closed loop over one kind of call. ``clouds_per_call``: the clouds a
    call completes (the traffic's ``batch``, else 1)."""

    def __init__(self, cfg: dict, traffic: dict, limits: dict, seed: int, device):
        self.cfg, self.traffic, self.limits = cfg, traffic, limits
        self.clouds_per_call = traffic.get("batch", 1)
        self.seed, self.device = seed, torch.device(device)
        self.outputs = {}
        self.model = None
        self.params = None

    def build(self) -> None:
        from recognizer3d_tpu_torch.models.facade import Model

        self.model = Model(settings(self.cfg), weights=self.params, device=self.device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def run(self, seconds: float, traced: bool) -> Window:
        """Set-up, the closed loop for ``seconds``, and with ``traced`` the
        traffic's ``trace_calls`` further calls under the profiler."""
        self.setup()
        self.sync()
        setup_end = time.perf_counter()
        times, window_s, failed = closed_loop(self, seconds)
        win = Window(setup_end, len(times), window_s, failed, times)
        if traced:
            win.traced_calls = self.traffic["trace_calls"]
            session = trace.Session()
            session.start()
            for j in range(win.calls, win.calls + win.traced_calls):
                with torch.profiler.record_function("portbench.call"):
                    self.call(j)
            win.trace = session.stop()
        return win

    def end_to_end(self, win: Window) -> dict:
        return {"clouds_per_s": win.calls * self.clouds_per_call / win.window_s,
                "scans_per_s": win.calls / win.window_s,
                "scan_p90_ms": percentile(win.times, 90) * 1e3}

    def reading_extra(self, win: Window) -> dict:
        return {}

    def release(self) -> None:
        """Drop the program's state (its model and caches)."""
        self.model = None
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, numbers: dict) -> List[Check]:
        """The numbers that the cell's limits file gives a limit, beside it."""
        return [(k, v, self.limits[k]) for k, v in numbers.items()
                if self.limits.get(k) is not None]

    def verify(self) -> List[Check]:
        return self.checks(self.numbers())

    def sample(self, count: int) -> List[int]:
        """``count`` of the calls that returned, drawn from the seed."""
        done = sorted(self.outputs)
        rs = np.random.RandomState(call_seed(self.seed, -1000))
        return sorted(done[i] for i in rs.choice(len(done), min(count, len(done)), replace=False))


class Serve(Driver):
    """``Model.predict_mask`` on batches of ``batch`` captures of
    ``capture_points`` points (``scale``·N(0, 1) clouds), cycled from a
    fixed set of ``captures`` made in set-up; each mask is thresholded at
    ``threshold``. Set-up centres the head's class-1 bias so that the
    threshold splits capture 0's confidences (by the reference) in half,
    as a trained model's mask splits a scene."""

    def setup(self) -> None:
        t, dev = self.traffic, self.device
        self.params = weights.make(self.cfg, self.seed, dev)
        g = generator(self.seed, 1, dev)
        caps = torch.randn((t["captures"], t["capture_points"], 3), generator=g, device=dev)
        caps = (caps * t["scale"]).cpu().numpy()
        b = t["batch"]
        self.batches = [np.ascontiguousarray(caps[i:i + b]) for i in range(0, len(caps), b)]
        self._centre_threshold(caps[0])
        self.build()
        for j in (-1, -2):
            self.call(j)
        self.outputs.clear()

    def _indices(self, n_full: int) -> np.ndarray:
        # the program's consistent subsample: the seed-0 draw without
        # replacement (numpy's global generator reseeded to 0)
        return np.random.RandomState(0).choice(n_full, self.cfg["n_points"], replace=False)

    def _permutation(self, j: int) -> torch.Tensor:
        perm = np.random.RandomState(call_seed(self.seed, j)).permutation(self.cfg["n_points"])
        return torch.from_numpy(perm).to(self.device)

    def _centre_threshold(self, capture: np.ndarray) -> None:
        reference_mode(False)
        x = torch.from_numpy(capture[self._indices(len(capture))]).to(self.device)
        with torch.no_grad():
            logits = ref.forward(self.params, self.cfg, x, self._permutation(-3))
        thr = self.traffic["threshold"]
        shift = math.log(thr / (1 - thr)) - float((logits[1] - logits[0]).median())
        self.params["fc_end_2.conv.bias"][1] += shift

    def call(self, j: int) -> None:
        np.random.seed(call_seed(self.seed, j))
        batch = self.batches[j % len(self.batches)]
        self.outputs[j] = self.model.predict_mask(batch, threshold=self.traffic["threshold"])

    def reference_masks(self, j: int, tf32: bool = False) -> np.ndarray:
        reference_mode(tf32)
        batch = self.batches[j % len(self.batches)]
        idx = self._indices(batch.shape[1])
        perm = self._permutation(j)
        masks = []
        with torch.no_grad():
            for cloud in batch:
                full = torch.from_numpy(cloud).to(self.device)
                conf = ref.confidences(self.params, self.cfg, full[idx], perm)
                up = ref.upsample_nearest(conf, full[idx], full)
                masks.append((up[1] > self.traffic["threshold"]).cpu().numpy())
        reference_mode(False)
        return np.stack(masks)

    def _mismatch(self, masks) -> dict:
        wrong = total = 0
        for j in self.sample(self.traffic["verify_calls"]):
            got = masks(j)
            wrong += int((got != self.reference_masks(j)).sum())
            total += got.size
        return {"mask_mismatch_share": wrong / max(total, 1)}

    def numbers(self) -> dict:
        """The share of the sampled calls' mask points that differ from the
        reference's masks."""
        return self._mismatch(self.outputs.__getitem__)

    def control(self) -> dict:
        """The same share with the reference in TF32 in the program's place."""
        return self._mismatch(lambda j: self.reference_masks(j, tf32=True))


class Scan(Driver):
    """``Model.predict(room, prepostprocess=False)`` on one room of
    ``room_points`` points (``scale``·N(0, 1)) at a time, cycled from
    ``rooms`` rooms made in set-up; the confidences come back to the host."""

    def setup(self) -> None:
        t, dev = self.traffic, self.device
        self.params = weights.make(self.cfg, self.seed, dev)
        g = generator(self.seed, 1, dev)
        rooms = torch.randn((t["rooms"], t["room_points"], 3), generator=g, device=dev)
        self.rooms = list((rooms * t["scale"]).cpu().numpy())
        del rooms
        self.build()
        for j in (-1, -2):
            self.call(j)
        self.outputs.clear()

    def call(self, j: int) -> None:
        np.random.seed(call_seed(self.seed, j))
        self.outputs[j] = self.model.predict(self.rooms[j % len(self.rooms)],
                                             prepostprocess=False)

    def reference_confidences(self, j: int, tf32: bool = False) -> np.ndarray:
        reference_mode(tf32)
        room = torch.from_numpy(self.rooms[j % len(self.rooms)]).to(self.device)
        perm = np.random.RandomState(call_seed(self.seed, j)).permutation(len(room))
        with torch.no_grad():
            conf = ref.confidences(self.params, self.cfg, room,
                                   torch.from_numpy(perm).to(self.device)).cpu().numpy()
        reference_mode(False)
        return conf

    def _gap(self, confidences) -> dict:
        gaps = [float(np.abs(confidences(j)[1] - self.reference_confidences(j)[1]).mean())
                for j in self.sample(self.traffic["verify_calls"])]
        return {"confidence_mean_gap": max(gaps)}

    def numbers(self) -> dict:
        """The mean gap of a sampled scan's class-1 confidences to the
        reference's (the largest over the sample)."""
        return self._gap(self.outputs.__getitem__)

    def control(self) -> dict:
        """The same gap with the reference in TF32 in the program's place."""
        return self._gap(lambda j: self.reference_confidences(j, tf32=True))


class _WindowClosed(Exception):
    """Raised from the epoch callback to end the training window."""


class Train(Driver):
    """``Trainer.train`` as the app's recipe sets it up (``train.run_training``:
    Adam, the StepLR schedule, Dice, batches assembled on the device, the
    10-pass validation after each epoch, one rank), with the traffic's
    ``batch``, ``learning_rate`` and augmentation, on ``train_clouds`` and
    ``val_clouds`` clouds of ``cloud_points`` points (``scale``·N(0, 1); class
    1 where x > ``foreground_x``) made in set-up.

    Epoch 1 (its steps and validation, every shape warmed up) is set-up; the
    window runs from its end to the end of the first epoch that ends after
    ``--seconds``; a traced run traces one more epoch. An optimizer hook
    keeps the first gradients (from Adam's state after step 1) and the
    parameters after step ``verify_steps``."""

    def setup(self) -> None:
        t, dev = self.traffic, self.device
        self.params = weights.make(self.cfg, self.seed, dev)
        g = generator(self.seed, 1, dev)
        n = t["train_clouds"] + t["val_clouds"]
        xyz = torch.randn((n, t["cloud_points"], 3), generator=g, device=dev) * t["scale"]
        labels = (xyz[..., 0] > t["foreground_x"]).long()
        self.train_xyz, self.train_labels = xyz[:t["train_clouds"]], labels[:t["train_clouds"]]
        host_xyz, host_labels = xyz.cpu().numpy(), labels.cpu().numpy()
        empty = np.zeros((t["cloud_points"], 0), np.float32)
        self.datasets = [[(host_xyz[i], empty, host_labels[i]) for i in rows] for rows in
                         (range(t["train_clouds"]), range(t["train_clouds"], n))]
        self.build()

    def _settings(self):
        from recognizer3d_tpu_torch.data.augmentation import AugmentationSettings
        from recognizer3d_tpu_torch.training.settings import TrainingSettings

        t = self.traffic
        aug = AugmentationSettings(**{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in t["augmentation"].items()})
        return TrainingSettings(epochs=10**9, batch_size=t["batch"],
                                learning_rate=t["learning_rate"], early_stopping=False,
                                device_pipeline=True, loss_function="dice"), aug

    def run(self, seconds: float, traced: bool) -> Window:
        from recognizer3d_tpu_torch.data.loader import get_data_loader
        from recognizer3d_tpu_torch.training.trainer import Trainer

        self.setup()
        settings, aug = self._settings()
        n = self.cfg["n_points"]
        trainer = Trainer(
            get_data_loader(self.datasets[0], n, settings.batch_size, shuffle=True,
                            consistent_sampling=False, augmentation_settings=aug),
            get_data_loader(self.datasets[1], n, settings.batch_size, shuffle=False,
                            consistent_sampling=True),
            None, ["background", "foreground"])
        names = {id(p): k for k, p in self.model.module.named_parameters()}
        steps, kept = [0], {}
        verify_steps = self.traffic["verify_steps"]

        def after_step(optimizer, args, kwargs):
            steps[0] += 1
            if steps[0] == 1:
                beta1 = optimizer.param_groups[0]["betas"][0]
                kept["grads"] = {names[id(p)]: optimizer.state[p]["exp_avg"] / (1 - beta1)
                                 for group in optimizer.param_groups for p in group["params"]}
            if steps[0] == verify_steps:
                kept["params"] = {names[id(p)]: p.detach().clone()
                                  for group in optimizer.param_groups for p in group["params"]}

        marks, session = {}, trace.Session()

        def at_epoch_end(epoch, metrics):
            self.sync()
            now = time.perf_counter()
            if epoch == 1:
                marks.update(setup_end=now, start=now, steps=steps[0], epoch=1)
            elif "end" not in marks and now - marks["start"] >= seconds:
                marks.update(end=now, window_steps=steps[0] - marks["steps"], last=epoch,
                             steps=steps[0])
                if not traced:
                    raise _WindowClosed
                session.start()
            elif "end" in marks:
                marks["trace"] = session.stop()
                marks["traced_steps"] = steps[0] - marks["steps"]
                raise _WindowClosed

        self.trainer = trainer
        hook = register_optimizer_step_post_hook(after_step)
        np.random.seed(call_seed(self.seed, 0))
        try:
            trainer.train(self.model, settings, callbacks=[at_epoch_end])
        except _WindowClosed:
            pass
        finally:
            hook.remove()
        self.kept = kept
        hist = trainer.history
        window = [h for h in hist if 1 < h["epoch"] <= marks["last"]]
        self.window_validate_s = sum(h["validate_s"] for h in window)
        self.step_losses = hist[0]["step_losses"]
        return Window(marks["setup_end"], marks["window_steps"], marks["end"] - marks["start"],
                      0, [], marks.get("trace"), marks.get("traced_steps", 0))

    def end_to_end(self, win: Window) -> dict:
        return {"train_step_ms": win.window_s / win.calls * 1e3}

    def reading_extra(self, win: Window) -> dict:
        t = self.traffic
        return {"window_s": win.window_s, "validate_s": self.window_validate_s,
                "traced_val_clouds": t["val_clouds"] * t["val_passes"] if win.trace else 0}

    def release(self) -> None:
        self.trainer = None
        super().release()

    def reference(self, tf32: bool = False):
        """The reference's (losses, first gradients, parameters after
        ``verify_steps``) from the same weights, clouds and seed."""
        from portbench.reference import train as ref_train

        reference_mode(tf32)
        t = self.traffic
        seed = int(np.random.RandomState(call_seed(self.seed, 0)).randint(0, 2**31 - 1))
        it = ref_train.batches(self.cfg, t["augmentation"], self.train_xyz, self.train_labels,
                               seed, t["batch"], t["verify_steps"])
        out = ref_train.train(self.params, self.cfg, it, t["learning_rate"], t["verify_steps"])
        reference_mode(False)
        return out

    def _gaps(self, losses, grads, params) -> dict:
        from portbench.reference import train as ref_train

        r_losses, r_grads, r_params = self.reference()
        out = {f"loss_gap_{i}": abs(a - b) / abs(b)
               for i, (a, b) in enumerate(zip(losses, r_losses), 1)}
        out["grad_norm_gap"] = ref_train.leaf_gap(grads, r_grads, list(r_grads))
        moved = ref_train.moved_leaves(r_grads)
        change = {k: params[k] - self.params[k] for k in moved}
        r_change = {k: r_params[k] - self.params[k] for k in moved}
        out["change_norm_gap"] = ref_train.leaf_gap(change, r_change, moved)
        return out

    def numbers(self) -> dict:
        """Each of the first ``verify_steps`` steps' loss, each leaf's first
        gradient norm and each moved leaf's change after the steps, against
        the reference's: the relative gap of each loss, the widest of the
        leaves' norms."""
        n = self.traffic["verify_steps"]
        return self._gaps(self.step_losses[:n], self.kept["grads"], self.kept["params"])

    def control(self) -> dict:
        """The same gaps with the reference in TF32 in the program's place."""
        losses, grads, params = self.reference(tf32=True)
        return self._gaps(losses, grads, params)


KINDS = {"serve": Serve, "scan": Scan, "train": Train}


def make(cfg: dict, traffic: dict, limits: dict, seed: int, device) -> Driver:
    logging.getLogger().setLevel(logging.ERROR)
    return KINDS[traffic["kind"]](cfg, traffic, limits, seed, device)
