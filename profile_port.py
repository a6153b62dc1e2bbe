#!/usr/bin/env python3
"""Where a live frame's time goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_port.py [app|approx64k|live|train|app-bf16|approx64k-bf16 ...]

For each path named (the first four by default): the app path is
``Predictor(pretrained/mock_fingertip)`` on mock frames of 60,000 points;
approx64k is the reference-default ``knn="approximate"`` at 65,536 points
(the bundled weights with ``bench.py``'s ``settings64a``, saved under
``build/`` as ``chip_smoke.py`` does) on mock frames of 150,000 points;
app-bf16 and approx64k-bf16 are the same two with
``compute_dtype="bfloat16"`` (saved under ``build/`` as ``chip_smoke.py``
does);
live is the depth-camera tick, ``LivePredictor`` of the bundled archive at
the L515's 1024×768 intrinsics and 16,384 display points, on z16 frames
made from mock frames of 60,000 points; train is one app-config train
step (``training/trainer.train_step``: train-mode forward, dice loss,
backward, Adam) of batch 4 × 2,500 points, batches assembled on the card
from the annotated mock dataset ``chip_smoke.py``'s train phase writes
under ``build/``, each step ending in a read of its loss.
Each path's predictor is warmed up on 5 frames, then its frames (20 of the
app and live paths, 10 of approx64k) are timed untraced, every path before
any tracing, and then traced with ``torch.profiler`` (CPU and CUDA
activity); the script prints: the wall time per frame, the device time per
frame summed over kernels and copies, the device's idle share of the
traced wall time, the device kernels and copies per frame, the host's
``cudaLaunchKernel`` calls per frame, and the operators and kernels with
the most device time. The card's name and power
limit come first.
"""

import statistics
import subprocess
import sys
import time

import numpy as np

from chip_smoke import (
    APPROX_ARCHIVE,
    APPROX_BF16_ARCHIVE,
    APPROX_FRAME_POINTS,
    APPROX_SETTINGS,
    ARCHIVE,
    BF16_ARCHIVE,
    FRAME_POINTS,
    LIVE_DISPLAY,
    _gpu_line,
    _make_frame,
    _train_batches,
    _write_train_dataset,
)

FRAMES = 20
TOP = 25


def _time(torch, predict, frames, label: str) -> None:
    for frame in frames[:5]:
        predict(frame)
    torch.cuda.synchronize()
    walls = []
    for frame in frames:
        t = time.perf_counter()
        predict(frame)
        walls.append((time.perf_counter() - t) * 1e3)
    q1, q2, q3 = statistics.quantiles(walls, n=4)
    shape = tuple(frames[0][0].shape) if isinstance(frames[0], tuple) else frames[0].shape
    print(f"{label}: untraced wall per frame over {len(frames)} frames of shape "
          f"{shape}: p25 {q1:.3f} ms, p50 {q2:.3f} ms, "
          f"p75 {q3:.3f} ms, min {min(walls):.3f} ms", flush=True)


def _profile(torch, predict, frames, label: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for frame in frames:
            predict(frame)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t) * 1e3 / len(frames)
    events = prof.key_averages()
    # kernels and copies; a user annotation's device range (the optimizer
    # step's ``Optimizer.step#Adam.step``) spans its kernels and the gaps
    # between them, and is no device work of its own
    device = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
    ]
    device_us = sum(e.self_device_time_total for e in device)
    if device_us == 0:
        print(f"{label}: device time: not measured (the profiler recorded no CUDA activity)")
        return
    device_ms = device_us / 1e3 / len(frames)
    device_ops = sum(e.count for e in device)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"{label}: traced wall per frame {traced_wall:.3f} ms; device time per frame "
          f"{device_ms:.3f} ms; device idle share {1 - device_ms / traced_wall:.3f}; "
          f"{device_ops / len(frames):.1f} device kernels and copies per frame; "
          f"{launches / len(frames):.1f} cudaLaunchKernel per frame", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=TOP,
                       max_name_column_width=60), flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=TOP,
                       max_name_column_width=60), flush=True)


def _train_data(torch, make_frame):
    _write_train_dataset(make_frame)
    return _train_batches(torch, FRAMES)


def _train_step_fn(torch):
    """One app-config train step on a fresh seed-0 model, ending in a read
    of its loss (as a frame ends in its mask)."""
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.train import app_model_config
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step

    module = Model(app_model_config()).module
    module.train()
    opt = make_optimizer(module, 1e-2)
    criterion = losses.get_loss("dice")
    return lambda batch: float(train_step(module, opt, criterion, *batch)[0])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_port: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model, Predictor
    from recognizer3d_tpu_torch.data import pipeline
    from recognizer3d_tpu_torch.models.live import LivePredictor

    paths = sys.argv[1:] or ["app", "approx64k", "live", "train"]
    print(f"gpu: {_gpu_line()}", flush=True)
    make_frame = _make_frame()
    runs = []
    for path in paths:
        if path == "train":
            runs.append((_train_step_fn(torch), _train_data(torch, make_frame), path))
            continue
        if path in ("app", "live"):
            archive, points, frames = ARCHIVE, FRAME_POINTS, FRAMES
        elif path == "approx64k":
            Model.load(ARCHIVE, device="cuda", **APPROX_SETTINGS).save(APPROX_ARCHIVE)
            archive, points, frames = APPROX_ARCHIVE, APPROX_FRAME_POINTS, FRAMES // 2
        elif path == "app-bf16":
            Model.load(ARCHIVE, device="cuda", compute_dtype="bfloat16").save(BF16_ARCHIVE)
            archive, points, frames = BF16_ARCHIVE, FRAME_POINTS, FRAMES
        elif path == "approx64k-bf16":
            Model.load(ARCHIVE, device="cuda", compute_dtype="bfloat16",
                       **APPROX_SETTINGS).save(APPROX_BF16_ARCHIVE)
            archive, points, frames = APPROX_BF16_ARCHIVE, APPROX_FRAME_POINTS, FRAMES // 2
        else:
            raise SystemExit(f"profile_port: unknown path {path!r}")
        clouds = [
            make_frame(np.random.RandomState(200 + i), 0.3 * i, points)[0]
            for i in range(frames)
        ]
        if path == "live":
            intr = pipeline.DepthIntrinsics()
            live = LivePredictor(Model.load(archive, device="cuda"), n_display=LIVE_DISPLAY,
                                 intrinsics=intr)
            depths = [pipeline.cloud_to_depth(c, intr) for c in clouds]
            runs.append((live.predict_depth, depths, path))
        else:
            runs.append((Predictor(archive, warmup_points=points).predict, clouds, path))
    # every untraced timing first: a profiler session slows the launches
    # that follow it in the process
    for run in runs:
        _time(torch, *run)
    for run in runs:
        _profile(torch, *run)
    subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                    "--format=csv"], check=False, timeout=60)


if __name__ == "__main__":
    main()
