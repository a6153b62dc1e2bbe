#!/usr/bin/env python3
"""Where a live frame's time goes in the PyTorch/CUDA port, on one GPU.

    python3 profile_port.py [app|approx64k|live|train|train-bf16|app-bf16|
                             approx64k-bf16|large-exact|large-approx|dp-serve|
                             sp-1m|dp-train|sp-train ...]
                            [--expect-window W]

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
under ``build/``, each step ending in a read of its loss; train-bf16 is the
same step with ``compute_dtype="bfloat16"``; large-exact and
large-approx are the large-scene forward of ``chip_smoke.py``'s phase 5e
(``Model.predict(cloud, prepostprocess=False)`` on the first 1,048,576-point
cloud of ``benchmarks/bench_large.py``, the bundled weights at that
n_points, ``knn="naive"`` or ``"approximate"``), 3 calls on that cloud;
dp-serve and sp-1m are ``chip_smoke.py``'s phases 5f and 5g: ``DPServing``
on two ranks sharing the card (a batch of 8 mock clouds of 60,000 points)
and ``SPServing`` on four (that 1,048,576-point cloud), each rank (a
process of its own) traced by its own profiler over the same calls, and
the card's busy time taken as the union of the ranks' device activity
(their kernels take turns on the card, so their durations do not add up);
dp-train and sp-train likewise trace ``chip_smoke.py``'s phases 7e and 7f:
one data-parallel step a call on two ranks (20 calls; the app config,
batches from the replicated device tables) and one point-sharded train step
a call on four (a 65,536-point cloud), and print each rank's host time in
the port's exchanges (the ranges ``r3d.all_reduce_sum``, ``r3d.rotate``,
``r3d.constrain``: staging, gloo and the wait for the other ranks).
Each path's predictor is warmed up on 5 frames, then its frames (20 of the
app and live paths, 10 of approx64k) are timed untraced, every path before
any tracing, and then traced with ``torch.profiler`` (CPU and CUDA
activity); the script prints: the wall time per frame, the device time per
frame summed over kernels and copies, the device's idle share of the
traced wall time, the device kernels and copies per frame, the host's
``cudaLaunchKernel`` calls per frame, and the operators and kernels with
the most device time. The card's name and power
limit come first.

The session recall guard of ``knn="approximate"`` is process-global and
only widens, so each approximate path (approx64k, approx64k-bf16,
large-approx) resets it
before its first frame, which the guard then probes; the frames are seeded,
so a path settles on the same window in every process. The script prints
each such path's window and exact fallback, and fails if a path is
profiled at another window than it settled on, or, with
``--expect-window W``, at another window than W: an A/B of two trees runs
both sides at one window.
"""

import argparse
import bisect
import statistics
import subprocess
import time

import numpy as np

from chip_smoke import (
    APPROX_ARCHIVE,
    APPROX_BF16_ARCHIVE,
    APPROX_FRAME_POINTS,
    APPROX_SETTINGS,
    ARCHIVE,
    BF16_ARCHIVE,
    DP_DEVICES,
    DP_TRAIN_DEVICES,
    FRAME_POINTS,
    LARGE_POINTS,
    LIVE_DISPLAY,
    SP_DEVICES,
    SP_TRAIN_DEVICES,
    SP_TRAIN_POINTS,
    TRAIN_DIR,
    _gpu_line,
    _make_frame,
    _train_batches,
    _write_train_dataset,
)

FRAMES = 20
LARGE_FRAMES = 3
TOP = 25
# the port's profiler ranges around the ranks' exchanges
RANGES = ("r3d.all_reduce_sum", "r3d.rotate", "r3d.constrain")
# the host's kernel-launch calls, runtime and driver, plain and extended
# (B8 and B1's walk launch through the extended forms)
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


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
    # step's ``Optimizer.step#Adam.step``, the port's ``r3d.`` ranges) spans
    # its kernels and the gaps between them, and is no device work of its own
    device = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)
        and not e.key.startswith("r3d.")
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
    print(f"{label}: the port's ranges per frame: {_port_ranges(torch, prof, len(frames))}",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=TOP,
                       max_name_column_width=60), flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=TOP,
                       max_name_column_width=60), flush=True)


def _port_ranges(torch, prof, frames: int) -> str:
    """For each ``r3d.`` range the host recorded: its count, the ms inside it
    in which no kernel or copy runs on the device, and the kernel launches
    that start inside it from any host thread (the backward's come from the
    autograd engine's), each a frame."""
    cpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    busy = _union([(e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("r3d.")])
    launches = sorted(e.time_range.start for e in cpu if e.name in LAUNCHES)
    parts = []
    for name in sorted({e.name for e in cpu if e.name.startswith("r3d.")}):
        count = sum(e.name == name for e in cpu)
        spans = _union([(e.time_range.start, e.time_range.end) for e in cpu if e.name == name])
        busy_in = sum(max(0, min(b, d) - max(a, c)) for a, b in spans for c, d in busy)
        idle_us = sum(b - a for a, b in spans) - busy_in
        n = sum(bisect.bisect_left(launches, b) - bisect.bisect_left(launches, a)
                for a, b in spans)
        parts.append(f"{name} {count / frames:.1f}x, device idle {idle_us / 1e3 / frames:.3f} ms, "
                     f"{n / frames:.1f} launches")
    return "; ".join(parts) or "none"


def _rank_profile(fn, calls: int, args, root=None):
    """On every rank of a serving pool: ``calls`` calls of the rank body
    ``fn(*args, root=root)`` traced by this rank's profiler, the ranks
    starting together (a barrier once every profiler runs). Returns (wall ms
    a call, device ms a call, ``cudaLaunchKernel`` a call, the TOP kernels
    and copies by device time as (name, ms a call, count a call), and the
    (start, end) ns of every device activity). Where ranks share a card
    their kernels take turns, and a kernel's duration counts the other
    ranks' turns that fall inside it."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    fn(*args, root=root)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if dist.is_initialized():
            dist.barrier()
        t = time.perf_counter()
        for _ in range(calls):
            fn(*args, root=root)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    events = prof.key_averages()
    # a user annotation's device range (the port's ``r3d.`` ranges, the
    # optimizer step) spans its kernels and the gaps between them: no
    # device work of its own
    annotations = {e.key for e in events
                   if e.key.startswith("r3d.") or getattr(e, "is_user_annotation", False)}
    device = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.key not in annotations),
                    key=lambda e: -e.self_device_time_total)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel") / calls
    top = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
           for e in device[:TOP // 2]]
    spans = [(e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in annotations]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / calls
    # the host time in the ranks' exchanges (their staging, gloo and the
    # wait for the other ranks), by the port's ranges, and their count
    ranges = {e.key: (e.cpu_time_total / 1e3 / calls, e.count / calls) for e in events
              if e.key in RANGES and e.device_type == torch.autograd.DeviceType.CPU}
    return wall, device_ms, launches, top, spans, ranges


def _union(spans) -> list:
    """The sorted, disjoint union of (start, end) spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_ns(spans) -> int:
    return sum(b - a for a, b in _union(spans))


def _profile_ranks(pool, fn, args, root, label: str, calls: int = LARGE_FRAMES) -> None:
    """Untimed then timed calls of a pool's rank body, then every rank
    traced over the same calls (``_rank_profile``). The card's busy time is
    the union of every rank's device activity (the kineto timestamps of
    processes on one host share a clock), over the span from the first
    activity to the last."""
    walls = []
    for _ in range(calls + 1):
        t = time.perf_counter()
        pool.run(fn, *args, root=root)
        walls.append((time.perf_counter() - t) * 1e3)
    print(f"{label}: untraced wall per call over {calls} calls after one: "
          f"{[round(w, 3) for w in walls[1:]]} ms, p50 {statistics.median(walls[1:]):.3f}",
          flush=True)
    reports = pool.run(_rank_profile, fn, calls, args, root=root)
    spans = [s for r in reports for s in r[4]]
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e6 / calls
    busy_ms = _union_ns(spans) / 1e6 / calls
    print(f"{label}: {len(reports)} ranks, traced wall per call (rank 0) {reports[0][0]:.3f} ms; "
          f"first to last device activity {span_ms:.3f} ms a call; the card busy (the union "
          f"of the ranks' device activity) {busy_ms:.3f} ms a call; idle share "
          f"{1 - busy_ms / reports[0][0]:.3f}", flush=True)
    for r, (w, dev, launches, top, _, ranges) in enumerate(reports):
        shares = ", ".join(f"{k} {ms:.3f} ms ({n:.1f}x)" for k, (ms, n) in sorted(ranges.items()))
        print(f"{label}: rank {r}: wall {w:.3f} ms, device {dev:.3f} ms (its kernels' "
              f"durations, the other ranks' turns inside them included), {launches:.1f} "
              f"cudaLaunchKernel a call; host time in exchanges a call: {shares or 'none'}; "
              f"by device time:", flush=True)
        for name, ms, count in top:
            print(f"    {ms:10.3f} ms {count:8.1f}x  {name[:90]}", flush=True)


def _serving_paths(torch, Model, make_frame, paths) -> None:
    """dp-serve and sp-1m (``_profile_ranks``)."""
    from recognizer3d_tpu_torch.ops import knn as port_knn
    from recognizer3d_tpu_torch.parallel import serving

    model = Model.load(ARCHIVE, device="cuda")
    if "dp-serve" in paths:
        clouds = np.stack([make_frame(np.random.RandomState(700 + i), 0.3 * i,
                                      FRAME_POINTS)[0] for i in range(8)])
        with serving.DPServing(model, DP_DEVICES) as server:
            np.random.seed(0)
            buf, indices, permutation, _ = model._prepare_host(clouds)
            root = (buf, indices, permutation, port_knn.session_guard_state())
            _profile_ranks(server.pool, serving._dp_predict, (server._key, 0.5), root,
                           "dp-serve")
    if "sp-1m" in paths:
        from recognizer3d_tpu_torch.benchmarks import bench_large

        cloud = bench_large.inputs(LARGE_POINTS)[1]["approximate"][0][0]
        perm = np.random.RandomState(0).permutation(LARGE_POINTS)
        x = torch.from_numpy(np.ascontiguousarray(cloud[perm][None]))
        with serving.SPServing(model, SP_DEVICES) as server:
            _profile_ranks(server.pool, serving._sp_confidences, (server._key,), x, "sp-1m")


def _dp_train_step(key, root=None):
    """One data-parallel step on every rank (a rank body for ``_profile_ranks``)."""
    from recognizer3d_tpu_torch.training import data_parallel

    data_parallel.time_steps(key, 1)


def _sp_train_step(key, x, y, keep, root=None):
    """One point-sharded train step on every rank (a rank body)."""
    from recognizer3d_tpu_torch.training import data_parallel

    data_parallel.step(key, x, y, None, keep, axis=1)


def _training_paths(torch, make_frame, paths) -> None:
    """dp-train and sp-train (``_profile_ranks``): ``chip_smoke.py``'s 7e step
    (2 ranks on the card, the app config, batches from the replicated device
    tables; each call one step) and its 7f step (4 ranks, one
    65,536-point cloud at settings64a's widths with ``knn="naive"``)."""
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged
    from recognizer3d_tpu_torch.parallel import mesh
    from recognizer3d_tpu_torch.train import app_augmentation, app_model_config
    from recognizer3d_tpu_torch.training import data_parallel

    if "dp-train" in paths:
        _write_train_dataset(make_frame)
        train, _ = DatasetMerged([Dataset(TRAIN_DIR, broaden_annotations=True)]).split()
        model = Model(app_model_config(), device="cuda")
        spec = data_parallel.payload(
            model, "dice", seed=0, batch_size=4,
            cache_spec=([train[i] for i in range(len(train))], 2500, app_augmentation()))
        with mesh.RankPool(DP_TRAIN_DEVICES) as pool:
            pool.run(data_parallel.adopt, "dp-train", spec)
            _profile_ranks(pool, _dp_train_step, ("dp-train",), None, "dp-train", FRAMES)
    if "sp-train" in paths:
        model = Model.load(ARCHIVE, device="cuda", n_points=SP_TRAIN_POINTS, knn="naive")
        cloud, labels = make_frame(np.random.RandomState(910), 0.3, SP_TRAIN_POINTS)
        rng = np.random.RandomState(911)
        perm = rng.permutation(SP_TRAIN_POINTS)
        keep = torch.from_numpy(rng.rand(1, SP_TRAIN_POINTS, 32) < 0.5)[:, perm]
        x = torch.from_numpy(np.ascontiguousarray(cloud[perm][None], np.float32))
        y = torch.from_numpy(labels[perm][None].astype(np.int64))
        with mesh.RankPool(SP_TRAIN_DEVICES) as pool:
            pool.run(data_parallel.adopt, "sp-train", data_parallel.payload(model, "dice"))
            _profile_ranks(pool, _sp_train_step, ("sp-train", x, y, keep), None, "sp-train")


def _train_data(torch, make_frame):
    _write_train_dataset(make_frame)
    return _train_batches(torch, FRAMES)


def _train_step_fn(torch, compute_dtype="float32"):
    """One app-config train step in ``compute_dtype`` on a fresh seed-0
    model, ending in a read of its loss (as a frame ends in its mask)."""
    from recognizer3d_tpu_torch import Model
    from recognizer3d_tpu_torch.train import app_model_config
    from recognizer3d_tpu_torch.training import losses
    from recognizer3d_tpu_torch.training.trainer import make_optimizer, train_step

    module = Model(app_model_config(compute_dtype)).module
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

    from recognizer3d_tpu_torch.ops import knn as port_knn

    parser = argparse.ArgumentParser()
    parser.add_argument("paths", nargs="*", default=["app", "approx64k", "live", "train"])
    parser.add_argument("--expect-window", type=int, default=None,
                        help="fail unless every approximate path settles on this window")
    args = parser.parse_args()
    paths = args.paths
    print(f"gpu: {_gpu_line()}", flush=True)
    make_frame = _make_frame()
    runs = []
    for path in paths:
        if path in ("dp-serve", "sp-1m", "dp-train", "sp-train"):
            continue
        if path in ("train", "train-bf16"):
            dtype = "bfloat16" if path == "train-bf16" else "float32"
            runs.append((_train_step_fn(torch, dtype), _train_data(torch, make_frame), path))
            continue
        if path in ("large-exact", "large-approx"):
            from recognizer3d_tpu_torch.benchmarks import bench_large

            knn = "naive" if path == "large-exact" else "approximate"
            model = Model.load(ARCHIVE, device="cuda", n_points=LARGE_POINTS, knn=knn)
            cloud = bench_large.inputs(LARGE_POINTS)[1]["approximate"][0]
            runs.append((lambda c, m=model: m.predict(c, prepostprocess=False),
                         [cloud] * LARGE_FRAMES, path))
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
    windows = {}
    for predict, frames, path in runs:
        if path.startswith("approx64k") or path == "large-approx":
            port_knn.reset_window_guard()
            predict(frames[0])  # the guard probes the first (seeded) frame
            windows[path] = port_knn.session_window_points()
            print(f"{path}: session window {windows[path]}, exact fallback "
                  f"{port_knn.session_exact_fallback()} after the first frame", flush=True)
            if args.expect_window is not None and windows[path] != args.expect_window:
                raise SystemExit(f"profile_port: {path} settled on window {windows[path]}, "
                                 f"expected {args.expect_window}")
        _time(torch, predict, frames, path)
    for predict, frames, path in runs:
        if path in windows and port_knn.session_window_points() != windows[path]:
            raise SystemExit(f"profile_port: {path} settled on window {windows[path]} but would "
                             f"be profiled at {port_knn.session_window_points()}")
        _profile(torch, predict, frames, path)
    if {"dp-serve", "sp-1m"} & set(paths):
        _serving_paths(torch, Model, make_frame, paths)
    if {"dp-train", "sp-train"} & set(paths):
        _training_paths(torch, make_frame, paths)
    subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                    "--format=csv"], check=False, timeout=60)


if __name__ == "__main__":
    main()
