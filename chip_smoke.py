#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``recognizer3d_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. require CUDA and print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``recognizer3d_tpu_torch/csrc`` into
   ``build/torch_kernels/`` and print the build seconds and the compiler's
   registers, shared memory and spills for the culled exact KNN kernel
   (B1), the window kernel (B6), the 1-NN kernel and its ordering kernel
   (B4), the tiled round-1 kernel (B2), the tiled pool-2 kernel (B3, B5)
   and the bitonic stage kernel (B7);
3. the app path: ``Predictor(pretrained/mock_fingertip)`` answers mock
   frames of 60,000 points with every launch count set to 0 just before
   each frame; each kernel must have been launched its expected number of
   times per frame. One frame's confidences on the card are held against
   the same ``Model.predict`` on the CPU;
4. the reference-default ``knn="approximate"`` path at 65,536 points
   (``bench.py``'s ``settings64a``): the bundled weights are loaded with
   those settings and saved under ``build/``, and ``Predictor`` of that
   archive answers mock frames of 150,000 points, launch counts checked per
   frame as in 3. It prints the recall guard's result, the window's sampled
   recall on the first frame, the frame p50, the card against the CPU on one
   frame, and the sampled recall of the default window on the gaussian
   probe ``0.2·randn(65536, 3)`` (seed 0) that ``bench.py`` reports;
5. the live depth path: ``LivePredictor(Model.load(pretrained/mock_fingertip))``
   at the L515's 1024×768 intrinsics and 16,384 display points answers
   z16 depth frames made from 60,000-point mock frames, launch counts
   checked per frame as in 3, frame p50 printed. On one frame the card is
   held against the CPU port given the same uniform draw and permutation:
   selected indices equal, the float32 cloud within one ulp, packed xyz
   within one float16 ulp, masks equal away from the threshold;
6. B7's entry point: the table of
   ``recognizer3d_tpu_torch.benchmarks.bench_roll_stages`` at
   (512, 128, 1024), with the launch counts set to 0 before it;
7. a reference-layout torch archive of the bundled weights, written under
   ``build/``, loaded on the card: the same state and the same predictions
   as the msgpack archive;
8. run one frame of each path while recording the inputs it hands to each
   kernel wrapper, then hold every kernel against its plain PyTorch version
   on those inputs (B5, which no path runs, on the inputs of B3's
   level-0 call; B7 bit-exact at (512, 128, 1024) for S in 1, 5, 15, 45,
   the kernels line reporting S = 45)
   and time the kernel, the plain version and (where one exists) a PyTorch
   library call computing the same function (device time from
   torch.profiler). B1 must equal its plain version with the indices in
   order, as the window kernel must, and B4 the first entry of the stable
   sort (``knn_topk_plain(support, query, 1)``), ties included; their
   bounds count the distances their culled walks evaluate at those inputs
   (the CPU models in ``benchmarks/knn_cull.py`` and
   ``benchmarks/argmin_cull.py``), not every pair. Time the live path's subsample
   selection (a stable sort) against ``torch.topk``, and the exact k = 32
   self-KNN of the approx64k frame's Morton-sorted 65,536-point level 0
   (the recall guard's exact fallback) on B1 and on the brute-force
   streaming kernel that B1 replaced, both held against the plain version;
9. print the ``{"kernels": [...]}`` line, then the result line.

It imports nothing of JAX or of the JAX package.
"""

import importlib.machinery
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCHIVE = ROOT / "pretrained" / "mock_fingertip"
FRAME_POINTS = 60_000
N_FRAMES = 5
# launches of each kernel per live frame at the app config: the four
# encoder self-KNNs, the fused LFA at encoder levels 0 and 1, and the final
# 2,500 -> full-cloud 1-NN upsample
PER_FRAME = {"knn_topk": 4, "lfa_round1": 2, "lfa_pool2_res": 2, "argmin_1nn": 1}

# the approximate path: bench.py's settings64a on the bundled weights, frames
# of the size of a depth-camera capture (bucket 163,840)
APPROX_SETTINGS = dict(knn="approximate", n_points=65_536)
APPROX_ARCHIVE = ROOT / "build" / "approx64k" / "mock_fingertip_approx64k"
APPROX_FRAME_POINTS = 150_000
# launches per frame: the Morton-window self-KNNs of levels 0 and 1 and the
# window 1-NN of the final 65,536 -> 163,840 upsample; the exact self-KNNs
# of levels 2 and 3; the fused LFA at levels 0 and 1; the 1-NN kernel for
# the decoder's 4,096 -> 16,384 and 16,384 -> 65,536 upsamples, the latter
# after the launch that orders its 16,384-point support into global memory
PER_FRAME_64K = {
    "knn_window_topk": 3, "knn_topk": 2, "lfa_round1": 2, "lfa_pool2_res": 2,
    "argmin_1nn": 2, "argmin_1nn_order": 1,
}

# the live depth path: the app archive at the L515's default intrinsics, 16,384
# display points (main.py's LivePredictor), depth frames made from mock frames
# of 60,000 points; per frame the four encoder self-KNNs, the fused LFA at
# levels 0 and 1, and the 2,500 -> 16,384 1-NN upsample
LIVE_DISPLAY = 16_384
PER_FRAME_LIVE = {"knn_topk": 4, "lfa_round1": 2, "lfa_pool2_res": 2, "argmin_1nn": 1}

# B7 at the TPU benchmark's shape, and its entry point's launches: five runs
# (the 1-stage base and S = 1, 5, 15, 45), each an untimed and a timed chain
# of 5 calls
ROLL_SHAPE = (512, 128, 1024)
ROLL_STAGES = (1, 5, 15, 45)
ROLL_TABLE_LAUNCHES = 5 * 2 * 5

TORCH_ARCHIVE = ROOT / "build" / "torch_archive" / "mock_fingertip_reference"

# kernels whose registers, shared memory and spills the build report prints
PTXAS_KERNELS = ("knn_cull_kernel", "knn_window_kernel", "argmin_cull_kernel",
                 "argmin_order_kernel", "lfa_round1_tile_kernel", "lfa_pool2_tile_kernel",
                 "roll_stages_kernel")

# kernel -> (source, the TPU kernel it replaces), in the order of the line
KERNELS = {
    "knn_topk": ("recognizer3d_tpu_torch/csrc/knn.cu",
                 "recognizer3d_tpu/ops/knn_pallas.py:109"),
    "argmin_1nn": ("recognizer3d_tpu_torch/csrc/knn.cu",
                   "recognizer3d_tpu/ops/knn_pallas.py:402"),
    "lfa_round1": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                   "recognizer3d_tpu/ops/lfa_pallas.py:138"),
    "lfa_pool2_res": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                      "recognizer3d_tpu/ops/lfa_pallas.py:221"),
    "lfa_pool2": ("recognizer3d_tpu_torch/csrc/lfa.cu",
                  "recognizer3d_tpu/ops/lfa_pallas.py:192"),
    "knn_window_topk": ("recognizer3d_tpu_torch/csrc/knn.cu",
                        "recognizer3d_tpu/ops/knn.py:348"),
    "roll_stages": ("recognizer3d_tpu_torch/csrc/bitonic.cu",
                    "benchmarks/bench_roll_stages.py:56"),
}

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32
# operations/s outside the tensor cores (the kernels run no tensor-core op)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 lane instructions/s: the 67 TFLOP/s count an FMA as two
# operations; a compare or a select is one instruction, executed at the
# FMA's instruction rate, so work made of them is bounded at half the flop
# rate
PEAK_F32_INSTR_PER_S = PEAK_F32_OPS_PER_S / 2


def _make_frame():
    loader = importlib.machinery.SourceFileLoader(
        "make_mock_data", str(ROOT / "bin" / "make_mock_data")
    )
    spec = importlib.util.spec_from_loader("make_mock_data", loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module.make_frame


def _gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _device_ms(torch, fn, reps: int, kernel: str = "") -> float:
    """Device time per call of ``fn``: torch.profiler's CUDA activity over
    ``reps`` back-to-back calls after one warm-up call. With ``kernel``,
    only the kernels whose name contains it count (a wrapper's own small
    PyTorch operators and the host's launch gaps stay out); without, every
    kernel and copy the calls ran. The card's profiler now and then drops a
    session's device activity: a session with fewer device events than
    calls is taken again, up to three sessions. If none records them, the
    run fails: the recorded kernel is the only proof on the device's side
    that the named kernel ran while it was timed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0 and sum(e.count for e in events) >= reps:
            return device_us / 1e3 / reps
        time.sleep(1.0)
    raise RuntimeError(f"the profiler recorded no device time for {kernel or fn} "
                       f"in three sessions")


def _bound(nbytes: float, nops: float, ops_per_s: float = PEAK_F32_OPS_PER_S):
    """Least time (ms) the card could take: the larger of bytes over the
    memory rate and float32 operations over ``ops_per_s`` (the flop rate,
    or the instruction rate for work that is no FMA)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --- work counts (each input read once, each output written once) ----------


def _knn_work(m: int, n: int, k: int):
    # 3 subtractions, 3 multiplications, 2 additions and a compare per
    # (query, support) pair, no FMA (the kernels forbid contraction): lane
    # instructions, bounded at PEAK_F32_INSTR_PER_S
    return 4 * 3 * (m + n) + 8 * m * k, 9 * m * n


def _cull_work(support, query, k: int):
    # B1 reads each input once and writes (idx, d2) once, and spends 9 lane
    # instructions (as in _knn_work) on each distance the culled selection
    # evaluates, counted by its CPU model (benchmarks/knn_cull.py) at these
    # inputs with one query a warp, the launcher's choice for a launch of
    # one wave, as every call of the served paths is
    from recognizer3d_tpu_torch.benchmarks import knn_cull

    b, m, n = query.shape[0], query.shape[1], support.shape[1]
    distances = sum(
        int(knn_cull.select(s, q, k, 1)[2]["distances"].sum())
        for s, q in zip(support.cpu().numpy(), query.cpu().numpy())
    )
    return b * (4 * 3 * (m + n) + 8 * m * k), 9 * distances


def _argmin_work(support, query):
    # B4 reads each input once and writes (idx, d2) once, and spends 9 lane
    # instructions (as in _knn_work) on each distance its walk evaluates,
    # counted by its CPU model (benchmarks/argmin_cull.py) at these inputs
    from recognizer3d_tpu_torch.benchmarks import argmin_cull

    b, m, n = query.shape[0], query.shape[1], support.shape[1]
    distances = sum(
        int(argmin_cull.select(s, q)[2]["distances"].sum())
        for s, q in zip(support.cpu().numpy(), query.cpu().numpy())
    )
    return b * (4 * 3 * (m + n) + 8 * m), 9 * distances


def _window_work(m: int, n: int, w: int, k: int):
    # the window search evaluates w distances per query, 9 lane
    # instructions each as in _knn_work
    return 4 * 3 * (m + n) + 4 * m * 2 * k, 9 * m * w


def _round1_work(rows: int, k: int, h: int):
    c2 = 2 * h
    nbytes = 4 * rows * (k * c2 + k + h + h + k * h) + 4 * (5 * h + 7 * h * h)
    per_row = (
        k                      # sqrt of the distances
        + 5 * k * h            # RPE sum, w9 term, BN affine, relu
        + 2 * k * c2 * c2      # scores
        + 5 * k * c2           # softmax over K
        + 2 * k * c2           # weighted sum
        + 2 * c2 * h + 2 * h   # pool MLP, offset, relu
        + 2 * k * h * h + 2 * k * h  # mlp_rpe2, offset, relu
    )
    return nbytes, rows * per_row


def _pool2_work(rows: int, k: int, h: int, f: int, residual: bool = True):
    c2, c4 = 2 * h, 4 * h
    if not residual:
        nbytes = 4 * rows * (2 * k * h + c2) + 4 * (2 * c2 * c2 + c2)
        per_row = 2 * k * c2 * c2 + 5 * k * c2 + 2 * k * c2 + 2 * c2 * c2 + 2 * c2
        return nbytes, rows * per_row
    nbytes = 4 * rows * (2 * k * h + f + c4) + 4 * (
        2 * c2 * c2 + c2 + c2 * c4 + f * c4 + c4
    )
    per_row = (
        2 * k * c2 * c2 + 5 * k * c2 + 2 * k * c2   # scores, softmax, sum
        + 2 * c2 * c2 + 2 * c2                     # pool MLP, offset, relu
        + 2 * c2 * c4 + 2 * f * c4 + 3 * c4        # mlp2, shortcut, lrelu
    )
    return nbytes, rows * per_row


def _roll_work(n_elem: int, stages: int):
    # each element read and written once; per stage a compare and two
    # selects (value and payload: which side keeps the minimum is a function
    # of the position, not of the data), then the epilogue's conversion,
    # multiply and add: lane instructions, bounded at PEAK_F32_INSTR_PER_S
    return 8 * n_elem, n_elem * (3 * stages + 3)


class _Recorder:
    """Swap the kernel wrappers the model calls for recording ones, so one
    frame yields the exact inputs the main path hands each kernel."""

    def __init__(self, targets):
        self.targets = targets  # (module, attribute name, kernel name)
        self.calls = {name: [] for _, _, name in targets}
        self._saved = []

    def __enter__(self):
        for module, attr, name in self.targets:
            original = getattr(module, attr)
            self._saved.append((module, attr, original))

            def record(*args, _fn=original, _name=name, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _fn(*args, **kwargs)

            setattr(module, attr, record)
        return self

    def __exit__(self, *exc):
        for module, attr, original in self._saved:
            setattr(module, attr, original)


def _drive(torch, build, predictor, frames, per_frame, label):
    """Answer ``frames`` with every launch count set to 0 before each frame;
    each frame must launch exactly ``per_frame``. Returns the latencies (ms),
    the masks and the launches summed over the frames."""
    n_points = frames[0].shape[0]
    latencies, masks, totals = [], [], {}
    for frame in frames:
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        masks.append(predictor.predict(frame))
        latencies.append((time.perf_counter() - t) * 1e3)
        launches = dict(build.LAUNCHES)
        if launches != per_frame:
            raise RuntimeError(f"{label}: launches {launches} in a frame, expected {per_frame}")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
    for mask in masks:
        if mask.shape != (n_points,) or mask.dtype != np.bool_:
            raise RuntimeError(f"{label}: mask of shape {mask.shape} and dtype {mask.dtype}")
        if not 0 < mask.sum() < n_points:
            raise RuntimeError(f"{label}: degenerate mask: {int(mask.sum())} positives")
    print(f"{label}: {len(frames)} frames of {n_points} points, launches {totals}",
          flush=True)
    print(f"{label}: per-frame latency ms: {[round(x, 3) for x in latencies]}; "
          f"p50 {statistics.median(latencies):.3f} ms; positives "
          f"{[int(m.sum()) for m in masks]}", flush=True)
    return latencies, masks, totals


def _card_vs_cpu(Model, archive, frame, label):
    """One frame's confidences on the card against the same Model.predict
    on the CPU; returns the card's model."""
    model = Model.load(archive, device="cuda", transfer_dtype="float32")
    cpu_model = Model.load(archive, device="cpu", transfer_dtype="float32")
    np.random.seed(7)
    conf_gpu = model.predict(frame)
    np.random.seed(7)
    conf_cpu = cpu_model.predict(frame)
    if conf_gpu.shape != (2, frame.shape[0]) or not np.isfinite(conf_gpu).all():
        raise RuntimeError(f"{label}: confidences of shape {conf_gpu.shape}, or not finite")
    conf_err = float(np.abs(conf_gpu - conf_cpu).max())
    near = np.abs(conf_cpu[1] - 0.5) <= 1e-4
    mask_diff = int(((conf_gpu[1] > 0.5) != (conf_cpu[1] > 0.5))[~near].sum())
    if conf_err > 1e-4 or mask_diff:
        raise RuntimeError(
            f"{label}: card vs CPU: max abs conf err {conf_err}, {mask_diff} mask points differ"
        )
    print(f"{label}: card vs CPU confidences: max abs err {conf_err:.3g}, masks equal "
          f"({int(near.sum())} points within 1e-4 of the threshold)", flush=True)
    return model


def _record_frame(run_frame, targets, per_frame, label):
    """One frame (``run_frame()``) with the wrappers recording their inputs."""
    import torch

    np.random.seed(0)
    with _Recorder(targets) as rec, torch.inference_mode():
        run_frame()
    torch.cuda.synchronize()
    for name, recorded in rec.calls.items():
        if len(recorded) != per_frame.get(name, 0):
            raise RuntimeError(f"{label}: {name} recorded {len(recorded)} calls, expected "
                               f"{per_frame.get(name, 0)}")
    return rec.calls


class _Results:
    """Per-kernel sums over the recorded calls: max error, device ms of the
    kernel, its plain version and the library call, and the bound."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, bound, library_ms):
        r = self.rows.setdefault(
            name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       t_bytes=0.0, t_ops=0.0, library_ms=None),
        )
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["bound_ms"] += bound[0]
        r["t_" + ("bytes" if bound[1] == "bytes" else "ops")] += bound[0]
        if library_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + library_ms


def _check_kernels(torch, calls, results, label, plain_reps):
    """Hold each recorded call's kernel against its plain version and time
    both (and the library call where there is one)."""
    from recognizer3d_tpu_torch.ops import knn_kernels, lfa_kernels

    # B1: exact self-KNN
    for (support, query, k), _ in calls.get("knn_topk", []):
        m, n = query.shape[1], support.shape[1]
        idx, d2 = knn_kernels.knn_topk(support, query, k)
        ref_i, ref_d = knn_kernels.knn_topk_plain(support, query, k)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} knn_topk N={n}: indices equal {torch.equal(idx, ref_i)}, "
                f"d2 equal {torch.equal(d2, ref_d)}"
            )
        ms = _device_ms(torch, lambda: knn_kernels.knn_topk(support, query, k), 50,
                        "knn_cull_kernel")
        plain = _device_ms(torch, lambda: knn_kernels.knn_topk_plain(support, query, k),
                           plain_reps)
        lib = _device_ms(
            torch, lambda: torch.cdist(query, support).topk(k, -1, largest=False), plain_reps
        )
        bound = _bound(*_cull_work(support, query, k), PEAK_F32_INSTR_PER_S)
        results.add("knn_topk", 0.0, ms, plain, bound, lib)
        print(f"{label} knn_topk M={m} N={n} k={k}: indices (in order) and d2 equal; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+topk {lib:.4f} ms, "
              f"bound {bound[0]:.5f} ms ({bound[1]})", flush=True)

    # B4: exact 1-NN upsample, held to the first entry of the stable sort,
    # ties included; timed with its ordering launch where it has one
    for (support, query), _ in calls.get("argmin_1nn", []):
        m, n = query.shape[1], support.shape[1]
        idx, d2 = knn_kernels.argmin_1nn(support, query)
        ref_i, ref_d = knn_kernels.knn_topk_plain(support, query, 1)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} argmin_1nn M={m} N={n}: {int((idx != ref_i).sum())} indices and "
                f"{int((d2 != ref_d).sum())} distances differ from the stable sort's first"
            )
        ties = int((knn_kernels.knn_topk_plain(support, query, 2)[1].diff(dim=-1) == 0).sum())
        ms = _device_ms(torch, lambda: knn_kernels.argmin_1nn(support, query), 50, "argmin_")
        plain = _device_ms(torch, lambda: knn_kernels.argmin_1nn_plain(support, query),
                           max(1, plain_reps // 2))
        lib = _device_ms(torch, lambda: torch.cdist(query, support).argmin(-1),
                         max(1, plain_reps // 2))
        bound = _bound(*_argmin_work(support, query), PEAK_F32_INSTR_PER_S)
        brute = _knn_work(m, n, 1)[1] / PEAK_F32_INSTR_PER_S * 1e3
        results.add("argmin_1nn", 0.0, ms, plain, bound, lib)
        print(f"{label} argmin_1nn M={m} N={n}: indices and d2 equal ({ties} queries with a "
              f"tied second); kernel {ms:.4f} ms, plain {plain:.4f} ms, cdist+argmin "
              f"{lib:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, not a bound: "
              f"9*M*N brute-force lane instructions take {brute:.5f} ms", flush=True)

    # B6: the Morton-window search (k = 32 self-KNN, k = 1 upsample)
    for (support, query, k, starts, w, qb), _ in calls.get("knn_window_topk", []):
        m, n = query.shape[1], support.shape[1]
        idx, d2 = knn_kernels.knn_window_topk(support, query, k, starts, w, qb)
        ref_i, ref_d = knn_kernels.knn_window_topk_plain(support, query, k, starts, w, qb)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(
                f"{label} knn_window_topk M={m} N={n} k={k}: indices equal "
                f"{torch.equal(idx, ref_i)}, d2 equal {torch.equal(d2, ref_d)}"
            )
        n_blocks = starts.shape[0]
        offsets = torch.arange(w, device=support.device)

        def library():
            win = support[0, starts.long()[:, None] + offsets]  # (blocks, w, 3)
            q = query[0]
            pad = n_blocks * qb - m
            if pad:
                q = torch.cat([q, q[-1:].expand(pad, 3)])
            d = torch.cdist(q.reshape(n_blocks, qb, 3), win)
            return d.argmin(-1) if k == 1 else d.topk(k, -1, largest=False)

        ms = _device_ms(
            torch, lambda: knn_kernels.knn_window_topk(support, query, k, starts, w, qb),
            20, "argmin_kernel" if k == 1 else "knn_window_kernel",
        )
        plain = _device_ms(
            torch, lambda: knn_kernels.knn_window_topk_plain(support, query, k, starts, w, qb),
            plain_reps,
        )
        lib = _device_ms(torch, library, plain_reps)
        bound = _bound(*_window_work(m, n, w, k), PEAK_F32_INSTR_PER_S)
        results.add("knn_window_topk", 0.0, ms, plain, bound, lib)
        print(f"{label} knn_window_topk M={m} N={n} w={w} qb={qb} k={k}: indices and "
              f"d2 equal; kernel {ms:.4f} ms, plain {plain:.4f} ms, window cdist+"
              f"{'argmin' if k == 1 else 'topk'} {lib:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]})", flush=True)

    # B2: fused LFA round 1 at encoder levels 0 and 1
    for args, _ in calls.get("lfa_round1", []):
        gathered, d2, center = args[:3]
        _, rows, k, c2 = gathered.shape
        h = c2 // 2
        pooled, rpe2 = lfa_kernels.lfa_round1(*args)
        consts = lfa_kernels.round1_constants(*args[3:])
        ref_p, ref_r = lfa_kernels.lfa_round1_plain(gathered, d2, center, consts)
        torch.cuda.synchronize()
        err = max((pooled - ref_p).abs().max().item(), (rpe2 - ref_r).abs().max().item())
        if err > 1e-5:
            raise RuntimeError(f"{label} lfa_round1 h={h}: max abs err {err}")
        ms = _device_ms(torch, lambda: lfa_kernels.lfa_round1(*args), 50,
                        "lfa_round1_tile_kernel")
        plain = _device_ms(
            torch,
            lambda: lfa_kernels.lfa_round1_plain(
                gathered, d2, center, lfa_kernels.round1_constants(*args[3:])
            ),
            2 * plain_reps,
        )
        bound = _bound(*_round1_work(rows, k, h))
        results.add("lfa_round1", err, ms, plain, bound, None)
        print(f"{label} lfa_round1 N={rows} K={k} h={h}: max abs err {err:.3g}; kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]})", flush=True)

    # B3: fused attentive pool 2 + residual at encoder levels 0 and 1, and
    # B5 (pool 2 alone, which no path runs) on the level-0 inputs
    for args, kwargs in calls.get("lfa_pool2_res", []):
        rpe2, g2 = args[:2]
        f_in = args[7]
        _, rows, k, h = g2.shape
        f = f_in.shape[-1]
        out = lfa_kernels.attentive_pool2_residual(*args, **kwargs)
        consts = lfa_kernels.pool2_constants(*args[2:7], *args[8:])
        ref = lfa_kernels.attentive_pool2_residual_plain(rpe2, g2, f_in, consts, k)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if err > 1e-5:
            raise RuntimeError(f"{label} lfa_pool2_res h={h}: max abs err {err}")
        ms = _device_ms(
            torch, lambda: lfa_kernels.attentive_pool2_residual(*args, **kwargs), 50,
            "lfa_pool2_tile_kernel",
        )
        plain = _device_ms(
            torch,
            lambda: lfa_kernels.attentive_pool2_residual_plain(
                rpe2, g2, f_in,
                lfa_kernels.pool2_constants(*args[2:7], *args[8:]), k,
            ),
            2 * plain_reps,
        )
        bound = _bound(*_pool2_work(rows, k, h, f))
        results.add("lfa_pool2_res", err, ms, plain, bound, None)
        print(f"{label} lfa_pool2_res N={rows} K={k} h={h} F={f}: max abs err {err:.3g}; "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.5f} ms "
              f"({bound[1]})", flush=True)
        if h != 8:
            continue
        head = args[2:7]
        out = lfa_kernels.attentive_pool2(rpe2, g2, *head, k=k)
        ref = lfa_kernels.attentive_pool2_plain(
            rpe2, g2, lfa_kernels.pool2_constants(*head), k
        )
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if err > 1e-5:
            raise RuntimeError(f"{label} lfa_pool2 h={h}: max abs err {err}")
        ms = _device_ms(torch, lambda: lfa_kernels.attentive_pool2(rpe2, g2, *head, k=k),
                        50, "lfa_pool2_tile_kernel")
        plain = _device_ms(
            torch,
            lambda: lfa_kernels.attentive_pool2_plain(
                rpe2, g2, lfa_kernels.pool2_constants(*head), k
            ),
            2 * plain_reps,
        )
        bound = _bound(*_pool2_work(rows, k, h, 0, residual=False))
        results.add("lfa_pool2", err, ms, plain, bound, None)
        print(f"{label} lfa_pool2 (B5, on B3's level-0 inputs) N={rows} K={k} h={h}: "
              f"max abs err {err:.3g}; kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
              f"{bound[0]:.5f} ms ({bound[1]})", flush=True)


def _exact_64k(torch, morton, knn_kernels, cloud):
    """The exact k = 32 self-KNN of a Morton-sorted 65,536-point level (the
    recall guard's exact fallback at approx64k) on B1 and on the brute-force
    streaming kernel it replaced (reached through the window route with the whole
    support as one window, which takes that kernel above 19,370 points),
    both bit-identical to the plain version, timed in the same process."""
    k = 32
    x = torch.tensor(cloud[None], device="cuda")
    x = morton.sort_rows(x, morton.morton_order(x)).contiguous()
    n = x.shape[1]
    starts = torch.zeros(1, dtype=torch.int32, device="cuda")
    ref_i, ref_d = knn_kernels.knn_topk_plain(x, x, k)
    for name, fn in (("B1", lambda: knn_kernels.knn_topk(x, x, k)),
                     ("streaming", lambda: knn_kernels.knn_window_topk(x, x, k, starts, n, n))):
        idx, d2 = fn()
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
            raise RuntimeError(f"exact 64k self-KNN on the {name} kernel: indices equal "
                               f"{torch.equal(idx, ref_i)}, d2 equal {torch.equal(d2, ref_d)}")
    del ref_i, ref_d
    new_ms = _device_ms(torch, lambda: knn_kernels.knn_topk(x, x, k), 10, "knn_cull_kernel")
    old_ms = _device_ms(torch, lambda: knn_kernels.knn_window_topk(x, x, k, starts, n, n), 3,
                        "knn_topk_kernel")
    # the bound is the bytes (the culled selection's distance count is out
    # of the CPU model's reach at this size); the brute-force instruction
    # count, the streaming kernel's work, is printed beside it as a reference
    nbytes, brute = _knn_work(n, n, k)
    bound = _bound(nbytes, 0)
    print(f"exact self-KNN M=N={n} k={k} (Morton-sorted approx64k level 0): B1 and the streaming "
          f"kernel equal the plain version (indices in order, d2); B1 {new_ms:.4f} ms, "
          f"streaming kernel {old_ms:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, "
          f"not a bound: 9*M*N brute-force lane instructions take "
          f"{brute / PEAK_F32_INSTR_PER_S * 1e3:.5f} ms", flush=True)


def _check_roll_stages(torch, results):
    """B7 against its plain version, bit-exact, at the TPU benchmark's
    shape for each stage count, with both timed. The kernels line takes
    the largest stage count, the TPU benchmark's S = 45."""
    from recognizer3d_tpu_torch.ops import bitonic_kernels

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x = torch.rand(ROLL_SHAPE, generator=gen, device="cuda")
    for stages in ROLL_STAGES:
        out = bitonic_kernels.roll_stages(x, stages)
        ref = bitonic_kernels.roll_stages_plain(x, stages)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            n_diff = int((out != ref).sum())
            raise RuntimeError(f"roll_stages S={stages}: {n_diff} elements differ")
        del out, ref
        ms = _device_ms(torch, lambda: bitonic_kernels.roll_stages(x, stages), 20,
                        "roll_stages_kernel")
        plain = _device_ms(torch, lambda: bitonic_kernels.roll_stages_plain(x, stages), 3)
        bound = _bound(*_roll_work(x.numel(), stages), PEAK_F32_INSTR_PER_S)
        if stages == ROLL_STAGES[-1]:
            results.add("roll_stages", 0.0, ms, plain, bound, None)
        # the earlier count of 7 instructions a stage (the position tests
        # evaluated per element), which a kernel that resolves them at
        # compile time beats: a reference, not a bound
        seven = x.numel() * (7 * stages + 3) / PEAK_F32_INSTR_PER_S * 1e3
        print(f"roll_stages {tuple(x.shape)} S={stages}: bit-exact; kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}); reference, not a "
              f"bound: 7 instructions a stage take {seven:.5f} ms", flush=True)


def _time_selection(torch, pipeline, depth):
    """The live path's subsample selection at its shape (786,432 priorities
    -> 16,384): the port's stable sort, which reproduces the JAX package's
    off-TPU ``lax.top_k`` (where the TPU runs ``approx_min_k``), against
    ``torch.topk`` on the same priorities, and the whole ``subsample_order``
    (band test, priorities, sort); device ms from torch.profiler."""
    intr = pipeline.DepthIntrinsics()
    z = pipeline.depth_to_cloud(torch.from_numpy(depth).cuda(), intr)[None, :, 2].contiguous()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    uniform = torch.rand(z.shape, generator=gen, device="cuda")
    valid = (z > pipeline.Z_MIN) & (z < pipeline.Z_MAX)
    priority = torch.where(valid, uniform, torch.full_like(uniform, float("inf")))
    order_ms = _device_ms(
        torch, lambda: pipeline.subsample_order(uniform, z, LIVE_DISPLAY), 20
    )
    sort_ms = _device_ms(torch, lambda: torch.sort(priority, dim=-1, stable=True), 20)
    topk_ms = _device_ms(
        torch, lambda: torch.topk(priority, LIVE_DISPLAY, dim=-1, largest=False), 20
    )
    # bound: the float32 priorities read once, the int64 indices written once
    bound = _bound(4 * z.shape[1] + 8 * LIVE_DISPLAY, 0)
    print(f"live selection {z.shape[1]} -> {LIVE_DISPLAY} ({int(valid.sum())} valid): "
          f"subsample_order {order_ms:.4f} ms, of which stable sort {sort_ms:.4f} ms; "
          f"torch.topk {topk_ms:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]})", flush=True)


def _live_path(torch, build, Model, pipeline, LivePredictor, make_frame):
    """The depth-camera tick at the app config; returns the launches summed
    over its frames and a function running one recorded frame."""
    intr = pipeline.DepthIntrinsics()
    depths = [
        pipeline.cloud_to_depth(
            make_frame(np.random.RandomState(500 + i), 0.45 * i, FRAME_POINTS)[0], intr
        )
        for i in range(N_FRAMES)
    ]
    t0 = time.perf_counter()
    live = LivePredictor(Model.load(ARCHIVE, device="cuda"), n_display=LIVE_DISPLAY,
                         intrinsics=intr)
    torch.cuda.synchronize()
    print(f"live: LivePredictor at {intr.width}x{intr.height}, {LIVE_DISPLAY} display "
          f"points, ready in {time.perf_counter() - t0:.3f} s", flush=True)
    latencies, totals = [], {}
    for depth in depths:
        torch.cuda.synchronize()
        build.reset_launches()
        t = time.perf_counter()
        cloud, mask = live.predict_depth(depth)
        latencies.append((time.perf_counter() - t) * 1e3)
        launches = dict(build.LAUNCHES)
        if launches != PER_FRAME_LIVE:
            raise RuntimeError(f"live: launches {launches} in a frame, expected {PER_FRAME_LIVE}")
        for name, count in launches.items():
            totals[name] = totals.get(name, 0) + count
        valid = (cloud != 0).any(-1)
        if cloud.shape != (LIVE_DISPLAY, 3) or cloud.dtype != np.float32 or mask.dtype != np.bool_:
            raise RuntimeError(f"live: cloud {cloud.shape} {cloud.dtype}, mask {mask.dtype}")
        if not np.isfinite(cloud).all() or valid.sum() < LIVE_DISPLAY // 2:
            raise RuntimeError(f"live: {int(valid.sum())} valid display points, or not finite")
        if not 0 < mask.sum() < valid.sum() or (mask & ~valid).any():
            raise RuntimeError(f"live: degenerate mask: {int(mask.sum())} positives")
    print(f"live: {len(depths)} depth frames, launches {totals}", flush=True)
    print(f"live: per-frame latency ms: {[round(x, 3) for x in latencies]}; p50 "
          f"{statistics.median(latencies):.3f} ms", flush=True)
    _live_card_vs_cpu(torch, Model, pipeline, LivePredictor, live, intr, depths[1])
    return totals, lambda: live.predict_depth(depths[0])


def _live_card_vs_cpu(torch, Model, pipeline, LivePredictor, live, intr, depth):
    """The card's live program against the CPU port's on one frame, both
    given the same uniform draw and permutation. Tolerances: the selected
    indices equal; the float32 cloud within one ulp (the dewarp divides by
    tensors, so it should be exact); packed xyz within one float16 ulp;
    masks equal where the CPU's class-1 confidence lies more than 1e-4
    from the threshold (read off its masks at 0.5 ± 1e-4)."""
    thr = 0.5
    cpu_model = Model.load(ARCHIVE, device="cpu")
    cpu_live = LivePredictor(cpu_model, n_display=LIVE_DISPLAY, intrinsics=intr)
    gen = torch.Generator()
    gen.manual_seed(11)
    uniform = torch.rand((1, depth.size), generator=gen)
    perm = np.random.RandomState(7).permutation(cpu_model.settings.n_points)
    perm = torch.from_numpy(perm.astype(np.int32))
    depth_bits = torch.from_numpy(depth)
    with torch.inference_mode():
        cloud_cpu = pipeline.depth_to_cloud(depth_bits, intr)
        cloud_gpu = pipeline.depth_to_cloud(depth_bits.cuda(), intr)
        order_cpu, _ = pipeline.subsample_order(uniform, cloud_cpu[None, :, 2], LIVE_DISPLAY)
        order_gpu, _ = pipeline.subsample_order(
            uniform.cuda(), cloud_gpu[None, :, 2], LIVE_DISPLAY
        )
        if not torch.equal(order_gpu.cpu(), order_cpu):
            n_diff = int((order_gpu.cpu() != order_cpu).sum())
            raise RuntimeError(f"live: {n_diff} selected indices differ between card and CPU")
        cloud_gpu = cloud_gpu.cpu()
        ulp = torch.from_numpy(np.spacing(np.abs(cloud_cpu.numpy())))
        cloud_diff = int((cloud_gpu != cloud_cpu).sum())
        if bool(((cloud_gpu - cloud_cpu).abs() > ulp).any()):
            raise RuntimeError(f"live: dewarp differs by more than one ulp ({cloud_diff} coords)")
        packed_gpu = live.program_fn(
            depth_bits.cuda(), uniform.cuda(), perm.cuda(), thr
        ).cpu().numpy()
        packed_cpu = cpu_live.program_fn(depth_bits, uniform, perm, thr).numpy()
        near = (
            (cpu_live.program_fn(depth_bits, uniform, perm, thr - 1e-4).numpy()[:, 3] > 0)
            != (cpu_live.program_fn(depth_bits, uniform, perm, thr + 1e-4).numpy()[:, 3] > 0)
        )
    xyz_gpu = packed_gpu[:, :3].astype(np.float32)
    xyz_cpu = packed_cpu[:, :3].astype(np.float32)
    if (np.abs(xyz_gpu - xyz_cpu) > np.spacing(np.abs(packed_cpu[:, :3]))).any():
        raise RuntimeError("live: packed xyz differ by more than one float16 ulp")
    mask_gpu, mask_cpu = packed_gpu[:, 3] > 0, packed_cpu[:, 3] > 0
    mask_diff = int((mask_gpu != mask_cpu)[~near].sum())
    if mask_diff:
        raise RuntimeError(f"live: {mask_diff} mask points differ away from the threshold")
    print(f"live: card vs CPU on one frame: {LIVE_DISPLAY} selected indices equal, "
          f"{cloud_diff} of {cloud_cpu.numel()} dewarped coordinates differ (at most one "
          f"ulp), packed xyz {int((xyz_gpu != xyz_cpu).sum())} differ (at most one float16 "
          f"ulp), masks equal ({int(near.sum())} points within 1e-4 of the threshold; "
          f"{int(mask_cpu.sum())} positives)", flush=True)


def _torch_archive(torch, Model, model, frame):
    """The bundled weights re-saved as a reference-layout torch archive and
    loaded on the card: the same state and the same predictions."""
    from recognizer3d_tpu_torch.models import torch_compat
    from recognizer3d_tpu_torch.models.weights import to_flax_variables

    state = model.module.state_dict()
    torch_compat.save_reference_archive(
        TORCH_ARCHIVE, model.settings,
        torch_compat.variables_to_torch_state_dict(to_flax_variables(state), model.settings),
    )
    loaded = Model.load(TORCH_ARCHIVE, device="cuda", transfer_dtype="float32")
    other = loaded.module.state_dict()
    if sorted(other) != sorted(state) or not all(torch.equal(state[k], other[k]) for k in state):
        raise RuntimeError("torch archive: the loaded state differs from the msgpack archive's")
    np.random.seed(7)
    ref = model.predict(frame)
    np.random.seed(7)
    conf = loaded.predict(frame)
    if not np.array_equal(conf, ref):
        raise RuntimeError(
            f"torch archive: predictions differ by {float(np.abs(conf - ref).max())}"
        )
    print(f"torch archive: {TORCH_ARCHIVE.relative_to(ROOT)} loaded on the card; state and "
          f"predictions on a {frame.shape[0]}-point frame equal the msgpack archive's",
          flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from recognizer3d_tpu_torch import Model, Predictor
    from recognizer3d_tpu_torch.benchmarks import bench_roll_stages
    from recognizer3d_tpu_torch.data import pipeline
    from recognizer3d_tpu_torch.data.preprocessing import consistent_sample_indices
    from recognizer3d_tpu_torch.models.live import LivePredictor
    from recognizer3d_tpu_torch.ops import _build, knn as port_knn
    from recognizer3d_tpu_torch.ops import knn_kernels, lfa_kernels, morton

    gpu = _gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}",
        flush=True,
    )

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib_path}", flush=True)
    for line in _build.ptxas_report(PTXAS_KERNELS):
        print(f"ptxas: {line}", flush=True)

    make_frame = _make_frame()
    frames = [
        make_frame(np.random.RandomState(100 + i), 0.45 * i, FRAME_POINTS)[0]
        for i in range(N_FRAMES)
    ]

    # --- 3. the app path --------------------------------------------------------
    predictor = Predictor(ARCHIVE, warmup_points=FRAME_POINTS)
    _, _, launches = _drive(torch, _build, predictor, frames, PER_FRAME, "app path")
    model = _card_vs_cpu(Model, ARCHIVE, frames[1], "app path")
    del predictor

    # --- 4. the approximate path at 64k points -------------------------------
    port_knn.reset_window_guard()
    derived = Model.load(ARCHIVE, device="cuda", **APPROX_SETTINGS)
    derived.save(APPROX_ARCHIVE)
    del derived
    frames64 = [
        make_frame(np.random.RandomState(300 + i), 0.45 * i, APPROX_FRAME_POINTS)[0]
        for i in range(N_FRAMES)
    ]
    t0 = time.perf_counter()
    predictor64 = Predictor(APPROX_ARCHIVE, warmup_points=APPROX_FRAME_POINTS)
    torch.cuda.synchronize()
    settings = predictor64.model.settings
    print(f"approx64k: Predictor of {APPROX_ARCHIVE.relative_to(ROOT)} (knn={settings.knn}, "
          f"n_points={settings.n_points}, K={settings.n_neighbors}, layers "
          f"{settings.layer_sizes}) ready in {time.perf_counter() - t0:.3f} s; recall guard "
          f"on its warm-up cloud: {predictor64.model.recall_guard_result}", flush=True)
    _, _, launches64 = _drive(torch, _build, predictor64, frames64, PER_FRAME_64K,
                              "approx64k")
    for name, count in launches64.items():
        launches[name] = launches.get(name, 0) + count
    window = port_knn.session_window_points()
    with torch.inference_mode():
        sample = frames64[0][consistent_sample_indices(APPROX_FRAME_POINTS, 65_536)]
        x = torch.tensor(sample[None], device="cuda")
        recall = float(port_knn.sampled_recall(
            x, x, 32, port_knn.knn_window(x, x, 32, window_points=window)
        ))
    print(f"approx64k: session window {window}, exact fallback "
          f"{port_knn.session_exact_fallback()}; sampled recall@32 of the window "
          f"search on frame 0: {recall:.4f}", flush=True)
    del predictor64
    model64 = _card_vs_cpu(Model, APPROX_ARCHIVE, frames64[1], "approx64k")

    # --- 5. the live depth path -----------------------------------------------
    port_knn.reset_window_guard()
    launches_live, live_frame = _live_path(
        torch, _build, Model, pipeline, LivePredictor, make_frame
    )
    for name, count in launches_live.items():
        launches[name] = launches.get(name, 0) + count

    # --- 6. B7's entry point ------------------------------------------------
    _build.reset_launches()
    rows = bench_roll_stages.table()
    launches["roll_stages"] = _build.LAUNCHES["roll_stages"]
    if dict(_build.LAUNCHES) != {"roll_stages": ROLL_TABLE_LAUNCHES}:
        raise RuntimeError(f"bench_roll_stages: launches {dict(_build.LAUNCHES)}, expected "
                           f"{ROLL_TABLE_LAUNCHES} of roll_stages")
    for stages, total_ms, per_block, per_stage in rows:
        print(f"bench_roll_stages {ROLL_SHAPE}: stages={stages:3d}  total {total_ms:.4f} ms  "
              f"per-block {per_block:.4f} us  marginal/stage {per_stage:.4f} us", flush=True)

    # --- 7. a reference torch archive -----------------------------------------
    _torch_archive(torch, Model, model, frames[1])

    # --- 8. each kernel against its plain version ---------------------------
    # (after the paths: profiler sessions slow the launches that follow)
    targets = [
        (port_knn, "knn_topk", "knn_topk"),
        (port_knn, "argmin_1nn", "argmin_1nn"),
        (port_knn, "knn_window_topk", "knn_window_topk"),
        (lfa_kernels, "lfa_round1", "lfa_round1"),
        (lfa_kernels, "attentive_pool2_residual", "lfa_pool2_res"),
    ]
    calls = _record_frame(lambda: model.predict(frames[0]), targets, PER_FRAME, "app path")
    calls64 = _record_frame(lambda: model64.predict(frames64[0]), targets, PER_FRAME_64K,
                            "approx64k")
    calls_live = _record_frame(live_frame, targets, PER_FRAME_LIVE, "live")

    # the gaussian probe bench.py reports, at the tuned default window
    port_knn.reset_window_guard()
    with torch.inference_mode():
        x64 = torch.tensor(
            np.random.RandomState(0).randn(1, 65536, 3).astype(np.float32) * 0.2,
            device="cuda",
        )
        probe = port_knn.measure_recall(x64, x64, 32, "approximate")
    print(f"gaussian probe 0.2*randn(65536, 3), seed 0: sampled recall@32 of "
          f"knn=\"approximate\" at window {port_knn.session_window_points()}: "
          f"{probe:.4f}", flush=True)

    results = _Results()
    with torch.inference_mode():
        _check_kernels(torch, calls, results, "app path", plain_reps=10)
        _check_kernels(torch, calls64, results, "approx64k", plain_reps=3)
        _check_kernels(torch, calls_live, results, "live", plain_reps=10)
        _check_roll_stages(torch, results)
        _time_selection(torch, pipeline, pipeline.cloud_to_depth(
            make_frame(np.random.RandomState(500), 0.0, FRAME_POINTS)[0],
            pipeline.DepthIntrinsics(),
        ))
        _exact_64k(torch, morton, knn_kernels, sample)
    del calls, calls64, calls_live

    # --- 9. result lines ------------------------------------------------------
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results.rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            "library_ms": r["library_ms"],
        })
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
