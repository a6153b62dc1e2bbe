"""Time B1, B2, B4 and B7 under launch policies other than the built ones.

    python -m recognizer3d_tpu_torch.benchmarks.launch_ab

Needs a card. Each variant is a copy of ``csrc/`` with one line of a
launcher or one constant changed, built under
``build/torch_kernels/launch_ab/<variant>/`` (four builds at a time):

* ``group1``, ``group2``: ``knn.cu``'s ``cull_group`` gives every launch of
  the exact KNN kernel (B1) one, or two, queries a warp (as built: two where
  a launch holds more than 64 queries an SM, else one);
* ``r1_full_tile``: the round-1 kernel (B2) at h = 8 takes pool 2's tile of
  rows (as built: half of it, in blocks of half the threads);
* ``argmin_order``: the 1-NN kernel (B4) has every support ordered into
  cells by a launch of its own before it (as built: each CUDA block orders
  the support in its shared memory where it fits, about 4,500 points, and
  only larger supports take the ordering launch);
* ``nn_lanes2``, ``nn_lanes8``: B4 with two, or eight, lanes walking a
  query (as built: four);
* ``nn_threads256``, ``nn_threads1024``: B4 in blocks of 256, or 1,024,
  threads (as built: 512);
* ``roll_e32``, ``roll_e64``: the bitonic stage kernel (B7) with 32, or 64,
  elements a thread at every S (as built: 32 up to S = 15, 64 beyond);
* ``roll_threads64``: B7 in blocks of 64 threads (as built: 128).

B1 runs the k = 32 self-KNN of Morton-sorted mock levels at the served
paths' sizes, the recall guard's 256-query re-search of the 65,536-point
level and that level's exact self-KNN; B2 runs the served levels' shapes
(K = 32); B4 the served paths' upsamples (``benchmarks/argmin_cull.
served_cases``), timed with the ordering launch where there is one; B7 the
TPU benchmark's (512, 128, 1024) at S = 1, 5, 6, 12, 15, 16, 24 and 45.
Every variant is held to
the plain version first (B1, B4 and B7 bit for bit, B2 within 1e-5). Each line prints, per variant, two device times a call of
the kernel (torch.profiler) taken in the order built, variants, variants
reversed, built, so that a drift of the card's clock shows.
"""

import contextlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from recognizer3d_tpu_torch.benchmarks import argmin_cull
from recognizer3d_tpu_torch.benchmarks.window_select import _mock_level0
from recognizer3d_tpu_torch.ops import _build, bitonic_kernels, knn_kernels, lfa_kernels

#: variant -> (source file, line as built, line in the variant)
VARIANTS = {
    "group1": ("knn.cu", "return queries > CULL_ONE_WAVE_QUERIES_PER_SM * sms ? 2 : 1;",
               "return 1;"),
    "group2": ("knn.cu", "return queries > CULL_ONE_WAVE_QUERIES_PER_SM * sms ? 2 : 1;",
               "return 2;"),
    "r1_full_tile": ("lfa.cu", "const int tr = H == 8 ? tile_rows(K, H) / 2 : tile_rows(K, H);",
                     "const int tr = tile_rows(K, H);"),
    "argmin_order": ("knn.cu",
                     "inline bool nn_staged(int n) { return nn_stage_bytes(n) <= NN_STAGE_BYTES; }",
                     "inline bool nn_staged(int n) { return false; }"),
    "nn_lanes2": ("knn.cu", "constexpr int NN_LANES = 4;", "constexpr int NN_LANES = 2;"),
    "nn_lanes8": ("knn.cu", "constexpr int NN_LANES = 4;", "constexpr int NN_LANES = 8;"),
    "nn_threads256": ("knn.cu", "constexpr int NN_THREADS = 512;",
                      "constexpr int NN_THREADS = 256;"),
    "nn_threads1024": ("knn.cu", "constexpr int NN_THREADS = 512;",
                       "constexpr int NN_THREADS = 1024;"),
    "roll_e32": ("bitonic.cu", "return stages <= ROLL_E32_MAX_STAGES ? 32 : 64;", "return 32;"),
    "roll_e64": ("bitonic.cu", "return stages <= ROLL_E32_MAX_STAGES ? 32 : 64;", "return 64;"),
    "roll_threads64": ("bitonic.cu", "constexpr int ROLL_THREADS = 128;",
                       "constexpr int ROLL_THREADS = 64;"),
}


def _build_variant(name: str):
    src, old, new = VARIANTS[name]
    out = _build.BUILD_DIR / "launch_ab" / name
    csrc = out / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    text = (csrc / src).read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"{name}: the line to change is not once in {src}: {old}")
    (csrc / src).write_text(text.replace(old, new))
    return _build.load(_build.build(csrc, out))


@contextlib.contextmanager
def _using(lib):
    """Run the wrappers on ``lib`` instead of the package's library."""
    saved, _build._lib = _build._lib, lib
    try:
        yield
    finally:
        _build._lib = saved


def _ms(fn, reps: int, kernel: str) -> float:
    """Device ms a call of the kernels whose name holds ``kernel``
    (torch.profiler), over ``reps`` calls after one warm-up call; a session
    that recorded fewer of those kernels than calls (the card's profiler
    now and then drops a session's activity) is taken again, up to three
    times."""
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
        us = sum(e.self_device_time_total for e in events)
        if us > 0 and sum(e.count for e in events) >= reps:
            return us / 1e3 / reps
    raise RuntimeError(f"the profiler recorded no device time for {kernel}")


def _knn_cases(dev):
    """(label, support, query) of B1's k = 32 calls."""
    cases = []
    for n, frame in ((2500, 60_000), (625, 60_000), (156, 60_000), (39, 60_000),
                     (4096, 150_000), (1024, 150_000), (65_536, 150_000)):
        x = torch.from_numpy(_mock_level0(n, frame))[None].to(dev)
        cases.append((f"self-KNN N={n}", x, x))
    q = x[:, torch.from_numpy(np.linspace(0, 65_535, 256).astype(np.int64)).to(dev)]
    cases.append(("guard re-search M=256 N=65536", x, q.contiguous()))
    return cases


def _round1_cases(dev):
    """(label, lfa_round1's arguments) at the served levels' shapes."""
    rng = np.random.RandomState(0)
    cases = []
    for rows, h in ((2500, 8), (625, 32), (65_536, 8), (16_384, 32)):
        k, c2 = 32, 2 * h
        shapes = [(1, rows, k, c2), (1, rows, k), (1, rows, h), (h,), (h,), (h,), (h,),
                  (c2, c2), (c2, h), (h,), (h,), (h,), (h, h), (h,), (h,), (h,)]
        args = [torch.tensor(rng.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                for s in shapes]
        args[1] = args[1].abs() * 0.01  # squared distances
        for i in (5, 10, 14):  # BatchNorm scales
            args[i] = args[i].abs() + 0.5
        cases.append((f"round1 N={rows} h={h}", args))
    return cases


def _line(label, variants, timed, reps):
    order = list(variants) + list(reversed(variants))
    times = {name: [] for name in variants}
    for name in order:
        times[name].append(timed(name, reps))
    print(f"{label}: " + ", ".join(
        f"{name} {t[0]:.4f}/{t[1]:.4f}" for name, t in times.items()) + " ms", flush=True)


def main() -> None:
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}", flush=True)
    libs = {"built": _build.library()}
    with ThreadPoolExecutor(4) as pool:
        libs.update(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))

    k = 32
    knn_variants = ("built", "group1", "group2")
    for label, s, q in _knn_cases(dev):
        ref = knn_kernels.knn_topk_plain(s, q, k)
        for name in knn_variants:
            with _using(libs[name]):
                idx, d2 = knn_kernels.knn_topk(s, q, k)
            if not (torch.equal(idx, ref[0]) and torch.equal(d2, ref[1])):
                raise RuntimeError(f"B1 {label} on {name}: not equal to the plain version")
        del ref

        def timed(name, reps, s=s, q=q):
            with _using(libs[name]):
                return _ms(lambda: knn_kernels.knn_topk(s, q, k), reps, "knn_cull_kernel")

        _line(f"B1 {label} k={k}", knn_variants, timed, 5 if s.shape[1] > 10_000 else 50)

    r1_variants = ("built", "r1_full_tile")
    for label, args in _round1_cases(dev):
        ref_p, ref_r = lfa_kernels.lfa_round1_plain(
            *args[:3], lfa_kernels.round1_constants(*args[3:]))
        for name in r1_variants:
            with _using(libs[name]):
                pooled, rpe2 = lfa_kernels.lfa_round1(*args)
            err = max((pooled - ref_p).abs().max().item(), (rpe2 - ref_r).abs().max().item())
            if err > 1e-5:
                raise RuntimeError(f"B2 {label} on {name}: max abs err {err:.3g}")

        def timed(name, reps, args=args):
            with _using(libs[name]):
                return _ms(lambda: lfa_kernels.lfa_round1(*args), reps,
                           "lfa_round1_tile_kernel")

        _line(f"B2 {label} K={k}", r1_variants, timed, 50)

    b4_variants = ("built", "argmin_order", "nn_lanes2", "nn_lanes8", "nn_threads256",
                   "nn_threads1024")
    for label, s, q in argmin_cull.served_cases():
        s = torch.from_numpy(s)[None].to(dev)
        q = torch.from_numpy(q)[None].to(dev)
        ref_i, ref_d = knn_kernels.knn_topk_plain(s, q, 1)
        for name in b4_variants:
            with _using(libs[name]):
                idx, d2 = knn_kernels.argmin_1nn(s, q)
            if not (torch.equal(idx, ref_i) and torch.equal(d2, ref_d)):
                raise RuntimeError(f"B4 {label} on {name}: not equal to the plain version")

        def timed(name, reps, s=s, q=q):
            with _using(libs[name]):
                return _ms(lambda: knn_kernels.argmin_1nn(s, q), reps, "argmin_")

        _line(f"B4 {label} (kernel + ordering)", b4_variants, timed, 50)

    b7_variants = ("built", "roll_e32", "roll_e64", "roll_threads64")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.rand((512, 128, 1024), generator=gen, device=dev)
    for stages in (1, 5, 6, 12, 15, 16, 24, 45):
        ref = bitonic_kernels.roll_stages_plain(x, stages)
        for name in b7_variants:
            with _using(libs[name]):
                if not torch.equal(bitonic_kernels.roll_stages(x, stages), ref):
                    raise RuntimeError(f"B7 S={stages} on {name}: not equal to the plain version")
        del ref

        def timed(name, reps, stages=stages):
            with _using(libs[name]):
                return _ms(lambda: bitonic_kernels.roll_stages(x, stages), reps,
                           "roll_stages_kernel")

        _line(f"B7 (512, 128, 1024) S={stages}", b7_variants, timed, 20)


if __name__ == "__main__":
    main()
