"""Time B1, B2, B4, B7, B8 and the bfloat16 LFA kernels under launch
policies other than the built ones.

    python -m recognizer3d_tpu_torch.benchmarks.launch_ab [B1 B2 B4 B7 B8 bf16]

Needs a card. Each variant is a copy of ``csrc/`` with one line of a
launcher or one constant changed, built under
``build/torch_kernels/launch_ab/<variant>/`` (four builds at a time), or,
for B8, another launch plan handed to the package's kernel:

* ``group1``, ``group2``: ``knn.cu``'s ``cull_group`` gives every launch of
  the exact KNN kernel (B1) one, or two, queries a warp (as built: two where
  a launch holds more than 64 queries an SM, else one);
* ``cull_global_all``, ``cull_shared_most``: B1 takes its global-memory
  form (the boxes computed by a launch of their own before the walk) at
  every size, or only where the boxes do not fit in a block's shared
  memory (as built: above 2,048 support points);
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
* ``roll_threads64``: B7 in blocks of 64 threads (as built: 128);
* ``cull_no_pdl``: B1's global-memory form with its walk launched as a
  plain launch after the box pass (as built: a programmatic dependent
  launch, which starts the walk's blocks and their first warm start before
  the box pass ends);
* ``select_cluster8``, ``select_cluster4``, ``select_streamed``,
  ``select_rows16384``, ``select_keys_global``: the selection (B8) under
  another launch plan (``ops/select_kernels.select_plan`` with other
  bounds, or ``plan_for`` of another form; no rebuild) with at most 8, or
  4, blocks a row (the live row then no longer
  fits their shared memory: streamed), never staged (every sweep re-reads
  the row), a block for every 16,384 priorities (the train rows over 2
  blocks), or the selected keys in a global scratch (as built: up to 16
  blocks a row, a block for every 4,096 priorities, staged where the slice
  fits, the keys in shared memory where they fit);
* ``bf16_warps8``, ``bf16_warps4``: the bfloat16 round-1 kernel (B2-bf16)
  and pool 2 alone (B5-bf16) in blocks of 8 warps at h = 8, or of 4 at
  h = 32 (as built: 4 and 8); each warp takes one row at a time, so these
  set the rows a block has in flight and how often a block stages the
  constant matrices;
* ``bf16_tile8``, ``bf16_tile16``: pool 2 with the residual (B3-bf16) at
  h = 32 in tiles of 8 rows, 8 warps a block, or at h = 8 in tiles of 16,
  16 warps (as built: 16 at h = 32 and 8 at h = 8, a warp a row).

B1 runs the k = 32 self-KNN of Morton-sorted mock levels at the served
paths' sizes, the recall guard's 256-query re-search of the 65,536-point
level and that level's exact self-KNN, and the large-scene forward's calls
(held to the plain version on 4,096 seeded rows where a call has over 2^32
distances), each timed with its box pass where it has one; B2 runs the
served levels' shapes (K = 32; the LFA kernels read their rows from a table
at indices within 32 rows of each row's own, as Morton-sorted neighbours
lie); B4 the served paths' upsamples
(``benchmarks/argmin_cull.served_cases``), timed with the ordering launch where there is one; B7 the
TPU benchmark's (512, 128, 1024) at S = 1, 5, 6, 12, 15, 16, 24 and 45;
B8 the shapes of ``benchmarks/bench_select.py`` (the live frame's 786,432
priorities -> 16,384 under a seeded and a rounded draw, 4 x 20,000 ->
2,500), timed as a whole call (its one launch);
B2-bf16, B3-bf16 and B5-bf16 the bfloat16 paths' shapes (K = 32; h = 8 at
2,500 and 65,536 rows, h = 32 at 625 and 16,384; F = 8 and 32). Every variant is held
to the plain version first (B1, B4 and B7 bit for bit, B2 within 1e-5, the
bfloat16 kernels within one bfloat16 ulp of the output plus one of its
row's largest magnitude). Each line prints, per variant, two device times a call of
the kernel (torch.profiler) taken in the order built, variants, variants
reversed, built, so that a drift of the card's clock shows.
"""

import argparse
import contextlib
import functools
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from recognizer3d_tpu_torch.benchmarks import argmin_cull
from recognizer3d_tpu_torch.benchmarks.window_select import _mock_level0
from recognizer3d_tpu_torch.benchmarks import bench_select
from recognizer3d_tpu_torch.ops import (_build, bitonic_kernels, knn_kernels, lfa_kernels,
                                        select_kernels)
from recognizer3d_tpu_torch.utils.profiling import device_ms

#: variant -> (source file, line as built, line in the variant)
VARIANTS = {
    "group1": ("knn.cu", "return queries > CULL_ONE_WAVE_QUERIES_PER_SM * sms ? 2 : 1;",
               "return 1;"),
    "group2": ("knn.cu", "return queries > CULL_ONE_WAVE_QUERIES_PER_SM * sms ? 2 : 1;",
               "return 2;"),
    "cull_global_all": ("knn.cu", "constexpr int CULL_GLOBAL_MIN_POINTS = 2048;",
                        "constexpr int CULL_GLOBAL_MIN_POINTS = 0;"),
    "cull_shared_most": ("knn.cu", "constexpr int CULL_GLOBAL_MIN_POINTS = 2048;",
                         "constexpr int CULL_GLOBAL_MIN_POINTS = 1 << 30;"),
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
    "cull_no_pdl": ("knn.cu", "constexpr int CULL_PDL = 1;", "constexpr int CULL_PDL = 0;"),
    "bf16_warps8": ("lfa.cu", "constexpr int BF_WARPS_H8 = 4;", "constexpr int BF_WARPS_H8 = 8;"),
    "bf16_warps4": ("lfa.cu", "constexpr int BF_WARPS_H32 = 8;",
                    "constexpr int BF_WARPS_H32 = 4;"),
    "bf16_tile8": ("lfa.cu", "constexpr int BF_TILE_ROWS_H32 = 16;",
                   "constexpr int BF_TILE_ROWS_H32 = 8;"),
    "bf16_tile16": ("lfa.cu", "constexpr int BF_TILE_ROWS_H8 = 8;",
                    "constexpr int BF_TILE_ROWS_H8 = 16;"),
}


def _form(staged=None, keys_shared=None, select_plan=select_kernels.select_plan):
    """B8's plan: the package's blocks a row, in the given form."""
    def plan(b, n, n_out, sms):
        built = select_plan(b, n, n_out, sms)
        return select_kernels.plan_for(
            b, n, n_out, built.cluster, built.staged if staged is None else staged,
            built.keys_shared if keys_shared is None else keys_shared)
    return plan


#: variant -> B8's plan, a function of (B, N, n_out, SMs) as ``select_plan``
PLAN_VARIANTS = {
    "select_cluster8": functools.partial(select_kernels.select_plan, max_cluster=8),
    "select_cluster4": functools.partial(select_kernels.select_plan, max_cluster=4),
    "select_streamed": _form(staged=False),
    "select_rows16384": functools.partial(select_kernels.select_plan, row_block=16_384),
    "select_keys_global": _form(keys_shared=False),
}


#: the variants each section times beside the built kernels
SECTIONS = {
    "B1": ("group1", "group2", "cull_global_all", "cull_shared_most", "cull_no_pdl"),
    "B2": ("r1_full_tile",),
    "B4": ("argmin_order", "nn_lanes2", "nn_lanes8", "nn_threads256", "nn_threads1024"),
    "B7": ("roll_e32", "roll_e64", "roll_threads64"),
    "B8": tuple(PLAN_VARIANTS),
    "bf16": ("bf16_warps8", "bf16_warps4", "bf16_tile8", "bf16_tile16"),
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


@contextlib.contextmanager
def _planned(name):
    """Run B8 under the launch plan of ``name`` (``PLAN_VARIANTS``; "built":
    the package's), handed to the wrapper in place of ``select_plan``."""
    saved = select_kernels.select_plan
    select_kernels.select_plan = PLAN_VARIANTS.get(name, saved)
    try:
        yield
    finally:
        select_kernels.select_plan = saved


def _knn_cases(dev):
    """(label, support, query, k) of B1's calls: the k = 32 self-KNNs of the
    served paths' mock levels and the guard's re-search, then the large-scene
    forward's (bench_large.py's first 0.2·randn cloud of 1,048,576 points,
    permuted, its levels Morton-sorted): the self-KNNs of 16,384 to 262,144
    points and the 262,144 -> 1,048,576 1-NN at k = 1."""
    from recognizer3d_tpu_torch.benchmarks import bench_large
    from recognizer3d_tpu_torch.ops import morton

    cases = []
    for n, frame in ((2500, 60_000), (625, 60_000), (156, 60_000), (39, 60_000),
                     (4096, 150_000), (1024, 150_000), (65_536, 150_000)):
        x = torch.from_numpy(_mock_level0(n, frame))[None].to(dev)
        cases.append((f"self-KNN N={n}", x, x, 32))
    q = x[:, torch.from_numpy(np.linspace(0, 65_535, 256).astype(np.int64)).to(dev)]
    cases.append(("guard re-search M=256 N=65536", x, q.contiguous(), 32))
    _, clouds = bench_large.inputs(1 << 20)
    cloud, perm = clouds["approximate"]
    x = torch.from_numpy(cloud).to(dev)[:, torch.from_numpy(perm).to(dev)]
    levels = {n: morton.sort_rows(x[:, :n], morton.morton_order(x[:, :n])).contiguous()
              for n in (1 << 20, 1 << 18, 1 << 16, 1 << 14)}
    for n in (1 << 14, 1 << 16, 1 << 18):
        cases.append((f"large self-KNN N={n}", levels[n], levels[n], 32))
    cases.append(("large 1-NN M=1048576 N=262144", levels[1 << 18], levels[1 << 20], 1))
    return cases


def _round1_cases(dev):
    """(label, lfa_round1's arguments) at the served levels' shapes."""
    rng = np.random.RandomState(0)
    return [(f"round1 N={rows} h={h}", _round1_cases_args(rng, dev, rows, h, 32))
            for rows, h in ((2500, 8), (625, 32), (65_536, 8), (16_384, 32))]


def _bf16_cases(dev):
    """(label, lfa_round1's arguments, attentive_pool2_residual's) in
    bfloat16 at the bfloat16 paths' shapes, pool 2 on round 1's rpe2."""
    rng = np.random.RandomState(1)
    cases = []
    for rows, h, f in ((2500, 8, 8), (625, 32, 32), (65_536, 8, 8), (16_384, 32, 32)):
        k, c2 = 32, 2 * h
        r1 = _round1_cases_args(rng, dev, rows, h, k)
        r1[0] = r1[0].to(torch.bfloat16)
        _, rpe2 = lfa_kernels.lfa_round1(*r1)
        head = [torch.tensor(rng.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                for s in ((c2, c2), (c2, c2), (c2,), (c2,), (c2,))]
        head[3] = head[3].abs() + 0.5  # BatchNorm scale
        table = torch.tensor(np.abs(rng.randn(1, rows, h)) * 0.3, device=dev).to(torch.bfloat16)
        f_in = torch.tensor(rng.randn(1, rows, f), device=dev).to(torch.bfloat16)
        tail = [torch.tensor(rng.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                for s in ((c2, 4 * h), (f, 4 * h), (4 * h,))]
        cases.append((f"N={rows} h={h} F={f}", r1, [rpe2, table, r1[1], *head, f_in, *tail]))
    return cases


def _neighbors(rng, dev, rows, k):
    """(1, rows, k) int32 indices within 32 rows of each row's own."""
    nb = np.arange(rows)[:, None] + rng.randint(-32, 33, (rows, k))
    return torch.tensor(np.clip(nb, 0, rows - 1)[None], dtype=torch.int32, device=dev)


def _round1_cases_args(rng, dev, rows, h, k):
    """lfa_round1's arguments: the table, its neighbour indices, d2, the
    centre term, then the weights."""
    c2 = 2 * h
    shapes = [(1, rows, c2), (1, rows, k), (1, rows, h), (h,), (h,), (h,), (h,),
              (c2, c2), (c2, h), (h,), (h,), (h,), (h, h), (h,), (h,), (h,)]
    args = [torch.tensor(rng.randn(*s) * 0.3, dtype=torch.float32, device=dev) for s in shapes]
    args[1] = args[1].abs() * 0.01  # squared distances
    for i in (5, 10, 14):  # BatchNorm scales
        args[i] = args[i].abs() + 0.5
    return [args[0], _neighbors(rng, dev, rows, k), *args[1:]]


def _near_bf16(out, ref) -> bool:
    """Within one bfloat16 ulp of itself plus one of its row's largest."""
    d, r = (out.float() - ref.float()).abs(), ref.float().abs()
    return bool((d <= 2.0**-7 * (r + r.amax(-1, keepdim=True)) + 1e-6).all())


def _line(label, variants, timed, reps):
    order = list(variants) + list(reversed(variants))
    times = {name: [] for name in variants}
    for name in order:
        times[name].append(timed(name, reps))
    print(f"{label}: " + ", ".join(
        f"{name} {t[0]:.4f}/{t[1]:.4f}" for name, t in times.items()) + " ms", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sections", nargs="*", choices=list(SECTIONS), default=list(SECTIONS),
                        help="the kernels to time (default: all)")
    opts = parser.parse_args()
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"gpu: {gpu}", flush=True)
    names = [v for sec in opts.sections for v in SECTIONS[sec] if v in VARIANTS]
    libs = {"built": _build.library()}
    with ThreadPoolExecutor(4) as pool:
        libs.update(zip(names, pool.map(_build_variant, names)))

    if "B1" in opts.sections:
        knn_variants = ("built", *SECTIONS["B1"])
        for label, s, q, k in _knn_cases(dev):
            m, n = q.shape[1], s.shape[1]
            rows = torch.arange(m, device=dev)
            if m * n > 1 << 32:  # the plain version on 4,096 seeded rows
                rows = torch.from_numpy(np.sort(
                    np.random.RandomState(0).choice(m, 4096, replace=False))).to(dev)
            ref = knn_kernels.knn_topk_plain(s, q[:, rows].contiguous(), k)
            for name in knn_variants:
                with _using(libs[name]):
                    idx, d2 = knn_kernels.knn_topk(s, q, k)
                if not (torch.equal(idx[:, rows], ref[0]) and torch.equal(d2[:, rows], ref[1])):
                    raise RuntimeError(f"B1 {label} on {name}: not equal to the plain version")
            del ref, idx, d2

            def timed(name, reps, s=s, q=q, k=k):
                # "knn_": the walk and, in the global-memory form, its box pass
                with _using(libs[name]):
                    return device_ms(lambda: knn_kernels.knn_topk(s, q, k), reps, "knn_")

            _line(f"B1 {label} k={k}", knn_variants, timed, 5 if n > 10_000 else 50)

    if "B2" in opts.sections:
        r1_variants = ("built", *SECTIONS["B2"])
        for label, args in _round1_cases(dev):
            ref_p, ref_r = lfa_kernels.lfa_round1_plain(
                *args[:4], lfa_kernels.round1_constants(*args[4:]))
            for name in r1_variants:
                with _using(libs[name]):
                    pooled, rpe2 = lfa_kernels.lfa_round1(*args)
                err = max((pooled - ref_p).abs().max().item(), (rpe2 - ref_r).abs().max().item())
                if err > 1e-5:
                    raise RuntimeError(f"B2 {label} on {name}: max abs err {err:.3g}")

            def timed(name, reps, args=args):
                with _using(libs[name]):
                    return device_ms(
                        lambda: lfa_kernels.lfa_round1(*args), reps, "lfa_round1_tile_kernel")

            _line(f"B2 {label} K={k}", r1_variants, timed, 50)

    if "B4" in opts.sections:
        b4_variants = ("built", *SECTIONS["B4"])
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
                    return device_ms(lambda: knn_kernels.argmin_1nn(s, q), reps, "argmin_")

            _line(f"B4 {label} (kernel + ordering)", b4_variants, timed, 50)

    if "B7" in opts.sections:
        b7_variants = ("built", *SECTIONS["B7"])
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
                    return device_ms(
                        lambda: bitonic_kernels.roll_stages(x, stages), reps, "roll_stages_kernel")

            _line(f"B7 (512, 128, 1024) S={stages}", b7_variants, timed, 20)

    if "B8" in opts.sections:
        b8_variants = ("built", *SECTIONS["B8"])
        for label, priority, n_out in bench_select.cases(dev):
            ref = select_kernels.select_smallest_plain(priority, n_out)
            for name in b8_variants:
                with _planned(name):
                    if not torch.equal(select_kernels.select_smallest(priority, n_out), ref):
                        raise RuntimeError(f"B8 {label} on {name}: not equal to the plain version")
            del ref

            def timed(name, reps, priority=priority, n_out=n_out):
                with _planned(name):
                    return device_ms(
                        lambda: select_kernels.select_smallest(priority, n_out), reps, "select_")

            _line(f"B8 {label}", b8_variants, timed, 50)

    if "bf16" in opts.sections:
        bf_variants = ("built", *SECTIONS["bf16"])
        for label, r1, p2 in _bf16_cases(dev):
            bf16 = torch.bfloat16
            rows, h = r1[0].shape[1], r1[0].shape[2] // 2
            refs = (
                *lfa_kernels.lfa_round1_plain(
                    *r1[:4], lfa_kernels.round1_constants(*r1[4:], dtype=bf16)),
                lfa_kernels.attentive_pool2_residual_plain(
                    *p2[:3], p2[8],
                    lfa_kernels.pool2_constants(*p2[3:8], *p2[9:], dtype=bf16)),
                lfa_kernels.attentive_pool2_plain(
                    *p2[:3], lfa_kernels.pool2_constants(*p2[3:8], dtype=bf16)),
            )
            for name in bf_variants:
                with _using(libs[name]):
                    outs = (*lfa_kernels.lfa_round1(*r1),
                            lfa_kernels.attentive_pool2_residual(*p2),
                            lfa_kernels.attentive_pool2(*p2[:8]))
                # rpe2's rows: one neighbour's h channels
                pairs = [(o.reshape(1, rows, 32, h), r.reshape(1, rows, 32, h)) if i == 1
                         else (o, r) for i, (o, r) in enumerate(zip(outs, refs))]
                if not all(_near_bf16(o, r) for o, r in pairs):
                    raise RuntimeError(f"bf16 {label} on {name}: beyond the plain versions")
            del outs, refs, pairs

            def timed_r1(name, reps, r1=r1):
                with _using(libs[name]):
                    return device_ms(
                        lambda: lfa_kernels.lfa_round1(*r1), reps, "lfa_round1_mma_kernel")

            def timed_p2(name, reps, p2=p2):
                with _using(libs[name]):
                    return device_ms(
                        lambda: lfa_kernels.attentive_pool2_residual(*p2), reps,
                        "lfa_pool2_mma_kernel")

            def timed_p5(name, reps, p2=p2):
                with _using(libs[name]):
                    return device_ms(
                        lambda: lfa_kernels.attentive_pool2(*p2[:8]), reps,
                        "lfa_pool2_mma_kernel")

            _line(f"B2-bf16 {label} K=32", bf_variants, timed_r1, 50)
            _line(f"B3-bf16 {label} K=32", bf_variants, timed_p2, 50)
            _line(f"B5-bf16 {label} K=32", bf_variants, timed_p5, 50)


if __name__ == "__main__":
    main()
