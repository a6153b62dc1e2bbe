"""B1's global-memory route (``csrc/knn.cu``: the box pass ``knn_box_kernel``,
then the walk ``knn_cull_kernel``) on the card, at the sizes the served
paths give it, beside the launch floor.

    python -m recognizer3d_tpu_torch.benchmarks.bench_box [--reps 50] [--csrc NAME=DIR ...]

Cases: the k = 32 self-KNN of Morton-sorted mock levels of 2,500 points (the
app frame's level 0), 4,096 (approx64k's exact level) and 16,384 (an
sp-train rank's block size), and of ``bench_large``'s first ``0.2·randn``
cloud Morton-sorted at 262,144 and 1,048,576 points (large-exact). Each
call is held to the plain version (on 4,096 seeded rows where it has over
2^32 distances) and its boxes to ``knn_kernels.cull_boxes_plain``
(``amin``/``amax`` over tiles and super tiles), bit for bit. Per case and
library, from torch.profiler over ``reps`` calls
(``utils/profiling.kernel_ms``): the box pass's device ms, the walk's,
their sum, and the route's span, the mean over the calls of the walk's end
less the box pass's start (the walk may start before the box pass ends,
and its duration then includes its wait). One line gives the device time
of a one-element ``fill_``: the launch floor, which no kernel beats.

``--csrc NAME=DIR`` times the kernels built from another ``csrc`` (an
earlier tree's, with the same C interface for B1) beside the package's,
in the order package, others, others reversed, package.
"""

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from recognizer3d_tpu_torch.ops import _build, knn_kernels
from recognizer3d_tpu_torch.utils import profiling

BOX, WALK = "knn_box_kernel", "knn_cull_kernel"
K = 32


def cases(dev):
    """(label, Morton-sorted support (1, N, 3)) of the route's served sizes."""
    from recognizer3d_tpu_torch.benchmarks import bench_large
    from recognizer3d_tpu_torch.benchmarks.window_select import _mock_level0
    from recognizer3d_tpu_torch.ops import morton

    out = [(f"mock level N={n}", torch.from_numpy(_mock_level0(n, frame))[None].to(dev))
           for n, frame in ((2_500, 60_000), (4_096, 150_000), (16_384, 150_000))]
    _, clouds = bench_large.inputs(1 << 20)
    cloud, perm = clouds["approximate"]
    x = torch.from_numpy(cloud).to(dev)[:, torch.from_numpy(perm).to(dev)]
    for n in (1 << 18, 1 << 20):
        level = x[:, :n]
        out.append((f"large level N={n}",
                    morton.sort_rows(level, morton.morton_order(level)).contiguous()))
    return out


def _check(label, s):
    m = n = s.shape[1]
    rows = torch.arange(m, device=s.device)
    if m * n > 1 << 32:
        rows = torch.from_numpy(np.sort(
            np.random.RandomState(0).choice(m, 4096, replace=False))).to(s.device)
    _build.reset_launches()
    idx, d2 = knn_kernels.knn_topk(s, s, K)
    if dict(_build.LAUNCHES) != {"knn_topk": 1, "knn_topk_boxes": 1}:
        raise RuntimeError(f"{label}: launches {dict(_build.LAUNCHES)}, expected the global form")
    ref_i, ref_d = knn_kernels.knn_topk_plain(s, s[:, rows].contiguous(), K)
    if not (torch.equal(idx[:, rows], ref_i) and torch.equal(d2[:, rows], ref_d)):
        raise RuntimeError(f"{label}: B1 differs from the plain version")
    if not torch.equal(knn_kernels.cull_boxes(s), knn_kernels.cull_boxes_plain(s)):
        raise RuntimeError(f"{label}: the boxes differ from amin/amax")


def main(argv=None) -> None:
    from recognizer3d_tpu_torch.benchmarks.launch_ab import _using

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--csrc", action="append", default=[], metavar="NAME=DIR",
                    help="also time the kernels built from DIR, under NAME")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    libs = {"package": _build.library()}
    specs = [spec.split("=", 1) for spec in args.csrc]
    with ThreadPoolExecutor(4) as pool:
        built = pool.map(lambda spec: _build.build(Path(spec[1]),
                                                   _build.BUILD_DIR / "bench_box" / spec[0]),
                         specs)
        libs.update((name, _build.load(path)) for (name, _), path in zip(specs, built))
    order = list(libs) + list(reversed(libs))
    print(json.dumps({"gpu": gpu, "launch_floor_ms": profiling.launch_floor_ms()}), flush=True)
    for label, s in cases(dev):
        reps = args.reps if s.shape[1] <= 20_000 else max(5, args.reps // 10)
        rows = {name: [] for name in libs}
        for name in order:
            with _using(libs[name]):
                _check(label, s)
                (box, walk), span = profiling.kernel_ms(
                    lambda: knn_kernels.knn_topk(s, s, K), reps, (BOX, WALK), span=True)
            rows[name].append({"box_ms": box, "walk_ms": walk, "sum_ms": box + walk,
                               "span_ms": span})
        n = s.shape[1]
        nt = -(-n // 32)
        # the box pass reads the support once and writes the boxes once
        box_bound = (12 * n + 24 * (nt + -(-nt // 32))) / 3.35e12 * 1e3
        print(json.dumps({"case": label, "N": n, "k": K, "box_bound_ms": box_bound,
                          "times": rows}), flush=True)


if __name__ == "__main__":
    main()
