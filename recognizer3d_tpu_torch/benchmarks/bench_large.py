"""Large-scene benchmark on one card (counterpart of
``benchmarks/bench_large.py``, BASELINE.json config 5): million-point
S3DIS-style clouds through the exact KNN kernel and the chunked eval forward
(``models/large.py``).

    python -m recognizer3d_tpu_torch.benchmarks.bench_large [n_points]

Prints the JAX script's JSON lines: the exact k = 32 self-KNN of a uniform
cloud (Morton sort, the kernel, unsort, as the JAX ``knn_pallas`` does),
then the RandLA-Net forward (random weights, seed 0, K = 32, decimation 4,
the default layers) on ``0.2·randn`` clouds with ``knn="approximate"`` and
``knn="naive"``: the median wall of 3 synchronised calls after one warm-up
call, with the peak device memory of the forward. ``device`` carries the
card's name and power limit (``nvidia-smi``). Runs on the card only.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from recognizer3d_tpu_torch.models.facade import Model
from recognizer3d_tpu_torch.models.settings import RandLANetSettings
from recognizer3d_tpu_torch.ops import knn as port_knn
from recognizer3d_tpu_torch.ops import knn_kernels, morton
from recognizer3d_tpu_torch.utils.device import resolve_device

APPROACHES = ("approximate", "naive")


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def inputs(n_points: int, seed: int = 0):
    """The JAX script's draws from one ``RandomState(seed)``: the uniform
    (1, N, 3) cloud of the KNN line, then for each approach in
    ``APPROACHES`` a ``0.2·randn`` (1, N, 3) cloud and its permutation."""
    rng = np.random.RandomState(seed)
    cloud = rng.rand(1, n_points, 3).astype(np.float32)
    clouds = {}
    for approach in APPROACHES:
        x = rng.randn(1, n_points, 3).astype(np.float32) * 0.2
        clouds[approach] = (x, rng.permutation(n_points).astype(np.int64))
    return cloud, clouds


def exact_self_knn(cloud: torch.Tensor, k: int = 32):
    """Exact self-KNN of an unsorted (B, N, 3) cloud: Morton sort, the KNN
    kernel, results mapped back to the given order."""
    order = morton.morton_order(cloud)
    x = morton.sort_rows(cloud, order).contiguous()
    idx, d2 = knn_kernels.knn_topk(x, x, k)
    return morton.unsort_results(idx, d2, order, order)


def wall_ms(fn, reps: int = 3) -> float:
    """Median wall (ms) of ``reps`` synchronised calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main(n_points: int = 1_048_576) -> None:
    dev = resolve_device("cuda")
    device = gpu_line()
    cloud, clouds = inputs(n_points)
    with torch.inference_mode():
        x = torch.from_numpy(cloud).to(dev)
        knn_ms = wall_ms(lambda: exact_self_knn(x, 32))
        print(json.dumps({"metric": f"exact self-KNN k=32 @ {n_points} pts",
                          "value": round(knn_ms, 1), "unit": "ms", "device": device}),
              flush=True)
        del x
        for approach in APPROACHES:
            port_knn.reset_window_guard()
            settings = RandLANetSettings(n_classes=2, n_features=0, knn=approach,
                                         n_points=n_points, n_neighbors=32, decimation=4)
            model = Model(settings, seed=0, device=dev)
            x, perm = (torch.from_numpy(a).to(dev) for a in clouds[approach])
            torch.cuda.reset_peak_memory_stats(dev)
            fwd_ms = wall_ms(lambda: model._forward(x, perm))
            print(json.dumps({
                "metric": f"RandLA-Net forward @ {n_points} pts (knn={approach})",
                "value": round(fwd_ms, 1), "unit": "ms", "device": device,
                "peak_memory_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3),
            }), flush=True)
            del model, x, perm


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_048_576)
