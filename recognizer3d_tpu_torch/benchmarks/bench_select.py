"""B8 (``csrc/select.cu``, ``ops/select_kernels.select_smallest``) kernel by
kernel on the card, at the live shape and the train shape, beside
``torch.sort`` (stable: the plain version and the library call) and
``torch.topk``.

    python -m recognizer3d_tpu_torch.benchmarks.bench_select [--reps 50]

Shapes: the live frame's 786,432 priorities with 53,700 valid (the mock
depth frame of ``chip_smoke.py``; the rest +inf) -> 16,384, its seeded
draw and the draw rounded to 1/256; a train batch, 4 x 20,000 -> 2,500
with one row of 1,800 valid points. Each call is held bit-equal to the
stable sort first. Device times from torch.profiler
(``utils/profiling.device_ms``): B8's one launch a call
(``select_cluster_kernel``, its launch plan printed beside it), and the
whole call (every kernel the call ran).
"""

import argparse
import dataclasses
import json

import torch

from recognizer3d_tpu_torch.ops import select_kernels
from recognizer3d_tpu_torch.utils import profiling
from recognizer3d_tpu_torch.utils.device import resolve_device

KERNEL = "select_cluster_kernel"  # a call: one cluster launch
LIVE_N, LIVE_VALID, LIVE_OUT = 786_432, 53_700, 16_384


def cases(dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = torch.rand((1, LIVE_N), generator=gen, device=dev)
    valid = torch.zeros(LIVE_N, dtype=torch.bool, device=dev)
    valid[torch.randperm(LIVE_N, generator=gen, device=dev)[:LIVE_VALID]] = True
    inf = torch.full_like(u, float("inf"))
    train = torch.rand((4, 20_000), generator=gen, device=dev)
    train[1, 1_800:] = float("inf")
    return [("live, seeded draw", torch.where(valid, u, inf), LIVE_OUT),
            ("live, draw rounded to 1/256", torch.where(valid, torch.floor(u * 256) / 256, inf),
             LIVE_OUT),
            ("train, 4 x 20,000", train, 2_500)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    for label, priority, n_out in cases(dev):
        got = select_kernels.select_smallest(priority, n_out)
        if not torch.equal(got, select_kernels.select_smallest_plain(priority, n_out)):
            raise RuntimeError(f"{label}: B8 differs from the stable sort")

        def call(priority=priority, n_out=n_out):
            return select_kernels.select_smallest(priority, n_out)

        b8_ms = profiling.device_ms(call, args.reps)
        kernel_ms = profiling.device_ms(call, args.reps, KERNEL)
        sort_ms = profiling.device_ms(lambda: torch.sort(priority, dim=-1, stable=True), args.reps)
        topk_ms = profiling.device_ms(
            lambda: torch.topk(priority, n_out, dim=-1, largest=False), args.reps)
        b, n = priority.shape
        plan = select_kernels.select_plan(
            b, n, n_out, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(json.dumps({
            "case": label, "B": b, "N": n, "n_out": n_out, "plan": dataclasses.asdict(plan),
            "b8_ms": b8_ms, "b8_kernels_ms": kernel_ms, "torch_sort_ms": sort_ms,
            "torch_topk_ms": topk_ms,
            "bound_ms": (4 * b * n + 8 * b * n_out) / 3.35e12 * 1e3,
            "device": torch.cuda.get_device_name(dev),
        }), flush=True)


if __name__ == "__main__":
    main()
