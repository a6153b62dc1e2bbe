"""B8 (``csrc/select.cu``, ``ops/select_kernels.select_smallest``) kernel by
kernel on the card, at the live shape and the train shape, beside
``torch.sort`` (stable: the plain version and the library call) and
``torch.topk``.

    python -m recognizer3d_tpu_torch.benchmarks.bench_select [--reps 50]

Shapes: the live frame's 786,432 priorities with 53,700 valid (the mock
depth frame of ``chip_smoke.py``; the rest +inf) -> 16,384, its seeded
draw and the draw rounded to 1/256; a train batch, 4 x 20,000 -> 2,500
with one row of 1,800 valid points. Each call is held bit-equal to the
stable sort first. Device times from torch.profiler: per kernel of B8 the
mean of a launch and its launches a call, and the whole call (every
kernel and the memset of its scratch).
"""

import argparse
import json

import torch

from recognizer3d_tpu_torch.ops import select_kernels
from recognizer3d_tpu_torch.utils.device import resolve_device

KERNELS = ("select_hist_kernel", "select_count_kernel", "select_scatter_kernel",
           "select_sort_pass_kernel")
LAUNCHES = 9  # a call: the threshold's 3, the compaction's 2, the sort's 4
LIVE_N, LIVE_VALID, LIVE_OUT = 786_432, 53_700, 16_384


def _profile(fn, reps, launches=1, names=None):
    """{kernel or operator name: (device us summed, count)} of ``reps`` calls
    after one warm-up call. The card's profiler now and then drops events:
    a session with fewer than ``launches`` device events a call (of the
    kernels ``names``, or of any) is taken again, up to three sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        seen = sum(c for k, (_, c) in events.items()
                   if names is None or any(n in k for n in names))
        if seen >= launches * reps:
            return events
    raise RuntimeError(f"the profiler kept {seen} of {launches * reps} device events")


def _ms(events, reps, names=None):
    """Device ms a call: of the events whose key holds one of ``names``, or of
    all events."""
    return sum(us for key, (us, _) in events.items()
               if names is None or any(n in key for n in names)) / 1e3 / reps


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
        events = _profile(lambda: select_kernels.select_smallest(priority, n_out), args.reps,
                          LAUNCHES, KERNELS)
        per_kernel = {}
        for name in KERNELS:
            us = sum(v[0] for k, v in events.items() if name in k)
            count = sum(v[1] for k, v in events.items() if name in k)
            per_kernel[name] = {"ms_a_launch": us / 1e3 / max(count, 1),
                                "launches_a_call": count / args.reps}
        sort_ms = _ms(_profile(lambda: torch.sort(priority, dim=-1, stable=True), args.reps),
                      args.reps)
        topk_ms = _ms(_profile(
            lambda: torch.topk(priority, n_out, dim=-1, largest=False), args.reps), args.reps)
        b, n = priority.shape
        print(json.dumps({
            "case": label, "B": b, "N": n, "n_out": n_out,
            "b8_ms": _ms(events, args.reps), "b8_kernels_ms": _ms(events, args.reps, KERNELS),
            "per_kernel": per_kernel, "torch_sort_ms": sort_ms, "torch_topk_ms": topk_ms,
            "bound_ms": (4 * b * n + 8 * b * n_out) / 3.35e12 * 1e3,
            "device": torch.cuda.get_device_name(dev),
        }), flush=True)


if __name__ == "__main__":
    main()
