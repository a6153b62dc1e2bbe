"""Profiling and warm-up helpers (counterpart of
``recognizer3d_tpu/utils/profiling.py``).

- :func:`warmup`: run a function once and wait for its result (the first
  call pays the kernel build and load);
- :func:`timeit` / :func:`timeit_amortized`: wall-clock timing that waits
  for the device. PyTorch returns before the GPU finishes, so every timed
  call ends in a synchronisation of the devices its outputs lie on;
- :func:`device_ms` / :func:`kernel_ms`: device time from torch.profiler's
  CUDA activity, a call's or a kernel launch's, and the span of a route of
  kernels from the first one's start to the last one's end;
  :func:`launch_floor_ms`: the device time of the least launch.
"""

import time
from typing import Callable

import numpy as np
import torch


def _leaves(out):
    if isinstance(out, dict):
        for value in out.values():
            yield from _leaves(value)
    elif isinstance(out, (list, tuple)):
        for value in out:
            yield from _leaves(value)
    else:
        yield out


def _wait(out) -> None:
    """Wait until every tensor in ``out`` (nested lists, tuples, dicts) is
    computed."""
    devices = {leaf.device for leaf in _leaves(out) if isinstance(leaf, torch.Tensor)}
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def warmup(fn: Callable, *args, **kwargs):
    """Run ``fn`` once and wait for its result."""
    out = fn(*args, **kwargs)
    _wait(out)
    return out


def timeit(fn: Callable, *args, iters: int = 10, warmup_iters: int = 2) -> float:
    """Median wall seconds of one call, launch and wait included."""
    for _ in range(warmup_iters):
        _wait(fn(*args))
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def timeit_amortized(fn: Callable, *args, iters: int = 20) -> float:
    """Wall seconds a call over ``iters`` calls launched back to back and
    waited for once at the end: the device's throughput, with the host's
    launch gaps hidden behind the queued work."""
    _wait(fn(*args))
    t = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    _wait(outs)
    return (time.perf_counter() - t) / iters


def _device_ranges(fn: Callable, reps: int, names, enough: Callable):
    """For each of ``names``, the time ranges (sorted by start) of the
    device events whose name holds it, over ``reps`` calls of ``fn`` after
    one warm-up call. The card's profiler now and then drops a session's
    device events: a session that is not ``enough`` (a predicate of the
    ranges) is taken again, up to three sessions; if none is, RuntimeError."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = [sorted((e.time_range for e in device if name in e.name), key=lambda r: r.start)
                for name in names]
        if enough(seen):
            return seen
    raise RuntimeError(f"the profiler kept {[len(r) for r in seen]} device events of {names} "
                       f"over {reps} calls of {fn}, in each of three sessions")


def _us(ranges) -> float:
    return sum(r.elapsed_us() for r in ranges)


def device_ms(fn: Callable, reps: int, name: str = "") -> float:
    """Device ms a call of ``fn``: the device events whose name holds
    ``name`` (with "", every kernel and copy the calls ran), summed over
    ``reps`` calls and divided by ``reps``. A session that kept fewer such
    events than calls is taken again."""
    (ranges,) = _device_ranges(fn, reps, (name,),
                               lambda seen: len(seen[0]) >= reps and _us(seen[0]) > 0)
    return _us(ranges) / 1e3 / reps


def _spans(first, last):
    """A call's span: from a launch of the first kernel to the end of the
    first launch of the last kernel after it and before the first's next."""
    spans = []
    for i, r in enumerate(first):
        nxt = first[i + 1].start if i + 1 < len(first) else float("inf")
        after = [e for e in last if r.start <= e.start < nxt]
        if after:
            spans.append(after[0].end - r.start)
    return spans


def kernel_ms(fn: Callable, reps: int, names, span: bool = False):
    """Device ms a launch of each kernel whose name holds ``names[i]`` (a
    tuple, the mean over the launches kept), over ``reps`` calls of ``fn``;
    with ``span``, also the mean span of a call from the first kernel's
    start to the last kernel's end (where kernels overlap, as a
    programmatic dependent launch makes them, the sum of their times
    counts the overlap twice and the span does not). A session that kept
    no launch of some kernel (with ``span``, no whole call) is taken
    again. Late in a long process, sessions kept 2 to 4 of 5 launches, so
    the means are over the launches kept."""
    def enough(seen):
        return all(seen) and (not span or bool(_spans(seen[0], seen[-1])))

    seen = _device_ranges(fn, reps, tuple(names), enough)
    ms = tuple(_us(r) / 1e3 / len(r) for r in seen)
    if not span:
        return ms
    spans = _spans(seen[0], seen[-1])
    return ms, sum(spans) / 1e3 / len(spans)


def launch_floor_ms(reps: int = 200) -> float:
    """Device ms of a one-element ``fill_``: the least a launch takes, which
    no kernel beats."""
    x = torch.empty(1, device="cuda")
    return device_ms(lambda: x.fill_(1.0), reps)
