"""Profiling and warm-up helpers (counterpart of
``recognizer3d_tpu/utils/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` (CPU and, where
  there is a GPU, CUDA activity) that writes a TensorBoard-loadable trace
  into a directory;
- :func:`warmup`: run a function once and wait for its result (the first
  call pays the kernel build and load);
- :func:`timeit` / :func:`timeit_amortized`: wall-clock timing that waits
  for the device. PyTorch returns before the GPU finishes, so every timed
  call ends in a synchronisation of the devices its outputs lie on.
"""

import contextlib
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


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
