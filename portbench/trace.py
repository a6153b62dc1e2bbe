"""A ``torch.profiler`` session over the traced window, reduced to what the
per-layer metrics and the breakdown read.

- busy: the union of the device's activity (kernels, copies, sets) in the
  window, so overlapping launches count once;
- device time by name, summed over launches;
- idle gaps: each stretch of the window in which no device activity runs,
  charged to the host operations running over it (the outermost ``aten::``
  operation, else the harness's own span), in proportion to the overlap.
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """The reduced session: device events (name, start µs, end µs), host
    events (name, start, end, outermost aten op or span), and the window's
    host-clock length."""

    def __init__(self, device_events, host_events, window_s: float):
        self.device_events = device_events
        self.host_events = host_events
        self.window_s = window_s
        self.busy_s = sum(b - a for a, b in _union([(s, e) for _, s, e in device_events])) / 1e6

    def device_s(self, names: Iterable[str]) -> float:
        """Device seconds of the events whose name holds any of ``names``."""
        names = tuple(names)
        return sum(e - s for n, s, e in self.device_events if any(x in n for x in names)) / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        acc: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device_events:
            acc[n] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        busy = _union([(s, e) for _, s, e in self.device_events])
        if not self.host_events:
            return []
        lo = min(s for _, s, _ in self.host_events)
        hi = max(e for _, _, e in self.host_events)
        gaps, at = [], lo
        for a, b in busy:
            if a > at:
                gaps.append((at, min(a, hi)))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        acc: Dict[str, float] = defaultdict(float)
        # host events are close to disjoint (one thread's outermost ops), so
        # one sweep over both sorted lists finds each gap's overlaps
        hosts = sorted(self.host_events, key=lambda h: h[1])
        first = 0
        for ga, gb in gaps:
            while first < len(hosts) and hosts[first][2] <= ga:
                first += 1
            for n, s, e in hosts[first:]:
                if s >= gb:
                    break
                overlap = min(e, gb) - max(s, ga)
                if overlap > 0:
                    acc[n] += overlap / 1e6
        return [[n, v] for n, v in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def _host_events(events) -> List[Tuple[str, float, float]]:
    """The outermost ``aten::`` operations, and the harness's spans where no
    aten operation runs inside them, as (name, start µs, end µs)."""
    out = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        parent, nested = e.cpu_parent, False
        while parent is not None:
            if parent.name.startswith("aten::"):
                nested = True
                break
            parent = parent.cpu_parent
        if e.name.startswith("aten::") and not nested:
            out.append((e.name, e.time_range.start, e.time_range.end))
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("portbench.")]
    return out + _uncovered(spans, out)


def _uncovered(spans, ops):
    """The parts of the harness's spans that no aten operation covers."""
    covered = _union([(s, e) for _, s, e in ops])
    out = []
    for name, s, e in spans:
        at = s
        for a, b in covered:
            if b <= at or a >= e:
                continue
            if a > at:
                out.append((name, at, a))
            at = max(at, b)
        if e > at:
            out.append((name, at, e))
    return out


class Session:
    """A profiler session opened by :meth:`start` and closed by :meth:`stop`
    (for windows that end in a callback); :func:`session` is its context
    manager."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=activities)
        self.prof.start()
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        if self.cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        events = self.prof.events()
        # the harness's own spans are mirrored onto the device's timeline as
        # user annotations: they are no device activity
        device = [(e.name, e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("portbench.")]
        return Trace(device, _host_events(events), window_s)


@contextlib.contextmanager
def session(holder: list):
    """Profile the block; append its :class:`Trace` to ``holder``."""
    s = Session()
    s.start()
    yield
    holder.append(s.stop())
