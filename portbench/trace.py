"""Reduce a ``torch.profiler`` trace of a traced slice to what the per-layer
readers read: the device activities inside the slice's span, their union,
the idle gaps between them and what the host was doing in each.

A slice is run inside ``record_function(WINDOW)`` and ends in a
synchronise, so the span covers all of its device work. Nothing is written
to disk: the events are read from the profiler in memory.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

SPANS = "portbench."  # the harness's own host spans
WINDOW = SPANS + "window"
TRANSFERS = ("Memcpy", "Memset")  # device activities that are not kernels
TOP = 10


@dataclasses.dataclass
class Trace:
    """One traced slice: ``kernels`` and ``transfers`` are ``(name, start_s,
    end_s)`` on the device, ``host`` the CPU ops ``(name, start_s, end_s)``;
    times are seconds from the slice's start."""

    window_s: float
    kernels: list
    transfers: list
    host: list

    def busy_intervals(self) -> list:
        """The union of every device activity, as sorted disjoint intervals."""
        spans = sorted((s, e) for _, s, e in self.kernels + self.transfers)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_time(self, patterns) -> tuple[int, float]:
        """Launches and summed device seconds of the kernels whose name holds
        any of ``patterns``."""
        rows = [e - s for name, s, e in self.kernels if any(p in name for p in patterns)]
        return len(rows), sum(rows)

    def device_ops(self) -> list:
        """The device operations that took most time, summed by name."""
        total = collections.Counter()
        for name, s, e in self.kernels + self.transfers:
            total[_short(name)] += e - s
        return [[n, t] for n, t in total.most_common(TOP)]

    def idle_gaps(self) -> list:
        """Idle device time summed by what the host was doing: the innermost
        host op running at each gap's midpoint (``host idle`` where none)."""
        edges = [0.0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.window_s)
        total = collections.Counter()
        host = sorted(self.host, key=lambda r: r[1])
        started, at = [], 0  # heap of (-start, end, name): the latest start on top
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            while at < len(host) and host[at][1] <= mid:
                name, s, e = host[at]
                heapq.heappush(started, (-s, e, name))
                at += 1
            while started and started[0][1] < mid:  # ended before this gap: for good
                heapq.heappop(started)
            label = started[0][2] if started else "host idle"
            total[_short(label)] += g1 - g0
        return [[n, t] for n, t in total.most_common(TOP)]


def _short(name: str, limit: int = 120) -> str:
    name = name.removeprefix("void ")
    return name if len(name) <= limit else name[:limit]


def _times(ev) -> tuple[float, float]:
    start = ev.start_ns() / 1e9
    return start, start + ev.duration_ns() / 1e9


def _annotation(ev) -> bool:
    """Whether a device-side event is the shadow of a host span
    (``record_function``), which the profiler draws on the device's
    timeline too, and not device work."""
    flag = getattr(ev, "is_user_annotation", None)
    return (callable(flag) and flag()) or ev.name().startswith(SPANS)


def reduce(prof) -> Trace:
    """The slice's :class:`Trace` from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = [_times(ev) for ev in events
             if ev.name() == WINDOW and ev.device_type() != DeviceType.CUDA]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = spans[0]
    kernels, transfers, host = [], [], []
    for ev in events:
        s, e = _times(ev)
        if e < w0 or s > w1:
            continue
        name = ev.name()
        row = (name, max(s, w0) - w0, min(e, w1) - w0)
        if ev.device_type() != DeviceType.CUDA:
            if name != WINDOW:
                host.append(row)
        elif not _annotation(ev):
            (transfers if name.startswith(TRANSFERS) else kernels).append(row)
    return Trace(window_s=w1 - w0, kernels=kernels, transfers=transfers, host=host)
