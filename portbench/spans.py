"""Attribute a traced slice's device time to the program's own spans.

The program marks its layers with ``record_function`` ranges named
``cet.`` (``channelestimationtransformer_torch/core/runtime.py:span``):
``cet.step`` around a training step, holding its four phases ``cet.batch``,
``cet.model``, ``cet.backward`` and ``cet.optimizer``, and ``cet.conv``
around each circular convolution of the forward. They are host events of
the profiler that records the device, so they share its clock.

- A device activity is tied to the host call that launched it by order:
  the program runs on one stream, so the k-th kernel or copy to start on
  the device is the k-th launch or copy call on the host. Where the two
  counts differ the tie is unknown and nothing is read.
- A device activity belongs to the phase that is open, on any thread, at
  its launch call; to the step's remainder where a step is open but none of
  its phases; and outside steps where no step is open.
- An idle gap belongs to the phase the host is in at the gap's midpoint
  (the rule of ``Trace.idle_gaps``), by the same fallbacks.
- A kernel belongs to the convolutions if it was launched inside a
  ``cet.conv`` span (forward) or inside autograd's ``ConvolutionBackward``
  node (backward: the trace keeps no sequence numbers that would tie a
  backward node to the forward op that made it; every convolution of the
  program runs inside ``cet.conv``).

The phases of one step follow one another on the step's thread; spans of
one name never overlap.
"""

from __future__ import annotations

import bisect
import collections

from .trace import Trace

STEP = "cet.step"
PHASES = ("cet.batch", "cet.model", "cet.backward", "cet.optimizer")
CONV = "cet.conv"
CONV_BACKWARD = "ConvolutionBackward"
REMAINDER = "step remainder"
OUTSIDE = "outside steps"
# host calls that put a kernel or a copy on the device (runtime and low-level CUDA API)
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


class _Intervals:
    """Disjoint ``(start, end, label)`` intervals, found by time."""

    def __init__(self, rows):
        self.rows = sorted(rows)
        self.starts = [r[0] for r in self.rows]

    def at(self, t: float):
        """The label of the interval holding ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.rows[i][1]:
            return self.rows[i][2]
        return None


def _union(intervals) -> _Intervals:
    """The union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return _Intervals((s, e, True) for s, e in out)


def _busy(intervals) -> float:
    return sum(e - s for s, e, _ in _union(intervals).rows)


def _spans(tr: Trace, names) -> list:
    return [(s, e, name) for name, s, e in tr.host if name in names]


def steps(tr: Trace) -> int:
    """The training steps in the slice: its ``cet.step`` spans."""
    return sum(1 for name, _, _ in tr.host if name == STEP)


def launched(tr: Trace):
    """Each device activity ``(start_s, end_s)`` with the host time of its
    launch call, in device order; None where the counts differ."""
    acts = sorted((s, e) for _, s, e in tr.kernels + tr.transfers)
    calls = sorted(s for name, s, _ in tr.host if name.startswith(LAUNCHES))
    if len(calls) != len(acts):
        return None
    return [(s, e, t) for (s, e), t in zip(acts, calls)]


class _Phases:
    """The phase of a host time: a phase span, else the step's remainder,
    else outside steps."""

    def __init__(self, tr: Trace):
        self.phases = _Intervals(_spans(tr, PHASES))
        self.steps = _Intervals(_spans(tr, (STEP,)))

    def at(self, t: float) -> str:
        phase = self.phases.at(t)
        if phase is not None:
            return phase
        return REMAINDER if self.steps.at(t) is not None else OUTSIDE


def partition(tr: Trace):
    """Seconds of the slice by phase, ``{phase: (busy_s, idle_s)}``: each
    phase's device activities (their union) and the idle gaps put down to
    it, which together make up the slice where activities of two phases do
    not overlap on the device. None where launches cannot be tied."""
    acts = launched(tr)
    if acts is None:
        return None
    phase_of = _Phases(tr)
    rows = collections.defaultdict(list)
    for s, e, t in acts:
        rows[phase_of.at(t)].append((s, e))
    idle = collections.Counter()
    edges = [0.0]
    for s, e in tr.busy_intervals():
        edges += [s, e]
    edges.append(tr.window_s)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            idle[phase_of.at(0.5 * (g0 + g1))] += g1 - g0
    return {p: (_busy(rows.get(p, ())), idle.get(p, 0.0)) for p in sorted(set(rows) | set(idle))}


def phase_ms(tr: Trace, phase: str):
    """Milliseconds a step of ``phase``, busy and idle; None where the
    slice holds no step span (a program without spans) or launches cannot
    be tied."""
    n = steps(tr)
    parts = partition(tr) if n else None
    if parts is None:
        return None
    return 1e3 * sum(parts.get(phase, (0.0, 0.0))) / n


def conv_activities(tr: Trace):
    """The device ``(start_s, end_s)`` of the convolutions' kernels,
    forward and backward; None where launches cannot be tied."""
    acts = launched(tr)
    if acts is None:
        return None
    inside = _union((s, e) for s, e, _ in _spans(tr, (CONV,)))
    nodes = _union((s, e) for name, s, e in tr.host if CONV_BACKWARD in name)
    return [(s, e) for s, e, t in acts if inside.at(t) or nodes.at(t)]


def conv_ms(tr: Trace):
    """Busy milliseconds a step of the convolutions' kernels (their
    union); None where the slice holds no step or no ``cet.conv`` span,
    or launches cannot be tied."""
    n = steps(tr)
    if not n or not any(name == CONV for name, _, _ in tr.host):
        return None
    acts = conv_activities(tr)
    return None if acts is None else 1e3 * _busy(acts) / n
