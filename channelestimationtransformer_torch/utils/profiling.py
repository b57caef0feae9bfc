"""Profiling helpers: traces, call timing, throughput, device memory (JAX
counterpart ``utils/profiling.py``, rewritten for the card).

Reference equivalents: the CUDA-event latency harness
(``TimingAnalysis/TrainInformer.py:97-147``) and per-step ``ms/batch``
logging. JAX traces with ``jax.profiler`` and syncs by fetching a scalar of
the output; here :func:`trace` is a ``torch.profiler`` Chrome trace,
:func:`time_fn` ends each call in ``torch.cuda.synchronize()``, and
:func:`time_fn_amortized` replays a CUDA graph of ``inner`` calls in place
of JAX's chained ``lax.scan``. On the CPU the same functions time plain
loops, so they run in the tests.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the enclosed block, CPU activity and, where a
    card is present, CUDA activity. Yields the profiler; on exit its Chrome
    trace is written into ``logdir`` and its path set as the profiler's
    ``trace_path`` (open it in ``chrome://tracing`` or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 20, reps: int = 100):
    """Mean/std wall ms of ``fn(*args)``, each call timed by the host clock
    up to a ``torch.cuda.synchronize()`` (the reference's CUDA-event
    harness semantics; host launch cost included)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append((time.perf_counter() - t0) * 1000)
    return float(np.mean(times)), float(np.std(times))


def time_fn_amortized(fn: Callable, *args, inner: int = 20, warmup: int = 3, reps: int = 10):
    """Mean/std device ms of ONE ``fn(*args)`` call: ``inner`` calls captured
    in one CUDA graph, the graph replayed ``reps`` times between CUDA
    events, each time divided by ``inner``.

    :func:`time_fn` pays the host's launch cost, which eager calls at the
    flagship's sizes are bound by; replay removes it, as JAX's chain of
    ``inner`` forwards in one compiled program removes the dispatch round
    trip. JAX needs each call to depend on the last so that XLA cannot merge
    them; a graph replays every captured launch, so no dependence is added.
    ``warmup`` eager calls run on a side stream before the capture (the
    kernels build and the allocator settles there). ``args`` are held by the
    caller for the graph's life, as every launch through ctypes needs. On the
    CPU: ``warmup`` calls, then ``reps`` timings of ``inner`` calls by the
    host clock."""
    if not torch.cuda.is_available():
        for _ in range(warmup):
            fn(*args)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            times.append((time.perf_counter() - t0) * 1000 / inner)
        return float(np.mean(times)), float(np.std(times))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn(*args)
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.mean(times)), float(np.std(times))


def throughput(fn: Callable, *args, batch: int, warmup: int = 5, reps: int = 50):
    """samples/s per card for a batched step fn: ``batch`` over
    :func:`time_fn`'s mean, divided by ``torch.cuda.device_count()`` (1 on
    the CPU), as JAX divides by ``jax.device_count()`` whether or not
    ``fn`` runs on every device."""
    mean_ms, _ = time_fn(fn, *args, warmup=warmup, reps=reps)
    per_chip = batch / (mean_ms / 1000)
    return per_chip / max(torch.cuda.device_count(), 1)


def device_memory_stats() -> Optional[dict]:
    """Live and peak bytes allocated by the caching allocator on the
    current card and the card's total memory, under JAX's keys; None on
    the CPU, as JAX where the backend has no statistics."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
    }
