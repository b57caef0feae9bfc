"""Serving traffic: one client in a closed loop. A request is the mix's
``batch`` windows, whose draws (``DISTINCT_REQUESTS`` sets of sample
indices, window starts and noise) are made at set-up and cycled; the next
request leaves when the last is synchronised, and its latency runs from
its issue to that synchronise.

Set-up serves ``WARM_REQUESTS`` requests. A reservoir drawn from the seed
keeps ``CHECK_REQUESTS`` of the served predictions for the comparison. With
``trace`` the run measures no window: it times ``TRACE_REQUESTS`` requests
untraced for the rate, then as many under the profiler.
"""

from __future__ import annotations

import random
import time

import torch

from .. import check as compare, draws, stats, trace as tracing
from ..workload import profiled, sync

DISTINCT_REQUESTS = 16
WARM_REQUESTS = 3
CHECK_REQUESTS = 12
TRACE_REQUESTS = 40
UNITS = "requests"


def _keep(kept: list, item, seen: int, k: int, rng: random.Random):
    """Reservoir sampling: after ``seen + 1`` items, ``kept`` holds a uniform
    sample of ``k`` of them."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(seen + 1)
        if j < k:
            kept[j] = item


def run(cell, prog, seed: int, seconds: float, trace: bool, t_start: float) -> dict:
    device, b = prog.device, cell.batch
    requests = draws.serve_draws(cell.config, b, DISTINCT_REQUESTS, seed, device)
    for i in range(WARM_REQUESTS):
        prog.serve(b, *requests[i % len(requests)])
    sync(device)
    out = {"setup_s": time.perf_counter() - t_start, "requests": requests}
    rng = random.Random(draws.key(seed, draws.SAMPLE))
    kept, served = [], 0

    def one():
        nonlocal served
        start = time.perf_counter()
        pred = prog.serve(b, *requests[served % len(requests)])
        sync(device)
        done = time.perf_counter()
        _keep(kept, (served, pred), served, CHECK_REQUESTS, rng)
        served += 1
        return done - start

    out["kept"] = kept
    if trace:
        t0 = time.perf_counter()
        for _ in range(TRACE_REQUESTS):
            one()
        out["rate"] = TRACE_REQUESTS * b / (time.perf_counter() - t0)

        def body():
            from torch.profiler import record_function

            for _ in range(TRACE_REQUESTS):
                with record_function(tracing.SPANS + "request"):
                    one()
        out["trace"] = profiled(device, body)
        out["units"] = TRACE_REQUESTS
        out["attempted"] = served
        return out
    latencies = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        latencies.append(one())
    window = time.perf_counter() - t0
    out["attempted"] = len(latencies)
    out["values"] = {"serve_samples_per_s": stats.rate(len(latencies) * b, window),
                     "serve_ms_p95": 1e3 * stats.percentile(latencies, 95)}
    return out


def check(cell, out: dict, h: torch.Tensor, seed: int, device) -> dict:
    """The numbers of the kept requests against the reference's predictions
    of the same windows, and how many kept requests fail on their own."""
    w0 = draws.weights(cell.spec, seed, device)
    requests = out["requests"]
    got, want = [], []
    for r, pred in out["kept"]:
        got.append(pred)
        want.append(cell.ref.predict(w0, cell.ref_cfg, h, *requests[r % len(requests)],
                                     cell.ref.Precision("float32")))
    numbers = compare.serve_numbers(got, want)
    numbers["failed"] = sum(not compare.verdict(compare.serve_numbers([g], [w]),
                                                cell.limits)[0]
                            for g, w in zip(got, want))
    return numbers


def control(cell, seed: int, device, low) -> dict:
    """The numbers of the reference in precision ``low`` put in the
    program's place, against the float32 reference, over as many requests
    as a run compares."""
    ref = cell.ref
    h = draws.dataset(cell.config, seed, device)
    w0 = draws.weights(cell.spec, seed, device)
    requests = draws.serve_draws(cell.config, cell.batch, DISTINCT_REQUESTS, seed, device)
    got, want = [], []
    for r in range(CHECK_REQUESTS):
        got.append(ref.predict(w0, cell.ref_cfg, h, *requests[r], low))
        want.append(ref.predict(w0, cell.ref_cfg, h, *requests[r], ref.Precision("float32")))
    return compare.serve_numbers(got, want)
