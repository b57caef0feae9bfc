"""Training traffic: a closed loop of the program's ``train_chunk``,
``STEPS_PER_CHUNK`` steps a call at the mix's ``batch``, each chunk's
windows, noise and dropout drawn from its own generator keyed by the seed
and the chunk's index.

Set-up drives the training state through its first ``CHECK_STEPS`` steps
(one a chunk, through the same call) and ``WARM_CHUNKS`` chunks; the window
then takes the same state on. With ``trace`` the run measures no window: it
times ``TRACE_CHUNKS`` chunks untraced for the rate, then as many under the
profiler.
"""

from __future__ import annotations

import time

import torch

from .. import check as compare, draws, stats
from ..workload import norms, profiled, sync

STEPS_PER_CHUNK = 4
CHECK_STEPS = 3
WARM_CHUNKS = 2
TRACE_CHUNKS = 3
UNITS = "steps"


def run(cell, prog, seed: int, seconds: float, trace: bool, t_start: float) -> dict:
    device, b = prog.device, cell.batch
    prog.train_state(cell.train)
    losses = []
    for c in range(CHECK_STEPS):
        losses.append(prog.train_chunk(1, b, draws.generator(device, seed, draws.TRAIN, c)))
        if c == 0:
            grad_norms = norms(prog.first_gradients(cell.train["betas"][0]))
    w0 = draws.weights(cell.spec, seed, device)
    change_norms = norms({n: p.detach() - w0[n] for n, p in prog.parameters().items()})
    del w0
    readings = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                "change_norms": change_norms}
    chunk = CHECK_STEPS

    def run_chunks(n):
        nonlocal chunk
        for _ in range(n):
            prog.train_chunk(STEPS_PER_CHUNK, b,
                             draws.generator(device, seed, draws.TRAIN, chunk))
            chunk += 1

    run_chunks(WARM_CHUNKS)
    sync(device)
    out = {"setup_s": time.perf_counter() - t_start, "readings": readings}
    if trace:
        t0 = time.perf_counter()
        run_chunks(TRACE_CHUNKS)
        sync(device)
        out["rate"] = TRACE_CHUNKS * STEPS_PER_CHUNK * b / (time.perf_counter() - t0)
        out["trace"] = profiled(device, lambda: run_chunks(TRACE_CHUNKS))
        out["units"] = out["attempted"] = TRACE_CHUNKS * STEPS_PER_CHUNK
        return out
    t0 = time.perf_counter()
    n_chunks = 0
    while True:
        run_chunks(1)
        n_chunks += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window = time.perf_counter() - t0
    out["attempted"] = n_chunks * STEPS_PER_CHUNK
    out["values"] = {"train_samples_per_s": stats.rate(out["attempted"] * b, window)}
    return out


def check(cell, out: dict, h: torch.Tensor, seed: int, device) -> dict:
    """The numbers of the ``CHECK_STEPS`` steps against the reference's."""
    w0 = draws.weights(cell.spec, seed, device)
    gens = [draws.generator(device, seed, draws.TRAIN, c) for c in range(CHECK_STEPS)]
    want = cell.ref.train_steps(w0, cell.ref_cfg, cell.train, h, gens,
                                cell.ref.Precision("float32"))
    numbers = compare.train_numbers(out["readings"], want)
    # the checked steps all come out wrong together, or none
    numbers["failed"] = 0 if compare.verdict(numbers, cell.limits)[0] else CHECK_STEPS
    return numbers


def control(cell, seed: int, device, low) -> dict:
    """The numbers of the reference in precision ``low`` put in the
    program's place, against the float32 reference."""
    ref = cell.ref
    h = draws.dataset(cell.config, seed, device)
    w0 = draws.weights(cell.spec, seed, device)

    def steps(prec):
        gens = [draws.generator(device, seed, draws.TRAIN, c) for c in range(CHECK_STEPS)]
        return ref.train_steps(w0, cell.ref_cfg, cell.train, h, gens, prec)
    return compare.train_numbers(steps(low), steps(ref.Precision("float32")))
