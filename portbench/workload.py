"""One run of one cell: the general generator of every traffic mix.

A traffic file (``traffic/<mix>.json``) is data: its ``kind`` names the
loop that runs it (``loops/<kind>.py``, found by that name), and its
``batch`` the windows a step or a request. The loop drives the program
through set-up and the measured window (or, with ``trace``, a traced slice
and its untraced twin), and compares what the timed path produced with the
plain reference once the window has closed.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from . import check, draws, trace as tracing
from .program import Program, launch_counts, switches


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads of a traced run."""

    cell: str
    kind: str
    dtype: str
    model: dict
    batch: int
    units: int  # steps or requests in the traced slice
    trace: tracing.Trace
    rate_samples_per_s: float  # of the same slice, untraced
    flops_per_sample: float


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def norms(tensors: dict) -> dict:
    vals = torch.stack([torch.linalg.vector_norm(t.detach().double()) for t in tensors.values()])
    return dict(zip(tensors, vals.tolist()))


class Cell:
    """A cell's configuration, traffic, loop, limits and reference."""

    def __init__(self, manifest, name: str):
        self.name = name
        self.entry = manifest.cell(name)
        self.config = manifest.config(self.entry["config"])
        self.traffic = manifest.traffic(self.entry["traffic"])
        self.limits = manifest.limits(name)["numbers"]
        self.ref = manifest.reference(self.config)
        self.kind = self.traffic["kind"]
        self.loop = manifest.loop(self.kind)
        self.model = self.config["model"]
        self.batch = self.traffic["batch"]
        self.ref_cfg = {**self.model, "snr_db": self.config["data"]["snr_db"]}
        self.spec = self.ref.parameter_spec(self.model)
        self.train = {**self.config["train"], "batch": self.batch}


def profiled(device, body):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(tracing.WINDOW):
            body()
            sync(device)
    return tracing.reduce(prof)


def run(manifest, name: str, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """One run of the cell ``name``: the result line's object (with the
    numbers compared last, under ``checks``)."""
    device = torch.device(device)
    cell = Cell(manifest, name)
    marks = [("process start", t_start), ("imports", time.perf_counter())]
    with switches(cell.config["tf32"]):
        h = draws.dataset(cell.config, seed, device)
        flops = cell.ref.flops_per_sample(cell.model, cell.kind == "train")
        marks.append(("dataset and FLOP count", time.perf_counter()))
        prog = Program(cell.config, draws.weights(cell.spec, seed, device), h, device)
        marks.append(("weights and model", time.perf_counter()))
        counts0 = launch_counts()
        out = cell.loop.run(cell, prog, seed, seconds, trace, t_start)
        marks.append(("first steps or warm requests", t_start + out["setup_s"]))
        counts = {k: v - counts0[k] for k, v in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        prog.free()
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = cell.loop.check(cell, out, h, seed, device)
    correct, checks = check.verdict(numbers, cell.limits)
    log(f"{name}: {out['attempted']} {cell.loop.UNITS}; kernel launches {counts}")
    log("set-up seconds by stage: " + "; ".join(
        f"{n} {t - marks[i][1]:.2f}" for i, (n, t) in enumerate(marks[1:]))
        + f"; the check after the window took {time.perf_counter() - t_check:.2f}")
    result = {"correct": correct, "attempted": out["attempted"], "failed": numbers["failed"],
              "metrics": {}, "device": _device(device, peak)}
    if trace:
        tr = out["trace"]
        ctx = Context(cell=name, kind=cell.kind, dtype=cell.model["dtype"], model=cell.model,
                      batch=cell.batch, units=out["units"], trace=tr,
                      rate_samples_per_s=out["rate"], flops_per_sample=flops)
        for metric in manifest.per_layer(name):
            value = manifest.reader(metric["name"])(ctx)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value, "unit": metric["unit"]}
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        values = {**out["values"], "setup_s": out["setup_s"]}
        for metric in manifest.end_to_end(name):
            result["metrics"][metric["name"]] = {"value": values[metric["name"]],
                                                 "unit": metric["unit"]}
    result["checks"] = checks
    return result


def _device(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def forbidden_modules(names=("jax", "jaxlib", "flax", "channelestimationtransformer_tpu")):
    """The forbidden top-level names that ``sys.modules`` holds, compared whole."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(names))
