"""Multi-process launch helpers (JAX counterpart ``parallel/launch.py``).

:func:`initialize_distributed` joins this process to a ``torch.distributed``
process group before any mesh is built, so the same ``Trainer`` and
``train_chunk_dp`` code runs on one process, on one host's cards, or across
hosts. It reads its sources in JAX's order: the arguments, then SLURM's
``SLURM_NTASKS`` / ``SLURM_PROCID``, then the variables ``torchrun`` sets
(``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``), where JAX
reads ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` /
``JAX_COORDINATOR_ADDRESS``. The backend is NCCL on the card and gloo when
the caller asks for the CPU.

:func:`run_local` starts N ranks of one command on this host under one
deadline: JAX's virtual CPU devices (``ensure_virtual_devices``) have no
torch counterpart, so N local ranks are N processes.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..core.runtime import resolve_device


def _env_int(*names: str, default: int) -> int:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return default


# A collective that waits this long for a peer raises instead of hanging.
COLLECTIVE_TIMEOUT_S = 300.0


def init_group(address: str, world_size: int, rank: int, *, device=None,
               backend: str | None = None) -> torch.device:
    """``dist.init_process_group`` at ``address`` (``host:port``) as ``rank``
    of ``world_size``: NCCL on the card (this process's card is
    ``LOCAL_RANK``, else ``SLURM_LOCALID``, else ``rank`` modulo the cards
    here), gloo on the CPU. ``backend="gloo"`` on the card runs ranks that
    share one card (NCCL refuses two ranks on one device), their
    collectives through the host; gloo's point-to-point sends of CUDA
    tensors fail on some builds (``chip_smoke.py`` probes each op). Returns
    the device this rank runs on."""
    device = resolve_device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID", default=rank)
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return device


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> bool:
    """Join the process group given by the arguments or the SLURM / torchrun
    variables. Returns True if multi-process mode was initialised, and does
    nothing for a single process (the common case on one card)."""
    if num_processes is None:
        num_processes = _env_int("SLURM_NTASKS", "WORLD_SIZE", default=1)
    if num_processes <= 1:
        return False
    if process_id is None:
        process_id = _env_int("SLURM_PROCID", "RANK", default=0)
    if coordinator_address is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (host and port):
            raise ValueError(f"{num_processes} processes but no coordinator address: pass "
                             "one, or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{host}:{port}"
    init_group(coordinator_address, num_processes, process_id, device=device)
    return True


def join_local(device=None, backend: str | None = None) -> torch.device:
    """Join the group that :func:`run_local` started this process in, a
    world of one included (which :func:`initialize_distributed` leaves
    alone), from the torchrun variables; returns this rank's device."""
    return init_group(f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                      int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]), device=device,
                      backend=backend)


def per_host_batch(global_batch: int) -> int:
    """Split the global batch across the processes (data-parallel input pipeline)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local(argv: Sequence[str], nprocs: int, *, timeout: float, threads: int | None = None,
              env: dict | None = None) -> list[str]:
    """Run ``argv`` as ranks 0..nprocs-1 of one group on this host (the
    torchrun variables set, ``MASTER_ADDR`` localhost) and return each
    rank's output. A rank that fails leaves the others blocked in a
    collective, so the first failure, or ``timeout`` seconds, kills every
    rank's process group and raises ``RuntimeError`` with their outputs.
    ``threads`` pins ``OMP_NUM_THREADS``."""
    port = _free_port()
    base = dict(os.environ, **(env or {}), WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port))
    for name in ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"):
        base.pop(name, None)
    if threads is not None:
        base["OMP_NUM_THREADS"] = str(threads)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(nprocs)]
        procs = []
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        list(argv), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)), stdout=f,
                        stderr=subprocess.STDOUT, start_new_session=True))
            deadline = time.monotonic() + timeout
            failure = None
            while failure is None:
                codes = [p.poll() for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failure = f"rank {bad[0][0]} exited with {bad[0][1]}"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    failure = f"timed out after {timeout:.0f} s"
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        outputs = [log.read_text(errors="replace") for log in logs]
    if failure is not None:
        raise RuntimeError(f"{nprocs} local ranks of {' '.join(argv)}: {failure}\n" + "\n".join(
            f"--- rank {r} ---\n{out}" for r, out in enumerate(outputs)))
    return outputs
