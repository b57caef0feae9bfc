"""The multi-chip dry run (the counterpart of ``__graft_entry__.py``).

:func:`entry` is the flagship forward and its example arguments at batch 8
(``__graft_entry__.py:10-23``). :func:`dryrun_multichip` is one rank's part
of the dry run over ``n_devices`` ranks (``:26-130``), its three legs at
the JAX file's small configs and sizes:

1. :func:`train_leg`: one training step over a ``data x model`` mesh,
   ``model_axis`` 2 at 4 ranks or more (even), else 1; the parameters
   placed by ``param_shardings`` (``parallel/tensor.py``: each rank keeps
   its rows) and the global batch of ``2n`` windows split over ``data``.
   JAX's ``train_step`` draws its windows by global index from the whole
   ``(2n, 48, 16)`` dataset, so every rank holds it (it is tiny), draws the
   global batch alike and keeps its ``data`` part;
2. :func:`ring_leg`: the loss ``sum(out ** 2)`` of the ring Informer on a
   ``seq`` axis of every rank, and its gradients;
3. :func:`pipeline_leg`: ``generate_beamformed_dataset_sharded`` on the
   two-axis mesh and ``beam_sweep_project_sharded`` over a ``model`` axis
   of every rank.

:func:`main` starts the ranks on this host (``parallel/launch.py:run_local``;
NCCL on the cards, gloo on the CPU and for more ranks than cards, which
then share them with their collectives through the host) and prints one
JSON line::

    python -m channelestimationtransformer_torch.cli.multichip --n-devices 4
    python -m channelestimationtransformer_torch.cli.multichip --n-devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..channel.beamforming import beam_sweep_project_sharded, dft_codebook_ri
from ..channel.cdl import CDLModel, generate_cdl_channel
from ..channel.dataset import generate_beamformed_dataset_sharded
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset, make_batch
from ..models.informer import build_informer
from ..parallel import launch
from ..parallel.mesh import make_mesh
from ..parallel.tensor import full_state_dicts, gather_rows, sharded_names, tensor_parallel
from ..train.trainer import _update, create_train_state

# __graft_entry__.py:56-59 and :92-95.
TRAIN_CFG = dict(seq_len=32, label_len=8, pred_len=5, d_model=32, n_heads=4, e_layers=(2, 1),
                 d_layers=2, d_ff=32)
DATASET_SLOTS, SNR_DB = 48, 20.0
ROOT = Path(__file__).resolve().parents[2]  # the ranks import the package from here


def ring_cfg(n_devices: int) -> dict:
    return dict(seq_len=4 * n_devices, label_len=4, pred_len=2, d_model=16, n_heads=2,
                e_layers=(1,), d_layers=1, d_ff=16, attn="ring", distil=False)


def model_axis(n_devices: int) -> int:
    """``__graft_entry__.py:49``: 2 at an even number of 4 ranks or more."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def entry(device=None):
    """``(fn, example_args)``: the flagship InformerStack (``InformerConfig()``,
    weights from seed 0, eval mode) on ``device`` (default: the card) and
    zero inputs at batch 8; ``fn(*example_args)`` is its forward."""
    cfg = InformerConfig()
    device = resolve_device(device)
    model = build_informer(cfg, device=device, seed=0)
    x_enc = torch.zeros(8, cfg.seq_len, cfg.enc_in, device=device)
    x_dec = torch.zeros(8, cfg.dec_len, cfg.dec_in, device=device)

    def fn(model, x_enc, x_dec):
        with torch.no_grad():
            return model(x_enc, x_dec)

    return fn, (model, x_enc, x_dec)


def _from_rank0(model) -> None:
    """Global rank 0's parameters and buffers on every rank."""
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, 0)


def train_leg(n_devices: int, device, *, state_dict=None, draws=None, dropout=None) -> dict:
    """One training step over the ``data x model`` mesh (module docstring).
    ``state_dict`` replaces the seeded weights, ``draws`` (``idx``,
    ``starts``, ``noise`` of the global batch) the window draws, ``dropout``
    the config's. Returns the loss, the gathered state after the step and
    gradients of the step, and the mesh."""
    m = model_axis(n_devices)
    mesh = make_mesh(data=n_devices // m, model=m)
    cfg = InformerConfig(**TRAIN_CFG)
    if dropout is not None:
        cfg = dataclasses.replace(cfg, dropout=dropout)
    tc = TrainConfig(batch_size=2 * n_devices, num_epochs=1, steps_per_epoch=4)
    model = build_informer(cfg, device=device, seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    _from_rank0(model)
    tensor_parallel(model, mesh)
    state = create_train_state(model, tc)
    h = np.random.default_rng(0).normal(size=(2 * n_devices, DATASET_SLOTS, 16))
    ds = WindowDataset(h=torch.as_tensor(h, dtype=torch.float32, device=device),
                       seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=SNR_DB, device=device)
    batch = make_batch(ds, tc.batch_size, cfg.label_len,
                       **(draws if draws is not None else
                          {"generator": stream_generator(device, 1)}))
    group = mesh.get_group("data")
    d, per = dist.get_rank(group), tc.batch_size // dist.get_world_size(group)
    part = [t[d * per:(d + 1) * per] for t in batch]
    metrics = _update(state, *part, stream_generator(device, 1, d), group)
    sharded, model_group = sharded_names(model), mesh.get_group("model")
    grads = {n: gather_rows(p.grad, model_group) if n in sharded else p.grad
             for n, p in model.named_parameters()}
    return {"loss": float(metrics["loss"]), "state": full_state_dicts(model)[0], "grads": grads,
            "mesh": mesh}


def ring_leg(n_devices: int, device, *, state_dict=None) -> dict:
    """``sum(out ** 2)`` of the ring Informer (``__graft_entry__.py:89-103``;
    weights from seed 2 or ``state_dict``, eval mode, zero inputs at batch
    4) over a ``seq`` axis of every rank, and the gradient of every
    parameter."""
    mesh = make_mesh(data=1, model=1, seq=n_devices)
    cfg = InformerConfig(**ring_cfg(n_devices))
    model = build_informer(cfg, device=device, seed=2, mesh=mesh)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    _from_rank0(model)
    x_enc = torch.zeros(4, cfg.seq_len, cfg.enc_in, device=device)
    x_dec = torch.zeros(4, cfg.dec_len, cfg.dec_in, device=device)
    loss = (model(x_enc, x_dec) ** 2).sum()
    loss.backward()
    return {"loss": float(loss), "grads": {n: p.grad for n, p in model.named_parameters()}}


def pipeline_leg(n_devices: int, device, mesh, *, h=None) -> dict:
    """``__graft_entry__.py:105-129``: this rank's shard of the sample-sharded
    dataset on ``mesh`` (key 3), and the antenna-sharded beam sweep of a
    2-sample, 6-slot CDL channel (key 4, or ``h``) over a ``model`` axis of
    every rank."""
    cdl = CDLModel()
    shard = generate_beamformed_dataset_sharded(
        (3,), mesh, model=cdl, num_samples=n_devices * 2 // model_axis(n_devices), num_slots=8,
        device=device)
    if h is None:
        h = generate_cdl_channel(cdl, 2, 6, generator=stream_generator(device, 4), device=device)
    h_eff, selected = beam_sweep_project_sharded(
        h.to(device), dft_codebook_ri(cdl.num_bs_ant, device=device), 4,
        make_mesh(data=1, model=n_devices))
    return {"shard": shard, "h_eff": h_eff, "selected": selected}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One rank's part of the dry run over the ``n_devices`` ranks of the
    process group it joined: the three legs with the port's own seeded
    weights and draws. Returns each leg's numbers; raises if one is not
    finite."""
    device = resolve_device(device)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {dist.get_world_size()} ranks joined")
    train = train_leg(n_devices, device)
    ring = ring_leg(n_devices, device)
    pipe = pipeline_leg(n_devices, device, train["mesh"])
    out = {
        "model_axis": model_axis(n_devices),
        "train_loss": train["loss"],
        "ring_loss": ring["loss"],
        "ring_grads_finite": all(bool(torch.isfinite(g).all()) for g in ring["grads"].values()),
        "dataset_shard": list(pipe["shard"].shape),
        "dataset_finite": bool(torch.isfinite(pipe["shard"]).all()),
        "h_eff": list(pipe["h_eff"].shape),
        "h_eff_finite": bool(torch.isfinite(pipe["h_eff"]).all()),
    }
    if not (math.isfinite(out["train_loss"]) and math.isfinite(out["ring_loss"])
            and out["ring_grads_finite"] and out["dataset_finite"] and out["h_eff_finite"]):
        raise RuntimeError(f"a leg of the dry run is not finite: {out}")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="The multi-chip dry run: a data x model training "
                                            "step, the ring and the sharded input pipeline.")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks to start (default: the cards here, or 1 on the CPU)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, and raise without one; "
                        "'cpu' runs gloo ranks on the CPU)")
    p.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole group")
    p.add_argument("--rank-out", default=None, help=argparse.SUPPRESS)  # set for each rank
    return p


def _backend(device: torch.device, n: int) -> str:
    """NCCL where every rank has a card of its own (NCCL refuses two ranks
    on one card), else gloo."""
    return "nccl" if device.type == "cuda" and n <= torch.cuda.device_count() else "gloo"


def _rank(args) -> None:
    """One rank of :func:`main`'s group: rank 0 writes its result to ``--rank-out``."""
    device = resolve_device(args.device)
    device = launch.join_local(device, backend=_backend(device, args.n_devices))
    torch.manual_seed(0)
    out = dryrun_multichip(args.n_devices, device)
    if dist.get_rank() == 0:
        Path(args.rank_out).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> dict:
    """Run the dry run on ``--n-devices`` local ranks; prints and returns one
    JSON object with ``n_devices``, ``ok`` and each leg's numbers."""
    args = build_parser().parse_args(argv)
    if args.rank_out is not None:
        return _rank(args)
    device = resolve_device(args.device)
    n = args.n_devices or (torch.cuda.device_count() if device.type == "cuda" else 1)
    backend = _backend(device, n)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rank0.json"
        cmd = [sys.executable, "-m", __spec__.name, "--n-devices", str(n), "--device",
               str(device), "--rank-out", str(path)]
        threads = max(1, (os.cpu_count() or 1) // n) if device.type == "cpu" else None
        path_env = os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))
        launch.run_local(cmd, n, timeout=args.timeout, threads=threads,
                         env={"PYTHONPATH": path_env})
        result = {"n_devices": n, "ok": True, "backend": backend,
                  **json.loads(path.read_text()), "seconds": time.perf_counter() - t0}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
