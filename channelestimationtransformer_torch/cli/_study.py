"""What the quantization study's drivers share (``ptq_sweep``,
``qat_incremental``, ``prune``): the flagship model restored from a
``cli.train_informer`` checkpoint, the window datasets keyed as the JAX
drivers key theirs, and the n-batch validation; ``--device``, which every
port driver adds."""

from __future__ import annotations

import numpy as np
import torch

from ..channel.cdl import cdl_from_args
from ..channel.dataset import make_window_dataset
from ..core.config import InformerConfig, TrainConfig
from ..core.runtime import stream_generator
from ..models.informer import build_informer
from ..train.checkpoint import load_checkpoint
from ..train.trainer import create_train_state, eval_step


def add_device_arg(p) -> None:
    """``--device``, which every port driver adds to the JAX package's flags."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card, and raise without one; "
                        "'cpu' runs the plain CPU path)")


def add_port_args(p) -> None:
    """The two flags the quantization study's drivers add to the JAX package's."""
    p.add_argument("--use-pallas", action="store_true",
                   help="the bd attention kernels in training and eval, instead of the plain "
                        "torch path (quantization takes its kernels on the card either way)")
    add_device_arg(p)


def flagship_state(cfg: InformerConfig, tc: TrainConfig, device, checkpoint=None):
    """The model of ``cfg`` (seed ``tc.seed``) and its train state, restored
    from ``checkpoint`` when one is given, with a new Adam at schedule step
    0 (the JAX drivers' ``state.replace(step=0, opt_state=tx.init(params))``).
    Returns ``(state, epoch)``."""
    state = create_train_state(build_informer(cfg, device=device, seed=tc.seed), tc)
    epoch = None
    if checkpoint:
        state, epoch, _ = load_checkpoint(checkpoint, state)
        state = create_train_state(state.model, tc)
    return state, epoch


def datasets(args, cfg: InformerConfig, device, *specs):
    """One window dataset per ``(key, num_samples)`` of ``specs``, 100 slots
    of the channel the flags ask for."""
    return [make_window_dataset(key, model=cdl_from_args(args), num_samples=n, num_slots=100,
                                seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=args.snr,
                                device=device)
            for key, n in specs]


def validate(model, ds, *, batch_size: int, label_len: int, num_batches: int, stream: tuple):
    """Mean per-horizon split and mean NMSE of ``num_batches`` eval batches,
    batch ``i`` drawn from the keyed stream ``(*stream, i)`` (JAX:
    ``fold_in(key, i)``); one fetch from the device."""
    device = ds.h.device
    ms = [eval_step(model, ds, batch_size=batch_size, label_len=label_len,
                    generator=stream_generator(device, *stream, i))
          for i in range(num_batches)]
    stats = torch.stack([torch.cat([m["split"], m["nmse"].reshape(1)]) for m in ms])
    stats = stats.double().cpu().numpy()
    return (stats[:, :-1].sum(axis=0) / num_batches).tolist(), float(np.sum(stats[:, -1])
                                                                     / num_batches)
