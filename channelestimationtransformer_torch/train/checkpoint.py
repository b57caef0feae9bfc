"""Checkpoint save/restore with step-exact resume (JAX counterpart
``train/checkpoint.py``; reference ``FullPrecision/QuantizationAwareTraining.py:301-313``
and latest-checkpoint globbing, ``config.py:36-50``).

A checkpoint holds the model's ``state_dict`` (parameters and BatchNorm
statistics), the optimizer's, the update count and the epoch, in torch's own
format (``torch.save``). Writes are atomic (tmp + rename), so an interrupted
job can always resume from the newest file. The JAX package's flax-msgpack
checkpoints are not read here: a JAX checkpoint reaches the port through
``utils/convert.py:from_flax`` on arrays that a caller loaded with flax.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch


def checkpoint_path(folder: str, basename: str, epoch) -> str:
    return str(Path(folder) / f"{basename}{epoch}.pt")


def save_checkpoint(state, folder: str, basename: str, epoch, *,
                    extra: Optional[dict] = None, state_dicts: Optional[tuple] = None) -> str:
    """Atomically write a :class:`~.trainer.TrainState` (+ optional metadata).
    ``state_dicts``: the model's and the optimizer's dicts to write in place
    of the state's own (a tensor-parallel model's, gathered)."""
    os.makedirs(folder, exist_ok=True)
    model_sd, optim_sd = state_dicts or (state.model.state_dict(), state.optimizer.state_dict())
    payload = {"model": model_sd, "optimizer": optim_sd, "step": state.step, "epoch": epoch}
    if extra:
        payload["extra"] = extra
    path = checkpoint_path(folder, basename, epoch)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state):
    """Restore into ``state`` in place; returns ``(state, epoch, extra)``."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    return state, payload.get("epoch"), payload.get("extra")


def load_weights_overlay(path: str, model) -> list[str]:
    """Overlay the model weights of a checkpoint onto ``model``, as torch's
    ``load_state_dict(strict=False)`` does (the reference's FP32 -> LSQ
    preload): every parameter and buffer whose name ``model`` has is
    replaced, the others on either side are left alone (an LSQ model's
    ``step_size``). The JAX package's overlay (``experiments/train_lsq.py:91-108``)
    replaces the parameters only and keeps the BatchNorm statistics of the
    init. Returns the names replaced."""
    device = next(model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)["model"]
    own = model.state_dict()
    overlay = {k: v for k, v in saved.items() if k in own}
    model.load_state_dict(overlay, strict=False)
    return sorted(overlay)


def latest_checkpoint(folder: str, basename: str) -> Optional[str]:
    """Newest checkpoint by numeric epoch suffix (reference
    ``latest_weights_file_path``, ``FullPrecision/config.py:44-50``). The
    run names hold ``[4, 3]`` (the e_layers list), which a glob pattern
    would read as a character class, so files are matched by a regex on
    the escaped name alone."""
    p = Path(folder)
    if not p.exists():
        return None
    best, best_epoch = None, -1
    pat = re.compile(re.escape(basename) + r"(\d+)\.pt$")
    for f in p.iterdir():
        m = pat.match(f.name)
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = str(f), int(m.group(1))
    return best
