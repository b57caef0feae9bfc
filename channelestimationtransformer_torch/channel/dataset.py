"""End-to-end dataset generation: CDL sample -> beam sweep -> WindowDataset
(JAX counterpart ``channel/dataset.py``).

Replaces the reference's three-stage host pipeline
(``GenerateChannelsFreqPreMatlab.py`` -> ``Beamforming.m`` ->
``GenerateChannelsFreqPostMatlab.py``, orchestrated by
``generateDataset.sbatch:12-51``). The result stays on the device, or is
pickled in the reference's exact format (complex ``[N, slots, Nr, Nt]``).

A dataset is a function of its key and chunk size alone: chunk ``c`` draws
from the stream keyed by ``(*key, c)`` (``core/runtime.stream_generator``),
whatever ran before it, as the JAX package splits one key per chunk.
"""

from __future__ import annotations

import pickle
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.runtime import resolve_device, stream_generator
from ..data.windows import WindowDataset, pack_features
from .beamforming import beam_sweep_project, dft_codebook_ri, standardize_time_series
from .cdl import CDLDraws, CDLModel, generate_cdl_channel


def _key_path(key) -> tuple:
    return (int(key),) if np.ndim(key) == 0 else tuple(int(k) for k in key)


def generate_beamformed_dataset(
    key: int | Sequence[int],
    *,
    model: CDLModel = CDLModel(),
    num_samples: int = 512,
    num_slots: int = 150,
    num_beams_selected: int = 4,
    batch_size: int = 128,
    standardize: bool = True,
    device=None,
    draws: Sequence[CDLDraws] | None = None,
    return_selected: bool = False,
):
    """Generate ``[num_samples, num_slots, Nr, Nt=beams, 2]`` effective
    channels (ri) on ``device`` (default: the card; raises without one).

    The layout matches the repacked reference pickles
    (``GenerateChannelsFreqPostMatlab.py:23-48``: ``[B*Sc, Slot, Nr, Nt]``).
    Generation is chunked by ``batch_size`` to bound peak memory (the
    64-antenna channel before the beam sweep is the big intermediate).
    ``key`` is an int or a tuple of ints; chunk ``c`` draws from
    ``stream_generator(device, *key, c)``. ``draws`` (one
    :class:`~.cdl.CDLDraws` a chunk) replace those draws. With
    ``return_selected`` the beams each sample kept come back too, as
    ``(h, selected [num_samples, num_beams_selected])``.
    """
    device = resolve_device(device)
    path = _key_path(key)
    codebook = dft_codebook_ri(model.num_bs_ant, device=device)
    sizes = [min(batch_size, num_samples - start) for start in range(0, num_samples, batch_size)]
    if draws is not None and len(draws) != len(sizes):
        raise ValueError(f"{len(draws)} draws for {len(sizes)} chunks")
    chunks, selected = [], []
    for c, b in enumerate(sizes):
        if draws is None:
            h = generate_cdl_channel(model, b, num_slots, device=device,
                                     generator=stream_generator(device, *path, c))
        else:
            h = generate_cdl_channel(model, b, num_slots, device=device, draws=draws[c])
        h_eff, sel = beam_sweep_project(h, codebook, num_beams_selected)
        if standardize:
            h_eff = standardize_time_series(h_eff)
        # [b, T, beams, U, 2] -> [b, T, U, beams, 2]: the reference repack
        # transposes to [Nr=Rx, Nt=beam] (GenerateChannelsFreqPostMatlab.py:9).
        chunks.append(h_eff.transpose(2, 3))
        selected.append(sel)
    h = torch.cat(chunks, dim=0)
    return (h, torch.cat(selected, dim=0)) if return_selected else h


def make_window_dataset(
    key: int | Sequence[int],
    *,
    model: CDLModel = CDLModel(),
    num_samples: int = 512,
    num_slots: int = 150,
    seq_len: int = 90,
    pred_len: int = 5,
    snr_db: float = 21.0,
    device=None,
) -> WindowDataset:
    """Generate with :func:`generate_beamformed_dataset` and wrap the packed
    features in a :class:`WindowDataset` on ``device``."""
    device = resolve_device(device)
    h = generate_beamformed_dataset(key, model=model, num_samples=num_samples,
                                    num_slots=num_slots, device=device)
    return WindowDataset(h=pack_features(h), seq_len=seq_len, pred_len=pred_len,
                         snr_db=snr_db, device=device)


def generate_beamformed_dataset_sharded(
    key: int | Sequence[int],
    mesh,
    *,
    model: CDLModel = CDLModel(),
    num_samples: int = 512,
    num_slots: int = 150,
    num_beams_selected: int = 4,
    batch_size: int = 128,
    standardize: bool = True,
    axis_name: str = "data",
    device=None,
):
    """This rank's shard of a sample-sharded dataset over ``mesh``'s
    ``axis_name`` axis (JAX ``generate_beamformed_dataset_sharded``): rank
    ``r`` of ``P`` generates ``num_samples / P`` samples with
    :func:`generate_beamformed_dataset` from the key path ``(*key, r)``, as
    JAX folds the device index into the key, and keeps them. The global
    dataset is the shards in rank order; it depends on the key and ``P``,
    and it never leaves the ranks that hold it."""
    group = mesh.get_group(axis_name)
    n_shards = dist.get_world_size(group)
    if num_samples % n_shards:
        raise ValueError(f"num_samples {num_samples} not divisible by "
                         f"{axis_name} axis size {n_shards}")
    rank = dist.get_rank(group)
    return generate_beamformed_dataset(
        (*_key_path(key), rank), model=model, num_samples=num_samples // n_shards,
        num_slots=num_slots, num_beams_selected=num_beams_selected, batch_size=batch_size,
        standardize=standardize, device=device)


def save_reference_format(path: str, h) -> None:
    """Pickle in the reference's dataset format (complex64 ndarray
    ``[N, slots, Nr, Nt]``), readable by its ``SeqData`` and by
    ``WindowDataset.from_pickle``. Takes the ri representation (a tensor on
    any device, or an array) and recombines it to complex on the host."""
    arr = h.detach().cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h)
    if arr.shape[-1] == 2 and not np.iscomplexobj(arr):
        arr = arr[..., 0] + 1j * arr[..., 1]
    with open(path, "wb") as f:
        pickle.dump(arr.astype(np.complex64), f)


def train_val_split(h, val_fraction: float = 0.2) -> Tuple:
    """80/20 split along the sample axis, like
    ``GenerateChannelsFreqPostMatlab.py:49-57``."""
    n = h.shape[0]
    n_val = int(n * val_fraction)
    return h[: n - n_val], h[n - n_val:]
