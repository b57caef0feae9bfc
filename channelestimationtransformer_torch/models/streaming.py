"""Streaming (blockwise) channel prediction with constant state per stream
(JAX counterpart ``models/streaming.py``).

Reference: ``StreamingTransformer(WIP)/``, an unfinished attempt at
blockwise streaming inference driven by 5-slot chunks (``debug.py:58-62``).

The stream state is ``(window, position, filled)``: the last ``seq_len``
slots, oldest first, kept on the device in float32 whatever the model's
dtype (JAX ``streaming.py:45``), and two host counters. Each
:func:`streaming_step` shifts one block of new slots into the window in
place and predicts the next ``pred_len`` slots with the standard Informer,
so a model trained offline streams with its own weights. Work per block is
one window-sized forward.

The JAX module's docstrings say each block is embedded at its *absolute*
stream position, but its ``streaming_step`` calls ``model.apply(variables,
x_enc, x_dec)`` and never passes ``state.position`` (``streaming.py:83``):
positions are relative to the window, exactly as in offline inference, which
is why JAX's own test can hold the full-window prediction to the offline
forward. The port follows the code: ``position`` is counted and not passed
to the model (``DataEmbedding``'s ``position_offset`` is there for a caller
that wants absolute positions).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..core.config import InformerConfig
from ..core.runtime import resolve_device


class StreamState(NamedTuple):
    """Carry for one batch of streams."""

    window: torch.Tensor  # [B, seq_len, F] f32, most recent slots (oldest first)
    position: int  # absolute index of the next slot
    filled: int  # number of valid slots in the window


def init_stream(batch: int, cfg: InformerConfig, device=None) -> StreamState:
    """An empty stream state on ``device`` (default: the card; raises
    without one)."""
    device = resolve_device(device)
    return StreamState(
        window=torch.zeros(batch, cfg.seq_len, cfg.enc_in, device=device),
        position=0,
        filled=0,
    )


def push_block(state: StreamState, block: torch.Tensor) -> StreamState:
    """Shift ``block`` ([B, K, F], K <= seq_len) into the window, in place
    (JAX: ``jnp.roll`` then ``dynamic_update_slice``), and advance the
    counters. The returned state holds the same window tensor."""
    window = state.window
    k, length = block.shape[1], window.shape[1]
    if k > length:
        raise ValueError(f"a block of {k} slots does not fit a window of {length}")
    window[:, : length - k] = window[:, k:].clone()
    window[:, length - k:] = block
    return StreamState(window=window, position=state.position + k,
                       filled=min(state.filled + k, length))


def streaming_step(
    model,
    state: StreamState,
    block: torch.Tensor,
    cfg: InformerConfig,
) -> Tuple[StreamState, torch.Tensor]:
    """Ingest one block of slots and predict the next ``pred_len`` slots.
    The decoder input follows the offline convention (last ``label_len``
    observed slots + zeros); the model sees window positions (module
    docstring)."""
    state = push_block(state, block)
    x_enc = state.window
    label = x_enc[:, x_enc.shape[1] - cfg.label_len:]
    zeros = x_enc.new_zeros((x_enc.shape[0], cfg.pred_len, x_enc.shape[2]))
    out = model(x_enc, torch.cat([label, zeros], dim=1))
    pred = out[0] if isinstance(out, tuple) else out
    return state, pred


def streaming_rollout(model, cfg: InformerConfig, stream: torch.Tensor, block: int):
    """Run a whole stream ``[B, T, F]`` through in blocks of ``block``
    slots, from an empty state on the stream's device; a Python loop where
    JAX scans. Returns ``[T // block, B, pred_len, F]``: one forecast per
    ingested block (the reference ``debug.py`` harness pattern)."""
    b, t, _ = stream.shape
    state = init_stream(b, cfg, device=stream.device)
    preds = []
    for i in range(t // block):
        state, pred = streaming_step(model, state, stream[:, i * block:(i + 1) * block], cfg)
        preds.append(pred)
    return torch.stack(preds)
