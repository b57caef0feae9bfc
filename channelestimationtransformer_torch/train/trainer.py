"""Training and validation loops of the channel predictors.

JAX counterpart: ``train/trainer.py`` (``make_schedule``, ``_update``,
``train_step_impl``, ``train_chunk``, ``eval_step_impl``, ``eval_chunk``,
``Trainer``); reference ``FullPrecision/QuantizationAwareTraining.py:141-320``
(Adam + cosine annealing, NMSE loss, per-epoch validation with the
per-horizon split loss, checkpoints, parseable text logs).

A step draws its windows, AWGN and every dropout mask from one
``torch.Generator`` on the dataset's device; the model runs eagerly and the
optimizer is torch's Adam (AdamW with weight decay), as the JAX package
leaves the optimizer to XLA. Everything stays on the dataset's device;
metrics come back as tensors, and ``Trainer`` fetches them once per chunk.
The data-parallel path (``train_chunk_dp``) is not ported yet (ROADMAP
Queue 1: parallelism).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..core.config import InformerConfig, TrainConfig
from ..core.metrics import nmse, nmse_split
from ..core.runtime import stream_generator
from ..data.windows import WindowDataset, make_batch


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax ``cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def _warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                         decay_steps: int, end_value: float):
    """optax ``warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps`` (> 0), then cosine decay to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = _cosine_decay(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return cosine(count - warmup_steps)
    return schedule


def make_schedule(train_cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first), as the JAX
    package's ``make_schedule`` builds it from optax (reference: cosine
    annealing; optional linear warmup for from-scratch post-norm stability)."""
    total = max(train_cfg.num_epochs, 1) * train_cfg.steps_per_epoch
    if train_cfg.schedule == "constant":
        # The reference's committed SNR-sweep runs hold lr constant at 1e-3.
        return lambda count: train_cfg.lr
    warmup = min(train_cfg.warmup_steps, max(total // 10, 1))
    if warmup >= total:
        total = warmup + 1  # optax's warmup-cosine needs decay_steps > warmup_steps
    if warmup > 0:
        return _warmup_cosine_decay(train_cfg.lr * 1e-2, train_cfg.lr, warmup, total,
                                    train_cfg.lr_min)
    return _cosine_decay(train_cfg.lr, total,
                         train_cfg.lr_min / train_cfg.lr if train_cfg.lr else 0.0)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer, the
    schedule and the number of updates taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(model: nn.Module, train_cfg: TrainConfig) -> TrainState:
    """Adam, or AdamW when ``weight_decay`` > 0, with optax's defaults
    (betas 0.9 / 0.999, eps 1e-8) over every parameter of ``model``."""
    schedule = make_schedule(train_cfg)
    kwargs = dict(lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    if train_cfg.weight_decay:
        opt = torch.optim.AdamW(model.parameters(), weight_decay=train_cfg.weight_decay,
                                **kwargs)
    else:
        opt = torch.optim.Adam(model.parameters(), **kwargs)
    return TrainState(model=model, optimizer=opt, schedule=schedule)


def apply_gradients(state: TrainState) -> None:
    """One optimizer update from the gradients in ``state.model`` at the
    schedule's rate for this update (flax ``TrainState.apply_gradients``:
    optax evaluates the schedule at the update count before incrementing it)."""
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def _predict(model, x_enc, x_dec, generator=None):
    out = model(x_enc, x_dec, generator=generator)
    return out[0] if isinstance(out, tuple) else out  # output_attention configs


def _update(state: TrainState, x_enc, x_dec, target, generator: torch.Generator) -> dict:
    """Forward in train mode, backward, one optimizer update on an
    already-sampled batch (JAX ``_update``). Metrics stay on the device."""
    model = state.model
    model.train()
    pred = _predict(model, x_enc, x_dec, generator)
    loss = nmse(pred, target)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    apply_gradients(state)
    return {"loss": loss.detach(), "loss_split": nmse_split(pred.detach(), target)}


def train_step(state: TrainState, dataset: WindowDataset, *, batch_size: int, label_len: int,
               generator: torch.Generator) -> dict:
    """One step: sample windows -> AWGN -> forward/backward -> Adam, every
    draw from ``generator`` (on the dataset's device)."""
    x_enc, x_dec, target = make_batch(dataset, batch_size, label_len, generator=generator)
    return _update(state, x_enc, x_dec, target, generator)


def train_chunk(state: TrainState, dataset: WindowDataset, *, num_steps: int, batch_size: int,
                label_len: int, generator: torch.Generator) -> dict:
    """``num_steps`` train steps drawing in turn from ``generator``; the
    summed loss and per-horizon split come back as device tensors."""
    losses, splits = [], []
    for _ in range(num_steps):
        m = train_step(state, dataset, batch_size=batch_size, label_len=label_len,
                       generator=generator)
        losses.append(m["loss"])
        splits.append(m["loss_split"])
    return {"loss_sum": torch.stack(losses).sum(), "split_sum": torch.stack(splits).sum(dim=0)}


@torch.no_grad()
def eval_step(model, dataset: WindowDataset, *, batch_size: int, label_len: int,
              **draws) -> dict:
    """Per-horizon NMSE (``split``) and scalar NMSE (``nmse``) of one batch
    of fresh windows. ``draws`` go to :func:`make_batch` (``generator``, or
    injected ``idx``/``starts``/``noise``); the ``generator`` then feeds the
    model's ProbSparse draws (JAX draws its eval ``"sample"`` stream,
    ``train/trainer.py:280-284``), and a model with no prob layer draws
    nothing more from it."""
    model.eval()
    x_enc, x_dec, target = make_batch(dataset, batch_size, label_len, **draws)
    pred = _predict(model, x_enc, x_dec, draws.get("generator"))
    return {"split": nmse_split(pred, target), "nmse": nmse(pred, target)}


@torch.no_grad()
def eval_chunk(model, dataset: WindowDataset, *, num_batches: int, batch_size: int,
               label_len: int, generator: torch.Generator) -> dict:
    """The mean of :func:`eval_step`'s ``nmse`` and ``split`` over
    ``num_batches`` batches drawn from ``generator``."""
    nmses, splits = [], []
    for _ in range(num_batches):
        m = eval_step(model, dataset, batch_size=batch_size, label_len=label_len,
                      generator=generator)
        nmses.append(m["nmse"])
        splits.append(m["split"])
    return {"nmse": torch.stack(nmses).mean(), "split": torch.stack(splits).mean(dim=0)}


@dataclasses.dataclass
class Trainer:
    """Epoch-driven trainer with reference-format logging. ``model`` is a
    port model with its weights, on the datasets' device."""

    model: nn.Module
    cfg: InformerConfig
    train_cfg: TrainConfig
    train_data: WindowDataset
    val_data: WindowDataset
    log: Callable[[str], None] = lambda msg: print(msg, flush=True)
    metrics_writer: Any = None  # an object with log_epoch(epoch, train, val, split), or None
    checkpoint_tag: str = "tmodel_"

    def __post_init__(self):
        self.state = create_train_state(self.model, self.train_cfg)
        self._schedule = self.state.schedule

    def run_validation(self, generator: torch.Generator, num_batches: int = 8) -> dict:
        """Per-horizon split loss (reference ``run_validation`` semantics, incl.
        the prediction-power normalization quirk) plus the target-normalized
        scalar NMSE for quirk-free comparisons."""
        return eval_chunk(self.model, self.val_data, num_batches=num_batches,
                          batch_size=self.train_cfg.batch_size, label_len=self.cfg.label_len,
                          generator=generator)

    def _run_chunk(self, generator: torch.Generator, num_steps: int) -> dict:
        return train_chunk(self.state, self.train_data, num_steps=num_steps,
                           batch_size=self.train_cfg.batch_size, label_len=self.cfg.label_len,
                           generator=generator)

    def fit(self, num_epochs: Optional[int] = None, start_epoch: int = 0):
        """Train; ``start_epoch`` resumes mid-schedule (the generators are
        keyed by absolute epoch and batch index, so a resumed run replays
        the identical data, noise and dropout sequence: step-exact)."""
        tc = self.train_cfg
        num_epochs = num_epochs if num_epochs is not None else tc.num_epochs
        steps = tc.steps_per_epoch
        history = []

        chunk = tc.log_every
        for epoch in range(start_epoch, num_epochs):
            epoch_start = time.time()
            total_loss = 0.0

            batch_idx = 0
            while batch_idx < steps:
                n = min(chunk, steps - batch_idx)
                t0 = time.time()
                m = self._run_chunk(
                    stream_generator(self.train_data.device, tc.seed + 1, epoch, batch_idx), n)
                batch_idx += n
                stats = torch.cat([m["loss_sum"].reshape(1), m["split_sum"]]).cpu().numpy()
                total_loss += float(stats[0])
                ms_per_batch = (time.time() - t0) * 1000 / n
                cur = float(stats[0]) / n
                split = [float(v) / n for v in stats[1:]]
                dbg = "| Loss pred_len " + "".join(
                    f" {i}: {v:5.2f}" for i, v in enumerate(split)
                )
                # Live schedule value, like the reference's scheduler LR log.
                lr = float(self._schedule(epoch * steps + batch_idx))
                if batch_idx < steps or steps <= chunk:
                    self.log(
                        f"| epoch {epoch:3d} | {batch_idx:5d}/{steps:5d} batches | "
                        f"lr {lr:e} | ms/batch {ms_per_batch:5.2f} | "
                        f"loss {cur:5.4f}  " + dbg
                    )

            val = self.run_validation(
                stream_generator(self.val_data.device, tc.seed + 1, epoch, 1 << 20))
            val_loss = val["split"].cpu().numpy()
            elapsed = time.time() - epoch_start
            dbg = "| Loss pred len " + "".join(
                f" {i}: {v:5.2f}" for i, v in enumerate(val_loss)
            )
            self.log("-" * 89)
            self.log(
                f"| end of epoch {epoch:3d} | time: {elapsed:5.2f}s | "
                f"valid loss {float(val_loss.sum() / len(val_loss))} {dbg}"
            )
            self.log("-" * 89)
            val_nmse = float(val["nmse"])
            history.append({"split": val_loss, "nmse": val_nmse})
            if self.metrics_writer is not None:
                # Loss/train is the mean train loss over ALL steps this epoch.
                self.metrics_writer.log_epoch(epoch, total_loss / steps, val_nmse, val_loss)
            if tc.checkpoint_every_epochs and (epoch + 1) % tc.checkpoint_every_epochs == 0:
                from .checkpoint import save_checkpoint

                save_checkpoint(self.state, tc.checkpoint_dir, self.checkpoint_tag, epoch + 1)
        return history
