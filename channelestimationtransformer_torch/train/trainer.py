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

Data parallelism (``train_chunk_dp``, ``Trainer(mesh=...)``): each rank of
the mesh's ``data`` group draws its sub-batch from its own contiguous shard
of the training set with its own generator, and ``_update`` with a
``group`` takes the step JAX takes of the global batch under one jit: the
BatchNorm statistics and the loss's denominator are the global batch's
(all-reduced under autograd), and the gradients are summed over the ranks
in one all-reduce before the same Adam update on every rank.

Tensor parallelism (``Trainer(mesh=...)`` with a ``model`` axis > 1):
``parallel/tensor.py`` keeps each rank's rows of the sharded weights and
runs their layers column-parallel, so every rank takes the replicated
model's step on the same batch; checkpoints hold the gathered parameters.
Sequence parallelism: a model built with ``attn="ring"`` over the mesh's
``seq`` axis trains through ``parallel/ring.py``'s backward.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..core.config import InformerConfig, TrainConfig
from ..core.metrics import nmse, nmse_share, nmse_split, nmse_split_global
from ..core.runtime import stream_generator
from ..data.windows import WindowDataset, make_batch
from ..models.encoder import batch_stats_group
from ..parallel.collectives import all_reduce_grads, all_reduce_sum
from ..parallel.tensor import full_state_dicts, replicated_grads_equal, tensor_parallel


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


def _update(state: TrainState, x_enc, x_dec, target, generator: torch.Generator,
            group=None) -> dict:
    """Forward in train mode, backward, one optimizer update on an
    already-sampled batch (JAX ``_update``). Metrics stay on the device.

    With a data-parallel ``group`` the batch is this rank's part of a global
    batch split in equal parts: BatchNorm takes the global statistics, the
    loss is this rank's share of the global NMSE (:func:`nmse_share`), and
    the gradients are summed over the group before the update, so every
    rank takes the step of the global batch. The metrics are the global
    batch's."""
    model = state.model
    model.train()
    with batch_stats_group(model, group):
        pred = _predict(model, x_enc, x_dec, generator)
    loss = nmse(pred, target) if group is None else nmse_share(pred, target, group)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if group is None:
        apply_gradients(state)
        return {"loss": loss.detach(), "loss_split": nmse_split(pred.detach(), target)}
    all_reduce_grads(model.parameters(), group)
    apply_gradients(state)
    return {"loss": all_reduce_sum(loss.detach(), group),
            "loss_split": nmse_split_global(pred.detach(), target, group)}


def train_step(state: TrainState, dataset: WindowDataset, *, batch_size: int, label_len: int,
               generator: torch.Generator, group=None) -> dict:
    """One step: sample windows -> AWGN -> forward/backward -> Adam, every
    draw from ``generator`` (on the dataset's device); ``group`` as in
    :func:`_update`."""
    x_enc, x_dec, target = make_batch(dataset, batch_size, label_len, generator=generator)
    return _update(state, x_enc, x_dec, target, generator, group)


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


def train_chunk_dp(state: TrainState, dataset_shard: WindowDataset, *, num_steps: int,
                   per_device_batch: int, label_len: int, generator: torch.Generator,
                   group) -> dict:
    """Data-parallel train chunk (JAX ``train_chunk_dp``): ``num_steps``
    steps of the global batch ``per_device_batch`` x the size of the
    data-parallel ``group``. This rank draws its ``per_device_batch``
    windows from its own shard of the dataset (``dataset_shard``, never the
    whole set) with ``generator``, which the caller keys by rank, as JAX
    folds the device index into the step's key; the update is
    :func:`_update` with ``group``. The summed global loss and split come
    back as device tensors, the same on every rank."""
    losses, splits = [], []
    for _ in range(num_steps):
        m = train_step(state, dataset_shard, batch_size=per_device_batch, label_len=label_len,
                       generator=generator, group=group)
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
    port model with its weights, on the datasets' device.

    ``mesh`` (``parallel.make_mesh``): data-parallel training over its
    ``data`` axis. The training set is shuffled on the host, then each rank
    keeps its contiguous shard; every rank takes rank 0's weights and runs
    :func:`train_chunk_dp` at ``batch_size`` / the axis size a rank, drawing
    from generators keyed by (seed, epoch, batch, rank). Validation runs
    the whole validation set on every rank, so it gives the numbers of a
    single process. Only global rank 0 writes checkpoints.

    A ``model`` axis > 1 (with ``data`` and ``seq`` 1) trains tensor
    parallel: every rank takes model-rank 0's weights and keeps its shards
    (``parallel/tensor.py``); after each chunk the replicated parameters'
    gradients are checked equal across the group, and checkpoints hold the
    gathered parameters and optimizer state. A ring model (``attn="ring"``,
    built over the mesh) trains over a ``seq`` axis of the same mesh."""

    model: nn.Module
    cfg: InformerConfig
    train_cfg: TrainConfig
    train_data: WindowDataset
    val_data: WindowDataset
    mesh: Any = None
    log: Callable[[str], None] = lambda msg: print(msg, flush=True)
    metrics_writer: Any = None  # an object with log_epoch(epoch, train, val, split), or None
    checkpoint_tag: str = "tmodel_"

    def __post_init__(self):
        self._tp = self.mesh is not None and self._tensor_parallel()
        self.state = create_train_state(self.model, self.train_cfg)
        self._schedule = self.state.schedule
        self._train, self._group, self._rank_key = self.train_data, None, ()
        if self.mesh is not None:
            self._shard_data()

    def _tensor_parallel(self) -> bool:
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        if sizes["model"] == 1:
            return False
        if sizes["data"] > 1 or sizes["seq"] > 1:
            raise NotImplementedError(
                f"mesh {sizes}: tensor parallelism runs with data and seq axes of 1 (two-axis "
                "parallelism is not ported: ROADMAP Queue 1, standing limits)")
        group = self.mesh.get_group("model")
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in self.model.state_dict().values():
                dist.broadcast(t, src, group=group)
        tensor_parallel(self.model, self.mesh)
        return True

    def _shard_data(self):
        tc = self.train_cfg
        group = self.mesh.get_group("data")
        n_data = dist.get_world_size(group)
        if tc.batch_size % n_data != 0:
            raise ValueError(f"batch_size {tc.batch_size} not divisible by data-axis size "
                             f"{n_data}")
        h = self.train_data.h
        if h.shape[0] % n_data != 0:
            raise ValueError(f"{h.shape[0]} training samples not divisible by data-axis size "
                             f"{n_data}")
        # Each rank draws its windows from its contiguous shard; a sorted
        # dataset (scenario / SNR / time ordered pickles) would bias each
        # rank's sub-batches for good, so shuffle the sample order first.
        perm = torch.randperm(h.shape[0], generator=torch.Generator().manual_seed(
            tc.seed ^ 0x5EED))
        rank, per = dist.get_rank(group), h.shape[0] // n_data
        self._train = dataclasses.replace(
            self.train_data, h=h[perm[rank * per:(rank + 1) * per].to(h.device)])
        src = dist.get_global_rank(group, 0)
        for t in self.model.state_dict().values():
            dist.broadcast(t, src, group=group)
        self._group, self._rank_key = group, (rank,)

    def run_validation(self, generator: torch.Generator, num_batches: int = 8) -> dict:
        """Per-horizon split loss (reference ``run_validation`` semantics, incl.
        the prediction-power normalization quirk) plus the target-normalized
        scalar NMSE for quirk-free comparisons."""
        return eval_chunk(self.model, self.val_data, num_batches=num_batches,
                          batch_size=self.train_cfg.batch_size, label_len=self.cfg.label_len,
                          generator=generator)

    def _run_chunk(self, generator: torch.Generator, num_steps: int) -> dict:
        """One chunk of train steps, data-parallel when there is a mesh."""
        kwargs = dict(num_steps=num_steps, label_len=self.cfg.label_len, generator=generator)
        batch = self.train_cfg.batch_size
        if self._group is None:
            return train_chunk(self.state, self._train, batch_size=batch, **kwargs)
        return train_chunk_dp(self.state, self._train, group=self._group,
                              per_device_batch=batch // dist.get_world_size(self._group),
                              **kwargs)

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
                m = self._run_chunk(stream_generator(self.train_data.device, tc.seed + 1,
                                                     epoch, batch_idx, *self._rank_key), n)
                if self._tp and not replicated_grads_equal(self.model):
                    raise RuntimeError("tensor-parallel step: the gradients of the replicated "
                                       "parameters differ across the model group")
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

                dicts = (full_state_dicts(self.model, self.state.optimizer) if self._tp
                         else None)
                if not dist.is_initialized() or dist.get_rank() == 0:
                    save_checkpoint(self.state, tc.checkpoint_dir, self.checkpoint_tag,
                                    epoch + 1, state_dicts=dicts)
                if self.mesh is not None:
                    dist.barrier()  # the file exists for every rank after
        return history
