"""The port's ``Trainer`` end to end on the CPU, at the tiny setup of
``tests/test_trainer.py:21-47``: the dataset comes from the JAX package's
CDL generator, handed over as numpy. It must learn (final NMSE below 0.7 of
the initial and below 0.8), print log lines that the reference's regexes
parse, and resume step-exactly from its checkpoint (bit-identical weights).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from channelestimationtransformer_tpu.channel.cdl import CDLModel
from channelestimationtransformer_tpu.channel.dataset import make_window_dataset

from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.data.windows import WindowDataset
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from channelestimationtransformer_torch.train.trainer import Trainer

CFG = dict(seq_len=24, label_len=6, pred_len=5, d_model=32, n_heads=4, e_layers=(2,),
           d_layers=1, d_ff=32)


@pytest.fixture(scope="module")
def channel():
    """Slow-fading CDL channels (0.5 m/s) from the JAX generator, as numpy."""
    model = CDLModel(num_bs_ant=8, num_ut_ant=2, ue_speed_ms=0.5)
    return [np.array(make_window_dataset(
        jax.random.key(k), model=model, num_samples=n, num_slots=40, seq_len=CFG["seq_len"],
        pred_len=CFG["pred_len"], snr_db=30.0).h) for k, n in ((0, 128), (1, 32))]


def _trainer(channel, dropout=0.0, **train_kwargs):
    cfg = InformerConfig(dropout=dropout, **CFG)
    tc = TrainConfig(**{**dict(batch_size=32, num_epochs=12, lr=1e-3, steps_per_epoch=30,
                               log_every=10, seed=0), **train_kwargs})
    train, val = (WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=30.0,
                                device="cpu") for h in channel)
    logs = []
    trainer = Trainer(model=build_informer(cfg, device="cpu", seed=0), cfg=cfg, train_cfg=tc,
                      train_data=train, val_data=val, log=logs.append)
    return trainer, logs


def test_training_reduces_nmse(channel):
    trainer, _ = _trainer(channel)
    initial = float(trainer.run_validation(torch.Generator().manual_seed(42))["nmse"])
    history = trainer.fit()
    final = history[-1]["nmse"]
    assert final < initial * 0.7, (initial, final)
    assert final < 0.8  # clearly better than predicting zeros (NMSE 1.0)


def test_log_format_is_reference_parseable(channel):
    trainer, logs = _trainer(channel)
    trainer.fit(num_epochs=1)
    text = "\n".join(logs)
    # The exact regexes of tests/test_trainer.py:67-73 (reference Figures/parse.py).
    loss_pattern = re.compile(
        r"\| end of epoch\s+(\d+)\s+\|\s+.*\|\s+valid loss\s+(.+)\s+\|\s+Loss pred len\s+(.+)"
    )
    assert any(loss_pattern.match(l) for l in logs), text
    assert any(
        re.match(r"\| epoch\s+\d+ \|\s+\d+/\s*\d+ batches \| lr .* \| ms/batch .* \| loss .*", l)
        for l in logs
    ), text


@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_crash_resume_is_step_exact(channel, tmp_path, dropout):
    """A run stopped after epoch 2 and resumed from its checkpoint replays
    the same generators (keyed by epoch and batch index) and ends with
    weights, BatchNorm statistics and optimizer state bit-identical to an
    uninterrupted run; with dropout its masks replay too."""
    trainer_a, _ = _trainer(channel, dropout)
    hist_a = trainer_a.fit(num_epochs=4)

    trainer_b, _ = _trainer(channel, dropout, checkpoint_every_epochs=2,
                            checkpoint_dir=str(tmp_path))
    trainer_b.fit(num_epochs=3)
    path = latest_checkpoint(str(tmp_path), "tmodel_")
    assert path == str(tmp_path / "tmodel_2.pt")

    trainer_c, _ = _trainer(channel, dropout)
    trainer_c.state, epoch, _ = load_checkpoint(path, trainer_c.state)
    assert epoch == 2 and trainer_c.state.step == 2 * 30
    hist_c = trainer_c.fit(num_epochs=4, start_epoch=2)

    a, c = trainer_a.model.state_dict(), trainer_c.model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert hist_a[-1]["nmse"] == hist_c[-1]["nmse"]


def test_checkpoint_round_trip_and_latest(channel, tmp_path):
    trainer, _ = _trainer(channel, steps_per_epoch=3)
    trainer.fit(num_epochs=1)
    for epoch in (1, 10, 2):
        save_checkpoint(trainer.state, str(tmp_path), "run_", epoch, extra={"tag": epoch})
    assert latest_checkpoint(str(tmp_path), "run_") == str(tmp_path / "run_10.pt")
    assert latest_checkpoint(str(tmp_path / "missing"), "run_") is None
    assert not list(tmp_path.glob("*.tmp"))  # the writes were atomic renames
    fresh, _ = _trainer(channel, steps_per_epoch=3)
    state, epoch, extra = load_checkpoint(str(tmp_path / "run_2.pt"), fresh.state)
    assert (epoch, extra, state.step) == (2, {"tag": 2}, 3)
    want = trainer.model.state_dict()
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in want.items())
