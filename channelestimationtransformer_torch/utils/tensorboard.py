"""TensorBoard event logging (JAX counterpart ``utils/tensorboard.py``).

Reference: every trainer writes ``Loss/train``, ``Loss/val``, ``Loss/val1..5``
scalars via ``SummaryWriter(experiment_name)``
(``QuantizationStudy/QuantizationAwareTraining/QuantizationAwareTraining.py:330-337``).

Uses ``torch.utils.tensorboard.SummaryWriter`` where the ``tensorboard``
package imports; otherwise it writes one JSON object a scalar to
``events.jsonl`` in ``logdir``, so training never depends on it.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    """SummaryWriter-compatible scalar logger with a JSONL fallback."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except ImportError:
            self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        else:
            self._jsonl.write(
                json.dumps({"t": time.time(), "tag": tag, "value": float(value), "step": step})
                + "\n")
            self._jsonl.flush()

    def log_epoch(self, step: int, train_loss: float, val_loss: float, val_split) -> None:
        """The reference's scalar set (``Loss/train``, ``Loss/val``, ``Loss/val{i}``)."""
        self.add_scalar("Loss/train", train_loss, step)
        self.add_scalar("Loss/val", val_loss, step)
        for i, v in enumerate(val_split, start=1):
            self.add_scalar(f"Loss/val{i}", float(v), step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
