"""RNN / GRU / LSTM channel predictors (JAX counterpart ``models/recurrent.py``).

Reference: ``models/{RNN,GRU,LSTM}/model.py``: Linear encoder -> stacked
recurrent core -> Linear decoder; ``train_data`` runs teacher-forced
one-step-ahead prediction over the sequence, ``test_data`` runs the history
then free-runs closed-loop for ``pred_len`` steps
(``models/LSTM/model.py:57-108``).

The JAX package scans flax cells over time (``nn.scan``); here the stacked
cells run as one call of torch's fused recurrent op (``torch.lstm``,
``torch.gru``, ``torch.rnn_tanh``: cuDNN on the card) over the sequence.
Each cell keeps flax's parameters and nothing more, in torch's gate layout
(flax 0.12.3 cells):

- ``OptimizedLSTMCell``: input kernels ``ii, if, ig, io`` without bias,
  hidden kernels ``hi, hf, hg, ho`` with bias -> ``weight_ih`` ``[4H, in]``,
  ``weight_hh`` ``[4H, H]`` (torch's gate order i, f, g, o) and ``bias_hh``;
  the op's input bias is a zero constant;
- ``GRUCell``: ``ir, iz, in`` with bias, ``hr, hz`` without, ``hn`` with ->
  ``weight_ih`` ``[3H, in]``, ``weight_hh`` ``[3H, H]`` (r, z, n),
  ``bias_ih`` and ``bias_hn``; torch's ``n = tanh(W_in x + b_in + r * (W_hn
  h + b_hn))`` is flax's, with the r and z hidden biases a zero constant;
- ``SimpleCell``: ``i`` with bias, ``h`` without -> ``weight_ih``,
  ``weight_hh``, ``bias_ih``.

So an optimizer sees flax's parameters one for one (torch's ``nn.LSTM``
would train two biases where flax has one). Carries start at zeros. The
model computes in float32, as the JAX one does whatever
``RecurrentConfig.dtype`` says (its cells take no dtype).
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import RecurrentConfig, activation_dtype
from ..core.runtime import resolve_device
from ..parallel.tensor import full_param
from .init import dense_, variance_scaling_

GATES = {"lstm": 4, "gru": 3, "rnn": 1}
_RNN_OPS = {"lstm": torch.lstm, "gru": torch.gru, "rnn": torch.rnn_tanh}


class RecurrentCell(nn.Module):
    """One layer's parameters in torch's layout (module docstring)."""

    def __init__(self, kind: str, input_size: int, hidden: int):
        super().__init__()
        self.kind = kind
        g = GATES[kind]
        self.weight_ih = nn.Parameter(torch.empty(g * hidden, input_size))
        self.weight_hh = nn.Parameter(torch.empty(g * hidden, hidden))
        if kind == "lstm":
            self.bias_hh = nn.Parameter(torch.zeros(g * hidden))
        else:
            self.bias_ih = nn.Parameter(torch.zeros(g * hidden))
        if kind == "gru":
            self.bias_hn = nn.Parameter(torch.zeros(hidden))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """flax's defaults: each gate's input kernel lecun-normal, its hidden
        kernel orthogonal, biases zero."""
        for w_in, w_h in zip(self.weight_ih.chunk(GATES[self.kind]),
                             self.weight_hh.chunk(GATES[self.kind])):
            variance_scaling_(w_in, 1.0, generator=generator)
            nn.init.orthogonal_(w_h, generator=generator)
        for name in ("bias_ih", "bias_hh", "bias_hn"):
            if hasattr(self, name):
                nn.init.zeros_(getattr(self, name))

    def op_params(self) -> list:
        """``[w_ih, w_hh, b_ih, b_hh]`` as the fused op takes them (under
        tensor parallelism the weights gathered from the ranks' rows)."""
        w_ih, w_hh = full_param(self, "weight_ih"), full_param(self, "weight_hh")
        zeros = w_ih.new_zeros(w_ih.shape[0])
        if self.kind == "lstm":
            return [w_ih, w_hh, zeros, self.bias_hh]
        if self.kind == "gru":
            b_hh = torch.cat([zeros[: 2 * self.bias_hn.shape[0]], self.bias_hn])
            return [w_ih, w_hh, self.bias_ih, b_hh]
        return [w_ih, w_hh, self.bias_ih, zeros]


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)``, its weight gathered where tensor parallelism sharded it."""
    return F.linear(x, full_param(layer, "weight"), layer.bias)


class RecurrentPredictor(nn.Module):
    """Stacked recurrent core with encoder/decoder projections.
    ``forward`` = teacher-forced ``train_data``; :meth:`rollout` =
    closed-loop ``test_data``."""

    def __init__(self, config: RecurrentConfig):
        super().__init__()
        cfg = config
        activation_dtype(cfg.dtype)
        self.config = cfg
        self.encoder = nn.Linear(cfg.features, cfg.input_size)
        size = cfg.input_size
        for i in range(cfg.num_layers):
            self.add_module(f"cells_{i}", RecurrentCell(cfg.cell, size, cfg.hidden_size))
            size = cfg.hidden_size
        self.decoder = nn.Linear(cfg.hidden_size, cfg.features)

    def _cells(self):
        return [getattr(self, f"cells_{i}") for i in range(self.config.num_layers)]

    def _init_carry(self, batch: int, like: torch.Tensor):
        cfg = self.config
        h = like.new_zeros(cfg.num_layers, batch, cfg.hidden_size)
        return (h, h.clone()) if cfg.cell == "lstm" else h

    def _core(self, h: torch.Tensor, carry):
        """The stacked cells over ``h`` ``[B, T, input_size]`` from ``carry``:
        ``(outputs [B, T, H], carry)``."""
        params = [p for cell in self._cells() for p in cell.op_params()]
        with warnings.catch_warnings():
            # cuDNN copies the per-layer weights into one buffer each call.
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            out = _RNN_OPS[self.config.cell](h, carry, params, True, self.config.num_layers,
                                             0.0, self.training, False, True)
        return out[0], (out[1:] if self.config.cell == "lstm" else out[1])

    def _step(self, carry, x):
        """Slots ``x`` ``[B, T, F]`` through encoder -> stacked cells -> decoder."""
        ys, carry = self._core(_linear(self.encoder, x), carry)
        return carry, _linear(self.decoder, ys)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Teacher-forced one-step-ahead prediction (reference ``train_data``,
        ``models/LSTM/model.py:55-74``): output[t] predicts x[t+1]; output[0]
        is x[0] itself (the reference seeds the output list with the first
        input slot)."""
        _, ys = self._step(self._init_carry(x.shape[0], x), x[:, :-1])
        return torch.cat([x[:, :1], ys], dim=1)

    def rollout(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        """Closed-loop evaluation (reference ``test_data``,
        ``models/LSTM/model.py:76-108``): consume the noisy history, then
        feed predictions back for ``pred_len - 1`` more steps. Returns
        ``[B, pred_len, F]``, the horizon predictions."""
        carry, ys = self._step(self._init_carry(x.shape[0], x), x)
        preds = [ys[:, -1:]]  # the prediction for the first horizon slot
        for _ in range(pred_len - 1):
            carry, y = self._step(carry, preds[-1])
            preds.append(y)
        return torch.cat(preds, dim=1)


def build_recurrent(config: RecurrentConfig, *, device=None, seed: int = 0) -> RecurrentPredictor:
    """A :class:`RecurrentPredictor` in ``eval()`` mode on ``device``
    (default: the card; raises without one), with flax's default
    initialisers drawn from a ``torch.Generator`` seeded by ``seed``."""
    device = resolve_device(device)
    model = RecurrentPredictor(config)
    gen = torch.Generator().manual_seed(seed)
    dense_(model.encoder, gen)
    for cell in model._cells():
        cell.reset_parameters(gen)
    dense_(model.decoder, gen)
    return model.to(device).eval()
