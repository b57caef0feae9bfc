"""The program under test, as the benchmark drives it: the PyTorch port
``channelestimationtransformer_torch``, imported here and nowhere else in
the harness (the reference never imports it).

It takes from the port only its entry points (the model class that the
configuration's ``entry`` names, ``module:Class``, with the port's
``InformerConfig``; the windowed dataset, the training loop, the batch
maker), its launch counters and, through the trace, its kernels' names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

PACKAGE = "channelestimationtransformer_torch"


@dataclasses.dataclass
class Program:
    """The port's model and dataset of one configuration on ``device``."""

    config: dict
    weights: dict
    h: torch.Tensor
    device: torch.device

    def __post_init__(self):
        from channelestimationtransformer_torch.core.config import InformerConfig
        from channelestimationtransformer_torch.data.windows import WindowDataset

        model_cfg = dict(self.config["model"])
        model_cfg["e_layers"] = tuple(model_cfg["e_layers"])
        self.cfg = InformerConfig(**model_cfg)
        module, name = self.config["entry"].split(":")
        cls = getattr(importlib.import_module(f"{PACKAGE}.{module}"), name)
        with torch.device("meta"):  # the weights are the benchmark's: none drawn here
            model = cls(self.cfg)
        model.to_empty(device=self.device)
        model.load_state_dict(self.weights, strict=True)
        self.model = model.eval()
        data = self.config["data"]
        self.dataset = WindowDataset(h=self.h, seq_len=self.cfg.seq_len,
                                     pred_len=self.cfg.pred_len, snr_db=data["snr_db"],
                                     device=self.device)
        self.state = None

    # -- training ----------------------------------------------------------

    def train_state(self, train: dict):
        from channelestimationtransformer_torch.core.config import TrainConfig
        from channelestimationtransformer_torch.train.trainer import create_train_state

        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        tc = TrainConfig(**{k: v for k, v in train.items() if k in fields})
        self.state = create_train_state(self.model, tc)
        group = self.state.optimizer.param_groups[0]
        if tuple(group["betas"]) != tuple(train["betas"]) or group["eps"] != train["eps"]:
            raise ValueError(f"the program's Adam takes betas {group['betas']} and eps "
                             f"{group['eps']}; the configuration states {train['betas']} and "
                             f"{train['eps']}")
        return self.state

    def train_chunk(self, num_steps: int, batch: int, generator: torch.Generator):
        """``num_steps`` training steps; the summed loss as a device tensor."""
        from channelestimationtransformer_torch.train.trainer import train_chunk

        return train_chunk(self.state, self.dataset, num_steps=num_steps, batch_size=batch,
                           label_len=self.cfg.label_len, generator=generator)["loss_sum"]

    def first_gradients(self, beta1: float) -> dict:
        """Each parameter's gradient as Adam took it in the first update,
        from its first moment: ``exp_avg = (1 - beta1) g`` after one step."""
        opt = self.state.optimizer
        return {name: opt.state[p]["exp_avg"] / (1.0 - beta1) if "exp_avg" in opt.state[p]
                else torch.zeros_like(p)  # an optimizer that never stepped
                for name, p in self.model.named_parameters()}

    def parameters(self) -> dict:
        return dict(self.model.named_parameters())

    # -- serving -----------------------------------------------------------

    @torch.no_grad()
    def serve(self, batch: int, idx, starts, noise) -> torch.Tensor:
        """One request: the windows of the injected draws, formed by the
        port's batch maker, predicted by the model in eval mode (the path
        of the port's ``eval_step``, keeping the prediction)."""
        from channelestimationtransformer_torch.data.windows import make_batch

        self.model.eval()
        x_enc, x_dec, _ = make_batch(self.dataset, batch, self.cfg.label_len, idx=idx,
                                     starts=starts, noise=noise)
        out = self.model(x_enc, x_dec)
        return out[0] if isinstance(out, tuple) else out

    def free(self):
        """Drop the model, its optimizer state and the port's dataset view."""
        self.model = self.state = self.dataset = None


def launch_counts() -> dict:
    """The port's kernel wrappers' launch counters."""
    from channelestimationtransformer_torch.ops.cuda.bd_attention import (
        bd_attention_bwd,
        bd_attention_fwd,
    )
    from channelestimationtransformer_torch.ops.cuda.mha_attention import mha_attention_fwd

    counts = {"bd_fwd": bd_attention_fwd.launches, "bd_bwd": bd_attention_bwd.launches}
    for route, n in mha_attention_fwd.launches_by_route.items():
        counts[f"mha_{route}"] = n
    return counts


@contextlib.contextmanager
def switches(tf32: bool):
    """The TF32 switches (matmul and cuDNN) the configuration states, for
    the program's run; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
