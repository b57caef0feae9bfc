"""The plain reference of the InformerStack channel predictor, in float32.

Written from the published architecture (Informer, Zhou et al., AAAI 2021,
arXiv:2012.07436) as the reference repository's FullPrecision experiment
runs it (github.com/Bart-Hodes/ChannelEstimationTransformer,
``models/Informer``): circular-conv token embedding and sinusoid positions;
an encoder stack whose encoder ``i`` reads the last ``L // 2**i`` slots,
post-norm layers of full attention and a two-layer GELU (tanh) FFN, a
distilling conv (circular conv, BatchNorm, ELU, max-pool 3/2/1) between
layers; a decoder of causal self-attention (heads interleaved with the
sequence, the reference's ``mix``), cross-attention and FFN; a dense
projection. Dropout follows every embedding, attention probability,
attention output and FFN layer. LayerNorm eps is flax's 1e-6.

The loss is the NMSE, the optimizer Adam (torch's update rule) under a
linear warm-up then cosine schedule, the batch the noisy channel windows of
the reference's ``SeqData``: each sample normalised to unit complex RMS,
AWGN at the configured SNR, the window sliced out, the decoder fed the last
``label_len`` noisy slots then zeros.

Every product goes through :class:`Precision`, so the same code runs as the
reference (float32, TF32 off) and as the control of the comparison (TF32 on,
or every product's operands rounded to float8 e4m3 with a per-tensor
scale). This module imports nothing of the program under test.

Randomness: a training step draws, in this order and with these calls, from
the step's generator: the sample indices, the window starts and the noise of
the batch; then, through the forward in module order, one Bernoulli mask a
dropout layer and one int64 seed an attention call, whose keep mask is
:func:`philox.keep_mask`. The program documents the same draws, so the same
generator seed gives both sides the same batch and the same masks.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import philox

LN_EPS = 1e-6
BN_EPS = 1e-5
FP8_MAX = 448.0  # float8 e4m3's largest finite value

MODES = ("float32", "tf32", "fp8")


class Precision(contextlib.ContextDecorator):
    """The precision of every product of the reference. Inside the block
    the TF32 switches (matmul and cuDNN) are set for the mode and restored
    on exit, so code outside runs under its own settings."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"precision mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self._saved: list = []

    def __enter__(self):
        self._saved.append((torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32))
        torch.backends.cuda.matmul.allow_tf32 = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = self.mode == "tf32"
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
            self._saved.pop()
        return False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand in this precision: as it is, or rounded to
        float8 e4m3 at the scale that maps its largest magnitude to 448
        (the gradient passes straight through the rounding)."""
        if self.mode != "fp8":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (rounded - x).detach()


def parameter_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter and BatchNorm statistic,
    named as the program's state dict names them. ``kind`` says how the
    benchmark draws it (``weights.py``)."""
    d, d_ff = cfg["d_model"], cfg["d_ff"]
    spec = []

    def dense(name, n_in, n_out):
        spec.append((f"{name}.weight", (n_out, n_in), "dense"))
        spec.append((f"{name}.bias", (n_out,), "bias"))

    def norm(name):
        spec.append((f"{name}.weight", (d,), "norm_weight"))
        spec.append((f"{name}.bias", (d,), "norm_bias"))

    def attention(name):
        for part in ("query", "key", "value", "out"):
            dense(f"{name}.{part}", d, d)

    def ffn(name):
        dense(f"{name}.conv1", d, d_ff)
        dense(f"{name}.conv2", d_ff, d)

    spec.append(("enc_embedding.token.weight", (d, cfg["enc_in"], 3), "conv_kaiming"))
    spec.append(("dec_embedding.token.weight", (d, cfg["dec_in"], 3), "conv_kaiming"))
    for i, n_layers in enumerate(cfg["e_layers"]):
        enc = f"encoder.encoder_{i}"
        for j in range(n_layers):
            attention(f"{enc}.layer_{j}.attention")
            ffn(f"{enc}.layer_{j}.ffn")
            norm(f"{enc}.layer_{j}.norm1")
            norm(f"{enc}.layer_{j}.norm2")
        for j in range(n_layers - 1 if cfg["distil"] else 0):
            spec.append((f"{enc}.distil_{j}.weight", (d, d, 3), "conv"))
            spec.append((f"{enc}.distil_{j}.bias", (d,), "bias"))
            spec.append((f"{enc}.distil_{j}.norm.weight", (d,), "norm_weight"))
            spec.append((f"{enc}.distil_{j}.norm.bias", (d,), "norm_bias"))
            spec.append((f"{enc}.distil_{j}.norm.running_mean", (d,), "running_mean"))
            spec.append((f"{enc}.distil_{j}.norm.running_var", (d,), "running_var"))
            spec.append((f"{enc}.distil_{j}.norm.num_batches_tracked", (), "count"))
        norm(f"{enc}.norm")
    for i in range(cfg["d_layers"]):
        layer = f"decoder.layer_{i}"
        attention(f"{layer}.self_attention")
        attention(f"{layer}.cross_attention")
        ffn(f"{layer}.ffn")
        for k in (1, 2, 3):
            norm(f"{layer}.norm{k}")
    norm("decoder.norm")
    dense("projection", d, cfg["c_out"])
    return spec


def trainable(spec) -> list[str]:
    """Names of the parameters (BatchNorm statistics are not)."""
    return [name for name, _, kind in spec if kind not in ("running_mean", "running_var", "count")]


# -- layers --------------------------------------------------------------


def _dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, dtype=torch.float32, device=x.device).bernoulli_(
        keep, generator=gen)
    return x / keep * mask


def _linear(x, P, name, prec):
    return torch.matmul(prec.q(x), prec.q(P[f"{name}.weight"]).t()) + P[f"{name}.bias"]


def _circular_conv(x, w, b, prec):
    """``[B, L, C_in]`` -> ``[B, L, C_out]``, kernel 3, circular padding, as
    one product of the three shifted windows with the flattened kernel
    (float32 convolutions outside the tensor cores are slow on the card)."""
    length = x.shape[1]
    xt = F.pad(x.transpose(1, 2), (1, 1), mode="circular")  # [B, C_in, L + 2]
    cols = torch.stack([xt[..., k:k + length] for k in range(3)], dim=-1)  # [B, C_in, L, 3]
    cols = cols.permute(0, 2, 1, 3).reshape(x.shape[0], length, -1)  # [B, L, C_in * 3]
    y = torch.matmul(prec.q(cols), prec.q(w).reshape(w.shape[0], -1).t())
    return y if b is None else y + b


def _layer_norm(x, P, name):
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], LN_EPS)


def position_table(length: int, d_model: int, device) -> torch.Tensor:
    """Interleaved sin / cos positions ``[length, d_model]``, built in
    float64 and rounded to float32."""
    position = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.as_tensor(pe, dtype=torch.float32, device=device)


def _embedding(x, P, name, cfg, prec, gen):
    tok = _circular_conv(x, P[f"{name}.token.weight"], None, prec)
    tok = tok + position_table(x.shape[1], cfg["d_model"], x.device)
    return _dropout(tok, cfg["dropout"], gen)


def _attention(xq, xkv, P, name, cfg, prec, gen, *, causal, mix):
    b, l, _ = xq.shape
    s = xkv.shape[1]
    h = cfg["n_heads"]
    q = _linear(xq, P, f"{name}.query", prec).unflatten(-1, (h, -1))
    k = _linear(xkv, P, f"{name}.key", prec).unflatten(-1, (h, -1))
    v = _linear(xkv, P, f"{name}.value", prec).unflatten(-1, (h, -1))
    scores = torch.einsum("blhe,bshe->bhls", prec.q(q), prec.q(k))
    if causal:
        mask = torch.ones(l, s, dtype=torch.bool, device=xq.device).triu(1)
        scores = scores.masked_fill(mask, -math.inf)
    a = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
    rate = cfg["dropout"]
    if gen is not None and rate > 0.0:
        keep = philox.keep_mask(philox.draw_seed(gen, xq.device), b, h, l, s, 1.0 - rate)
        a = torch.where(keep, a / (1.0 - rate), 0.0)
    out = torch.einsum("bhls,bshd->blhd", prec.q(a), prec.q(v))
    if mix:  # the reference's heads interleaved with the sequence
        out = out.transpose(1, 2)
    return _linear(out.reshape(b, l, -1), P, f"{name}.out", prec)


def _ffn(x, P, name, cfg, prec, gen):
    y = F.gelu(_linear(x, P, f"{name}.conv1", prec), approximate="tanh")
    y = _dropout(y, cfg["dropout"], gen)
    return _dropout(_linear(y, P, f"{name}.conv2", prec), cfg["dropout"], gen)


def _encoder_layer(x, P, name, cfg, prec, gen):
    new_x = _attention(x, x, P, f"{name}.attention", cfg, prec, gen, causal=False, mix=False)
    x = _layer_norm(x + _dropout(new_x, cfg["dropout"], gen), P, f"{name}.norm1")
    return _layer_norm(x + _ffn(x, P, f"{name}.ffn", cfg, prec, gen), P, f"{name}.norm2")


def _distil(x, P, name, prec, train):
    y = _circular_conv(x, P[f"{name}.weight"], P[f"{name}.bias"], prec).transpose(1, 2)
    if train:  # batch statistics, biased variance
        mean = y.mean(dim=(0, 2))
        var = torch.clamp_min(torch.square(y).mean(dim=(0, 2)) - torch.square(mean), 0.0)
    else:
        mean, var = P[f"{name}.norm.running_mean"], P[f"{name}.norm.running_var"]
    y = ((y - mean[:, None]) * torch.rsqrt(var + BN_EPS)[:, None]
         * P[f"{name}.norm.weight"][:, None] + P[f"{name}.norm.bias"][:, None])
    y = F.max_pool1d(F.elu(y), kernel_size=3, stride=2, padding=1)
    return y.transpose(1, 2)


def _encoder_stack(x, P, cfg, prec, gen, train):
    outs = []
    length = x.shape[1]
    for i, n_layers in enumerate(cfg["e_layers"]):
        y = x[:, length - length // 2**i:]
        for j in range(n_layers):
            y = _encoder_layer(y, P, f"encoder.encoder_{i}.layer_{j}", cfg, prec, gen)
            if cfg["distil"] and j < n_layers - 1:
                y = _distil(y, P, f"encoder.encoder_{i}.distil_{j}", prec, train)
        outs.append(_layer_norm(y, P, f"encoder.encoder_{i}.norm"))
    return torch.cat(outs, dim=1)


def _decoder(x, cross, P, cfg, prec, gen):
    rate = cfg["dropout"]
    for i in range(cfg["d_layers"]):
        name = f"decoder.layer_{i}"
        a = _attention(x, x, P, f"{name}.self_attention", cfg, prec, gen, causal=True,
                       mix=cfg["mix"])
        x = _layer_norm(x + _dropout(a, rate, gen), P, f"{name}.norm1")
        a = _attention(x, cross, P, f"{name}.cross_attention", cfg, prec, gen, causal=False,
                       mix=False)
        x = _layer_norm(x + _dropout(a, rate, gen), P, f"{name}.norm2")
        x = _layer_norm(x + _ffn(x, P, f"{name}.ffn", cfg, prec, gen), P, f"{name}.norm3")
    return _layer_norm(x, P, "decoder.norm")


def forward(P: dict, cfg: dict, x_enc, x_dec, *, prec: Precision, gen=None,
            train: bool = False) -> torch.Tensor:
    """The prediction ``[B, pred_len, c_out]``. ``train``: BatchNorm on the
    batch's statistics; ``gen``: every dropout drawn from it (None: none)."""
    enc = _encoder_stack(_embedding(x_enc, P, "enc_embedding", cfg, prec, gen), P, cfg, prec,
                         gen, train)
    dec = _decoder(_embedding(x_dec, P, "dec_embedding", cfg, prec, gen), enc, P, cfg, prec,
                   gen)
    return _linear(dec, P, "projection", prec)[:, -cfg["pred_len"]:, :]


# -- data, loss, optimizer -------------------------------------------------


def draw_batch(gen, num_samples: int, slots: int, length: int, batch: int, features: int,
               device):
    """A batch's draws from ``gen``: sample indices, window starts, noise."""
    idx = torch.randint(0, num_samples, (batch,), generator=gen, device=device)
    starts = torch.randint(0, slots - length + 1, (batch,), generator=gen, device=device)
    noise = torch.randn((batch, slots, features), generator=gen, device=device)
    return idx, starts, noise


def _complex_rms(x):
    return torch.sqrt(2.0 * torch.mean(torch.square(x), dim=(1, 2), keepdim=True))


def make_batch(h, cfg: dict, idx, starts, noise):
    """``(enc_in, dec_in, target)`` of the windows ``(idx, starts)`` of the
    dataset ``h`` ``[N, slots, F]`` with the standard-normal ``noise``."""
    seq_len, pred_len = cfg["seq_len"], cfg["pred_len"]
    samples = h[idx]
    samples = samples / _complex_rms(samples)
    sigma = 10.0 ** (-cfg["snr_db"] / 10.0)
    noisy = samples + math.sqrt(sigma / 2.0) * noise * _complex_rms(samples)
    pos = starts[:, None] + torch.arange(seq_len + pred_len, device=h.device)[None, :]
    pos = pos[:, :, None].expand(-1, -1, h.shape[-1])
    enc_in = torch.gather(noisy, 1, pos)[:, :seq_len]
    target = torch.gather(samples, 1, pos)[:, seq_len:]
    zeros = enc_in.new_zeros((enc_in.shape[0], pred_len, enc_in.shape[2]))
    dec_in = torch.cat([enc_in[:, seq_len - cfg["label_len"]:], zeros], dim=1)
    return enc_in, dec_in, target


def nmse(pred, target):
    return torch.sum(torch.square(target - pred)) / torch.sum(torch.square(target))


def learning_rate(count: int, train: dict) -> float:
    """The rate of update ``count`` (0 first): linear from lr / 100 to lr
    over the warm-up, then cosine decay to ``lr_min`` at the last step."""
    lr = train["lr"]
    if train["schedule"] == "constant":
        return lr
    total = max(train["num_epochs"], 1) * train["steps_per_epoch"]
    warmup = min(train["warmup_steps"], max(total // 10, 1))
    if warmup >= total:
        total = warmup + 1
    if warmup > 0 and count < warmup:
        return (lr * 1e-2 - lr) * (1.0 - max(count, 0) / warmup) + lr
    span = total - warmup if warmup > 0 else total
    alpha = train["lr_min"] / lr if lr else 0.0
    c = min(count - warmup if warmup > 0 else count, span)
    return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / span)) + alpha)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def train_steps(P0: dict, cfg: dict, train: dict, h, generators, prec: Precision) -> dict:
    """Steps of the training loop from the weights ``P0``, one a generator:
    each draws its batch and masks from its generator, takes the NMSE, its
    gradient and an Adam update. Returns each step's loss, each parameter's
    first gradient norm and each parameter's change norm after the last
    step."""
    names = trainable(parameter_spec(cfg))
    params = {n: P0[n].detach().clone().float() for n in names}
    stats = {n: t for n, t in P0.items() if n not in params}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = train["betas"][0], train["betas"][1], train["eps"]
    n_samples, slots, features = h.shape
    losses, grad_norms = [], None
    with prec:
        for t, gen in enumerate(generators, start=1):
            idx, starts, noise = draw_batch(gen, n_samples, slots,
                                            cfg["seq_len"] + cfg["pred_len"], train["batch"],
                                            features, h.device)
            x_enc, x_dec, target = make_batch(h, cfg, idx, starts, noise)
            leaves = {n: p.requires_grad_(True) for n, p in params.items()}
            pred = forward({**leaves, **stats}, cfg, x_enc, x_dec, prec=prec, gen=gen,
                           train=True)
            loss = nmse(pred, target)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {n: _norm(g) for n, g in zip(names, grads)}
            lr = learning_rate(t - 1, train)
            with torch.no_grad():
                for n, g in zip(names, grads):
                    m[n].lerp_(g, 1.0 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1.0 - b2**t)).add_(eps)
                    params[n] = params[n].detach().addcdiv(m[n], denom,
                                                           value=-lr / (1.0 - b1**t))
            del pred, loss, grads, leaves
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {n: _norm(params[n] - P0[n].float()) for n in names}}


@torch.no_grad()
def predict(P: dict, cfg: dict, h, idx, starts, noise, prec: Precision) -> torch.Tensor:
    """The eval-mode prediction of one request's windows."""
    x_enc, x_dec, _ = make_batch(h, cfg, idx, starts, noise)
    with prec:
        return forward(P, cfg, x_enc, x_dec, prec=prec)


def flops_per_sample(cfg: dict, train: bool) -> float:
    """FLOPs of one window by ``FlopCounterMode`` (matmuls and convolutions)
    on meta tensors: the forward, and for training the backward with it."""
    from torch.utils.flop_counter import FlopCounterMode

    spec = parameter_spec(cfg)
    dev = torch.device("meta")
    P = {n: torch.empty(s, device=dev, dtype=torch.int64 if k == "count" else torch.float32)
         for n, s, k in spec}
    for n in trainable(spec):
        P[n].requires_grad_(train)
    x_enc = torch.empty(1, cfg["seq_len"], cfg["enc_in"], device=dev)
    x_dec = torch.empty(1, cfg["label_len"] + cfg["pred_len"], cfg["dec_in"], device=dev)
    counter = FlopCounterMode(display=False)
    with counter, torch.set_grad_enabled(train):
        pred = forward(P, cfg, x_enc, x_dec, prec=Precision("float32"), train=train)
        if train:
            pred.sum().backward()
    return float(counter.get_total_flops())
