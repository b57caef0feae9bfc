"""The port's training step against the JAX package's, on the CPU.

Weights go from the flax variable tree through ``utils/convert.py``; inputs
are made with numpy from a seed. Tolerances:

- model outputs, losses, BatchNorm statistics and gradients: rtol 2e-4 /
  atol 2e-5 (float32, sums taken in another order by XLA and by torch);
- the learning-rate schedule: rel 1e-6 / abs 1e-9 (optax evaluates it in
  float32, the port in float64);
- Adam and AdamW after three updates on the same gradients: rtol 1e-6 /
  atol 1e-7 (the same float32 update, rounded in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from channelestimationtransformer_tpu.core.config import TrainConfig as JaxTrainConfig
from channelestimationtransformer_tpu.models.encoder import ConvLayer as JaxConvLayer
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _apply as jax_apply
from channelestimationtransformer_tpu.train.trainer import _update as jax_update
from channelestimationtransformer_tpu.train.trainer import make_schedule as jax_make_schedule

from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.core.metrics import nmse, nmse_split
from channelestimationtransformer_torch.models import embed
from channelestimationtransformer_torch.models.dropout import dropout
from channelestimationtransformer_torch.models.encoder import ConvLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.train.trainer import (
    apply_gradients,
    create_train_state,
    make_schedule,
)
from channelestimationtransformer_torch.utils.convert import from_flax

from test_torch_informer import LONG, SMALL, _load_module, _model_pair, _variables

RTOL, ATOL = 2e-4, 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("length", [21, 12])
def test_convlayer_train_batchnorm_matches_flax(length):
    """Train-mode BatchNorm: output and updated running statistics against
    flax ``apply(..., mutable=["batch_stats"])``. At B·L = 2·length the
    unbiased update of ``nn.BatchNorm1d`` would miss flax's by ~0.1/(B·L)."""
    rng = np.random.default_rng(21)
    x = (2.0 * rng.normal(size=(2, length, 32)) + 0.5).astype(np.float32)
    fmod = JaxConvLayer(d_model=32)
    params, stats = _variables(fmod, rng, x)
    want, updates = fmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                               deterministic=False, mutable=["batch_stats"])
    want_stats = _np(updates["batch_stats"]["norm"])
    tmod = _load_module(ConvLayer(32), params, stats, "distil").train()
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod.norm.running_mean.numpy(), want_stats["mean"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tmod.norm.running_var.numpy(), want_stats["var"],
                               rtol=RTOL, atol=ATOL)
    # torch's own update (unbiased variance) is outside the tolerance here.
    ref = _load_module(ConvLayer(32), params, stats, "distil")
    bn = torch.nn.BatchNorm1d(32, eps=1e-5, momentum=0.1)
    bn.load_state_dict(ref.norm.state_dict())
    y = torch.nn.functional.conv1d(
        torch.nn.functional.pad(torch.from_numpy(x).transpose(1, 2), (1, 1), mode="circular"),
        ref.weight, ref.bias)
    bn.train()(y)
    assert not np.allclose(bn.running_var.detach().numpy(), want_stats["var"],
                           rtol=RTOL, atol=ATOL)


def _grad_recorder():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients as its state, so ``_update``'s gradients can be read."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _train_step_against_jax_update(cfg, *, jax_pallas, port_pallas, seed):
    """One training step of the whole InformerStack at dropout 0, batch 3:
    output, loss, split, updated BatchNorm statistics and every gradient
    against JAX ``_update`` (``train/trainer.py:119-137``) on the same
    batch. Returns the names of the BatchNorm statistics compared."""
    rng = np.random.default_rng(seed)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(
        rng, 3, jax_pallas=jax_pallas, port_pallas=port_pallas, **cfg)
    target = rng.normal(size=(3, cfg["pred_len"], 16)).astype(np.float32)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=_grad_recorder())
    key = jax.random.key(0)
    batch = tuple(map(jnp.asarray, (x_enc, x_dec, target)))
    new_state, metrics = jax.jit(jax_update)(state, *batch, key, key)
    want_out, _ = jax_apply(state, params, stats, *batch[:2], train=True,
                            rngs={"dropout": key, "sample": key})

    tmod.train()
    pred = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                generator=torch.Generator().manual_seed(0))
    t_target = torch.from_numpy(target)
    loss = nmse(pred, t_target)
    loss.backward()
    np.testing.assert_allclose(pred.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    np.testing.assert_allclose(nmse_split(pred.detach(), t_target).numpy(),
                               np.asarray(metrics["loss_split"]), rtol=RTOL)
    want = from_flax(_np(new_state.opt_state), _np(new_state.batch_stats))
    got_state = tmod.state_dict()
    stat_keys = [k for k in want if "running_" in k]
    for name in stat_keys:
        np.testing.assert_allclose(got_state[name].numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    names = [n for n, _ in tmod.named_parameters()]
    assert set(names) <= set(want)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    return stat_keys


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_jax_update(use_pallas):
    """The small config. With ``use_pallas`` the JAX side differentiates
    through the Pallas kernels in interpret mode and the port through its
    kernels' wrapper."""
    stat_keys = _train_step_against_jax_update(SMALL, jax_pallas=use_pallas,
                                               port_pallas=use_pallas, seed=8)
    assert len(stat_keys) == 2 * 2  # one distilling BatchNorm in each encoder


def test_long_wide_train_step_with_use_pallas_matches_jax_update():
    """seq_len 160, E 128 (``test_torch_informer.LONG``): with use_pallas in
    train mode every call falls to the port's full_attention, the JAX
    package's own training route for shapes its bd kernel does not take
    (``models/attention.py:332-345``); the JAX side runs XLA attention."""
    stat_keys = _train_step_against_jax_update(LONG, jax_pallas=False, port_pallas=True,
                                               seed=10)
    assert len(stat_keys) == 2  # one distilling BatchNorm, in the first encoder


def test_kernel_route_and_plain_route_share_dropout_masks():
    """In train mode with dropout, the kernel route (CPU: the kernels' plain
    versions) and the plain full_attention route draw the same masks from
    the same generator: equal outputs and gradients."""
    cfg = dict(SMALL, dropout=0.1)
    models = [build_informer(InformerConfig(use_pallas=p, **cfg), device="cpu", seed=1).train()
              for p in (True, False)]
    rng = np.random.default_rng(9)
    x_enc = torch.from_numpy(rng.normal(size=(3, SMALL["seq_len"], 16)).astype(np.float32))
    x_dec = torch.from_numpy(rng.normal(
        size=(3, SMALL["label_len"] + SMALL["pred_len"], 16)).astype(np.float32))
    outs = []
    for m in models:
        out = m(x_enc, x_dec, generator=torch.Generator().manual_seed(5))
        out.square().mean().backward()
        outs.append(out.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    for (name, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-6, msg=name)


SCHEDULES = [
    dict(num_epochs=3, steps_per_epoch=50, lr=1e-3, lr_min=1e-5),  # warmup 15, then cosine
    dict(num_epochs=2, steps_per_epoch=40, lr=1e-3, lr_min=1e-4, warmup_steps=0),  # cosine
    dict(num_epochs=2, steps_per_epoch=10, lr=1e-3, schedule="constant"),
    dict(num_epochs=1, steps_per_epoch=1, lr=1e-3),  # warmup >= total (trainer.py:53-57)
]


@pytest.mark.parametrize("kwargs", SCHEDULES)
def test_schedule_matches_jax_at_every_step(kwargs):
    port = make_schedule(TrainConfig(**kwargs))
    ref = jax_make_schedule(JaxTrainConfig(**kwargs))
    total = kwargs["num_epochs"] * kwargs["steps_per_epoch"]
    for step in range(total + 5):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-9), step


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_matches_optax_on_the_same_gradients(weight_decay):
    """Three updates of Adam (AdamW with weight decay) under the warmup
    schedule, fed the same gradients as optax's."""
    kwargs = dict(num_epochs=1, steps_per_epoch=30, lr=1e-2, weight_decay=weight_decay)
    rng = np.random.default_rng(22)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: (1e-2 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    sched = jax_make_schedule(JaxTrainConfig(**kwargs))
    tx = optax.adamw(sched, weight_decay=weight_decay) if weight_decay else optax.adam(sched)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    state = create_train_state(module, TrainConfig(**kwargs))
    assert isinstance(state.optimizer,
                      torch.optim.AdamW if weight_decay else torch.optim.Adam)
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        apply_gradients(state)
    assert state.step == 3
    for k, p in module.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_data_embedding_builds_its_position_table_once(monkeypatch):
    """``DataEmbedding.forward`` builds the sinusoid table once per
    (length, dtype, device) and reuses it: no host-to-device copy per call."""
    calls = []
    table = embed.sinusoid_position_encoding
    monkeypatch.setattr(embed, "sinusoid_position_encoding",
                        lambda *a, **k: calls.append(a) or table(*a, **k))
    emb = embed.DataEmbedding(16, 32)
    x = torch.randn(2, 20, 16)
    first = emb(x)
    assert torch.equal(emb(x), first) and len(calls) == 1
    emb(torch.randn(3, 15, 16))
    emb(torch.randn(1, 20, 16))
    assert [a[0] for a in calls] == [20, 15]


def test_dropout_draws_from_its_generator():
    x = torch.randn(64, 90, 128)
    p = 0.05
    out = dropout(x, p, torch.Generator().manual_seed(0), True)
    assert torch.equal(out, dropout(x, p, torch.Generator().manual_seed(0), True))
    kept = out != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(out[kept], x[kept] / (1 - p), rtol=1e-6, atol=0.0)
    assert dropout(x, p, None, False) is x and dropout(x, 0.0, None, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p, None, True)
