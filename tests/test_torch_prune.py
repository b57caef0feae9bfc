"""Structured pruning in the port against the JAX package's, on the CPU.

The port's weights are laid out ``[out, in]`` (dense) and ``[C_out, C_in,
K]`` (conv) where flax's kernels are ``[in, out]`` and ``[K, C_in, C_out]``,
so every score and mask here is compared with JAX's transposed (permuted),
and exactly: the scores are the same four float32 magnitudes added in the
same order, and the threshold is the same sorted element. The sparsity
arrives as a traced float32, as the JAX driver passes it.

- ``block_scores`` and ``block_magnitude_mask`` with an input dim that is
  not a multiple of 4 and on a conv kernel; ``snip_scores``;
- ``apply_pruning`` on a small InformerStack's weights (each shape in one
  batch) and ``measured_sparsity``, against JAX's on the flax tree;
- the prune driver's ramp equal to the committed JAX run's ``sparsity``
  column, and its ``measured_sparsity`` column equal to the block count
  the flagship's 72 weights give at each level;
- one prune step (``_update`` with Adam at lr 1e-4, then ``apply_pruning``)
  against JAX's, at the training tests' rtol 2e-4 / atol 2e-5, with the
  Adam state kept on the same ``Parameter`` objects.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from channelestimationtransformer_tpu.core.config import TrainConfig as JaxTrainConfig
from channelestimationtransformer_tpu.ops import prune as jprune
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update
from channelestimationtransformer_tpu.train.trainer import make_schedule as jax_make_schedule

from channelestimationtransformer_torch.cli import prune as prune_cli
from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.ops import prune as tprune
from channelestimationtransformer_torch.ops.quant import QUANT_KERNEL_MARKERS, assign_
from channelestimationtransformer_torch.train.trainer import _update, create_train_state
from channelestimationtransformer_torch.utils.convert import from_flax

from test_torch_cli import ROOT
from test_torch_informer import SMALL, _model_pair

RTOL, ATOL = 2e-4, 2e-5
SPARSITIES = (0.0, 0.087, 0.3, 0.5, 0.9, 0.9999)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread here: these tests run many small ops, which the
    default intra-op pool slows several-fold when the machine is shared (as
    under pytest-xdist's workers); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_jax_apply_pruning = jax.jit(lambda p, s: jprune.apply_pruning(p, s))  # one trace a shape


def _jax_mask(kernel, sparsity):
    return np.asarray(jax.jit(lambda w, s: jprune.block_magnitude_mask(w, s))(
        jnp.asarray(kernel), jnp.float32(sparsity)))


def _dense(rng, n_in, n_out):
    """A port dense weight ``[out, in]`` and its flax kernel ``[in, out]``,
    with repeated magnitudes (ties between blocks)."""
    w = np.round(rng.normal(size=(n_out, n_in)) * 8).astype(np.float32) / 8
    return w, np.ascontiguousarray(w.T)


def _conv(rng, c_out, c_in, k):
    w = rng.normal(size=(c_out, c_in, k)).astype(np.float32)
    return w, np.ascontiguousarray(w.transpose(2, 1, 0))


@pytest.mark.parametrize("n_in", [16, 13, 6])
def test_dense_scores_and_masks_match_jax_transposed(n_in):
    rng = np.random.default_rng(n_in)
    w, kernel = _dense(rng, n_in, 12)
    scores = tprune.block_scores(torch.from_numpy(w))
    np.testing.assert_array_equal(scores.numpy(), np.asarray(jprune.block_scores(kernel)).T)
    for s in SPARSITIES:
        mask = tprune.block_magnitude_mask(torch.from_numpy(w), s)
        assert mask.shape == w.shape and mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), _jax_mask(kernel, s).T, err_msg=str(s))


def test_conv_scores_and_masks_match_jax_permuted():
    """A conv kernel, flax ``[K, C_in, C_out]`` flattened K-major: the
    port's ``[C_out, C_in, K]`` through ``permute(2, 1, 0)``; C_in 5 so the
    blocks straddle two taps."""
    w, kernel = _conv(np.random.default_rng(3), 6, 5, 3)
    assert torch.equal(tprune.flax_matrix(torch.from_numpy(w)),
                       torch.from_numpy(kernel.reshape(-1, 6)))
    np.testing.assert_array_equal(tprune.block_scores(torch.from_numpy(w)).numpy(),
                                  np.asarray(jprune.block_scores(kernel)).T)
    for s in SPARSITIES:
        mask = tprune.block_magnitude_mask(torch.from_numpy(w), s).numpy()
        np.testing.assert_array_equal(mask.transpose(2, 1, 0), _jax_mask(kernel, s), str(s))


def test_one_dim_weights_and_snip_scores():
    b = torch.tensor([0.5, -2.0, 0.0])
    assert torch.equal(tprune.block_scores(b), b.abs())
    assert tprune.block_magnitude_mask(b, 0.9).all()
    rng = np.random.default_rng(4)
    w, g = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(tprune.snip_scores(torch.from_numpy(w), torch.from_numpy(g)),
                                  np.asarray(jprune.snip_scores(jnp.asarray(w), jnp.asarray(g))))


@pytest.fixture(scope="module")
def model_pair():
    _, tmod, params, stats, _, _ = _model_pair(np.random.default_rng(7), 1, **SMALL)
    return tmod, params, stats


@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_apply_pruning_matches_jax_on_a_model(sparsity, model_pair):
    """Every tensor of the small InformerStack after ``apply_pruning`` (the
    matched weights of each shape in one batch) equals JAX's through
    from_flax, and so does ``measured_sparsity``; the others are the same
    objects."""
    tmod, params, stats = model_pair
    jparams = _jax_apply_pruning(params, jnp.float32(sparsity))
    want = from_flax(jax.tree.map(np.asarray, jparams), stats)
    tparams = dict(tmod.named_parameters())
    got = tprune.apply_pruning(tparams, sparsity)
    for name, value in got.items():
        assert torch.equal(value, want[name]), name
    matched = [n for n in tparams if any(n.endswith(m) for m in QUANT_KERNEL_MARKERS)]
    assert all(got[n] is tparams[n] for n in tparams if n not in matched or sparsity == 0)
    assert tprune.measured_sparsity(got) == jprune.measured_sparsity(jparams)


def test_apply_pruning_takes_its_markers_and_prunes_convs():
    """Markers are an argument: a conv weight matched by one is pruned as
    JAX prunes its flax kernel."""
    w, kernel = _conv(np.random.default_rng(8), 8, 4, 3)
    got = tprune.apply_pruning({"block.conv.weight": torch.from_numpy(w),
                                "block.conv.bias": torch.ones(8)}, 0.5, markers=("conv.weight",))
    want = np.asarray(jprune.apply_pruning({"block": {"conv": {"kernel": jnp.asarray(kernel)}}},
                                           0.5, markers=("conv/kernel",))["block"]["conv"]["kernel"])
    np.testing.assert_array_equal(got["block.conv.weight"].numpy().transpose(2, 1, 0), want)
    assert torch.equal(got["block.conv.bias"], torch.ones(8))


def _ramp(epochs=50, steps=226, target=0.9):
    args = prune_cli.build_parser().parse_args(
        ["--epochs", str(epochs), "--steps-per-epoch", str(steps), "--target-sparsity",
         str(target)])
    return [prune_cli.epoch_sparsity(e, args) for e in range(epochs)]


def test_the_ramp_and_measured_sparsity_are_the_jax_runs():
    """The committed JAX run (``experiments/artifacts/prune_results.json``,
    50 epochs of 226 steps to 0.9): its ``sparsity`` column is the port's
    ramp, and its ``measured_sparsity`` column is what the block count gives
    at each level: k + 1 of each weight's blocks zeroed (k the threshold
    index), over the flagship's 52 weights of 4,096 blocks and 20 of 2,048,
    4 elements a block. So the JAX run met no tie at its thresholds."""
    rows = json.loads((ROOT / "experiments/artifacts/prune_results.json").read_text())
    ramp = _ramp()
    assert [r["sparsity"] for r in rows] == ramp
    assert ramp == [round(jprune.cubic_sparsity_schedule(e * 226, target=0.9, start_step=0,
                                                         end_step=int(50 * 226 * 0.6)), 4)
                    for e in range(50)]
    model = build_informer(InformerConfig(), device="cpu")
    shapes = [tuple(w.shape) for n, w in model.named_parameters()
              if any(n.endswith(m) for m in QUANT_KERNEL_MARKERS)]
    blocks = [int(np.prod(s)) // 4 for s in shapes]
    assert sorted(set(blocks)) == [2048, 4096] and blocks.count(4096) == 52 and len(blocks) == 72
    total = 4 * sum(blocks)
    for r, s in zip(rows, ramp):
        pruned = 0 if s <= 0 else sum(int(np.float32(s) * np.float32(n - 1)) + 1 for n in blocks)
        assert 4 * pruned / total == r["measured_sparsity"], r["epoch"]


def test_cubic_schedule_matches_jax():
    for step in (0, 1, 100, 3389, 6779, 6780, 7000, 11299):
        assert tprune.cubic_sparsity_schedule(step, target=0.9, end_step=6780) == \
            jprune.cubic_sparsity_schedule(step, target=0.9, end_step=6780)
    assert tprune.cubic_sparsity_schedule(5, initial=0.2, start_step=5) == 0.2


def test_prune_step_matches_jax():
    """``_update`` (Adam, lr 1e-4 on the driver's schedule) then
    ``apply_pruning`` at 0.5 written into the parameters, against JAX's
    step and ``apply_pruning``; Adam's state stays on the same objects."""
    rng = np.random.default_rng(60)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 3, **SMALL)
    target = rng.normal(size=(3, SMALL["pred_len"], 16)).astype(np.float32)
    kw = dict(lr=1e-4, num_epochs=2, steps_per_epoch=10)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=optax.adam(jax_make_schedule(JaxTrainConfig(**kw))))
    key = jax.random.key(0)
    state, _ = jax.jit(jax_update)(state, *map(jnp.asarray, (x_enc, x_dec, target)), key, key)
    jparams = jprune.apply_pruning(state.params, jnp.float32(0.5))
    want = from_flax(jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, state.batch_stats))

    tstate = create_train_state(tmod, TrainConfig(**kw))
    _update(tstate, *map(torch.from_numpy, (x_enc, x_dec, target)), torch.Generator())
    tparams = dict(tmod.named_parameters())
    adam = {n: tstate.optimizer.state[p] for n, p in tparams.items()}
    with torch.no_grad():
        assign_(tparams, tprune.apply_pruning(tparams, 0.5))
    assert all(a is b for a, b in zip(tparams.values(), tmod.parameters()))
    for name, p in tparams.items():
        assert tstate.optimizer.state[p] is adam[name]
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert tprune.measured_sparsity(tparams) == pytest.approx(
        jprune.measured_sparsity(jparams), abs=1e-3)
