"""The port's parallelism (``channelestimationtransformer_torch/parallel/``,
``train_chunk_dp``, ``attn="ring"``) against the JAX package's on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``. torch has
no virtual devices, so the port runs as real processes: gloo ranks of
``tests/torch_parallel_worker.py``, one thread each, every group joined
with a timeout of its own (``parallel/launch.py:run_local``). Weights and
inputs go to the ranks through a file; their outputs come back the same
way. Tolerances:

- ring attention, the ring Informer: JAX's own rtol 2e-4 / atol 2e-5
  (``tests/test_parallel.py``);
- the data-parallel step: ``tests/test_torch_training.py``'s step
  tolerance, rtol 2e-4 / atol 2e-5, on the gradients, the parameters after
  an SGD step at lr 1 and the BatchNorm statistics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.attention import full_attention as jax_full_attention
from channelestimationtransformer_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from channelestimationtransformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from channelestimationtransformer_tpu.parallel.mesh import (
    replicate_sharding as jax_replicate_sharding,
)
from channelestimationtransformer_tpu.parallel.ring import ring_attention as jax_ring_attention
from channelestimationtransformer_tpu.parallel.sharding import (
    infer_param_spec as jax_infer_param_spec,
)
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models.attention import AttentionLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.parallel.ring import ring_attention
from channelestimationtransformer_torch.utils.convert import FlaxBridge, _join, from_flax

from test_torch_informer import SMALL, _variables
from test_torch_training import _grad_recorder
from torch_parallel_worker import spawn

RTOL, ATOL = 2e-4, 2e-5
# JAX test_ring_informer_matches_full's config.
RING_CFG = dict(seq_len=32, label_len=8, pred_len=5, d_model=32, n_heads=4, e_layers=(2,),
                d_layers=1, d_ff=16, distil=False, dropout=0.0)
DP_RANKS, DP_PER_RANK = 4, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ring_qkv(p, seed):
    """JAX test_ring_attention_matches_dense's inputs at P ranks: [2, 8P, 2, 16]."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 8 * p, 2, 16)).astype(np.float32) for _ in range(3)]


def _dp_inputs():
    """SMALL (distil on, dropout 0) with perturbed flax weights, and a global
    batch of 8 whose four rank parts differ in scale and offset (inputs) and
    in power (targets), so per-rank statistics and per-rank NMSEs are far
    from the global batch's."""
    rng = np.random.default_rng(30)
    n = DP_RANKS * DP_PER_RANK
    part = np.repeat(np.arange(DP_RANKS), DP_PER_RANK)[:, None, None].astype(np.float32)
    x_enc = (rng.normal(size=(n, SMALL["seq_len"], 16)) * (0.5 + 0.5 * part)
             + 0.3 * part).astype(np.float32)
    x_dec = rng.normal(size=(n, SMALL["label_len"] + SMALL["pred_len"], 16)).astype(np.float32)
    target = (rng.normal(size=(n, SMALL["pred_len"], 16)) * (1.0 + part)).astype(np.float32)
    fmod = jax_build_informer(JaxInformerConfig(**SMALL))
    params, stats = _variables(fmod, rng, x_enc, x_dec)
    return fmod, params, stats, (x_enc, x_dec, target)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One group of 4 gloo ranks for every 4-rank case, and what the JAX
    side needs to check them."""
    ring_fmod = jax_build_informer(JaxInformerConfig(**RING_CFG))
    x_enc = np.random.default_rng(0).normal(size=(2, 32, 16)).astype(np.float32)
    x_dec = np.random.default_rng(1).normal(size=(2, 13, 16)).astype(np.float32)
    ring_vars = _np(jax.jit(ring_fmod.init)(jax.random.key(0), x_enc, x_dec))
    fmod, params, stats, batch = _dp_inputs()
    inputs = {
        "sharding_cfg": SMALL,
        "ring_qkv_4": [torch.from_numpy(t) for t in _ring_qkv(4, 4)],
        "ring_cfg": RING_CFG,
        "ring_state": from_flax(ring_vars["params"], ring_vars.get("batch_stats")),
        "ring_x_enc": torch.from_numpy(x_enc),
        "ring_x_dec": torch.from_numpy(x_dec),
        "dp_cfg": SMALL,
        "dp_state": from_flax(params, stats),
        "dp_batch": [torch.from_numpy(t) for t in batch],
        "dp_per_rank": DP_PER_RANK,
    }
    outs = spawn(tmp_path_factory.mktemp("four_ranks"),
                 ["mesh", "sharding", "ring", "ring_informer", "dp_update", "chunk_dp",
                  "chunk_dp_pallas"], DP_RANKS, inputs)
    return dict(outs=outs, inputs=inputs, ring_fmod=ring_fmod, ring_vars=ring_vars,
                dp=(fmod, params, stats, batch))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    inputs = {"ring_qkv_2": [torch.from_numpy(t) for t in _ring_qkv(2, 2)]}
    outs = spawn(tmp_path_factory.mktemp("two_ranks"), ["ring"], 2, inputs)
    return dict(outs=outs, inputs=inputs)


def test_make_mesh_shapes_and_errors(four_ranks):
    """JAX test_make_mesh_shapes on 4 ranks (checked in the ranks): the
    default mesh, data=2 x model=2, and JAX's errors for 3x5, model 3 and
    4x1x2, word for word."""
    errors = four_ranks["outs"][0]["mesh"]["errors"]
    assert errors == ["mesh 3x5x1 != 4 devices", "4 devices not divisible by model*seq=3",
                      "mesh 4x1x2 != 4 devices"]


class _TracingBridge(FlaxBridge):
    """A FlaxBridge that notes the flax leaf each port tensor came from."""

    def __init__(self, params, batch_stats=None):
        super().__init__(params, batch_stats)
        self.source, self._last = {}, None

    def _take(self, leaves, path, label):
        self._last = path
        return super()._take(leaves, path, label)

    def _set(self, path, name, value):
        super()._set(path, name, value)
        self.source[_join(path, name)] = self._last


def test_param_sharding_rules_match_jax(four_ranks):
    """Every parameter of the small InformerStack, through the weight
    bridge to its flax leaf: the port's placement at model=2 (from the
    ranks) is JAX ``infer_param_spec``'s spec for that leaf, with the
    port's dim 0 where JAX shards the last dim."""
    _, params, stats, _ = four_ranks["dp"]  # a flax InformerStack at SMALL
    bridge = _TracingBridge(params, stats)
    bridge.informer()
    leaves = dict(FlaxBridge(params).params)
    placements = four_ranks["outs"][0]["sharding"]["placements"]
    port = dict(build_informer(InformerConfig(**SMALL), device="cpu").named_parameters())
    assert set(placements) == set(port)
    sharded = 0
    for name, placement in placements.items():
        leaf = leaves[bridge.source[name]]
        spec = jax_infer_param_spec(tuple(bridge.source[name].split(".")), leaf, 2)
        if tuple(spec) == ():
            assert placement == "Replicate()", name
        else:
            assert tuple(spec) == (None,) * (leaf.ndim - 1) + ("model",), name
            assert placement == "Shard(0)", name
            assert port[name].shape[0] == leaf.shape[-1], name
            sharded += 1
    assert sharded > 0


def test_shard_params_gathers_back_to_the_parameters(four_ranks):
    """``shard_params`` on a data=2 x model=2 mesh: every DTensor's
    ``full_tensor()`` equals its parameter and a sharded one holds half the
    rows a rank (asserted in each rank; here, that all four ran it)."""
    assert all("sharding" in out for out in four_ranks["outs"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_attention_matches_jax(four_ranks, two_ranks, p, causal):
    """The port's ring on P gloo ranks against JAX ``ring_attention`` on a
    seq=P sub-mesh of the 8 virtual devices, on every rank's output, and
    both against dense attention."""
    group = four_ranks if p == 4 else two_ranks
    q, k, v = (jnp.asarray(t.numpy()) for t in group["inputs"][f"ring_qkv_{p}"])
    mesh = jax_make_mesh(data=1, model=1, seq=p, devices=jax.devices()[:p])
    want = np.asarray(jax_ring_attention(q, k, v, mesh, causal=causal))
    dense, _ = jax_full_attention(q, k, v, mask_flag=causal)
    np.testing.assert_allclose(want, np.asarray(dense), rtol=RTOL, atol=ATOL)
    for out in group["outs"]:
        np.testing.assert_allclose(out["ring"][causal].numpy(), want, rtol=RTOL, atol=ATOL)


def test_ring_informer_matches_flax_full(four_ranks):
    """JAX test_ring_informer_matches_full: ``attn="ring"`` with the flax
    ``attn="full"`` model's weights reproduces its output, here on 4 ranks."""
    want = jax.jit(four_ranks["ring_fmod"].apply)(
        four_ranks["ring_vars"], jnp.asarray(four_ranks["inputs"]["ring_x_enc"].numpy()),
        jnp.asarray(four_ranks["inputs"]["ring_x_dec"].numpy()))
    for out in four_ranks["outs"]:
        np.testing.assert_allclose(out["ring_informer"]["out"].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_global_step(four_ranks):
    """JAX ``_update`` on the concatenated batch under batch_sharding of a
    4-device mesh: (state after an SGD step at lr 1, gradients, metrics)."""
    fmod, params, stats, batch = four_ranks["dp"]
    mesh = jax_make_mesh(data=DP_RANKS, devices=jax.devices()[:DP_RANKS])
    sharded = [jax.device_put(jnp.asarray(t), jax_batch_sharding(mesh)) for t in batch]
    key = jax.random.key(0)
    results = []
    for tx in (optax.sgd(1.0), _grad_recorder()):
        state = jax.device_put(JaxTrainState.create(apply_fn=fmod.apply, params=params,
                                                    batch_stats=stats, tx=tx),
                               jax_replicate_sharding(mesh))
        results.append(jax.jit(jax_update)(state, *sharded, key, key))
    (stepped, metrics), (recorded, _) = results
    return (from_flax(_np(stepped.params), _np(stepped.batch_stats)),
            from_flax(_np(recorded.opt_state), _np(stats)), metrics)


def _misses(got, want):
    return any(not np.allclose(got[k].numpy(), want[k].numpy(), rtol=RTOL, atol=ATOL)
               for k in want)


def test_dp_update_matches_jax_update_on_the_global_batch(four_ranks, jax_global_step):
    """One DP ``_update`` on 4 gloo ranks, 2 windows each, distil on (two
    BatchNorms a stack): every rank's summed gradients, parameters after
    the step and BatchNorm statistics, and the global loss and split,
    against JAX ``_update`` on the concatenated batch."""
    want_state, want_grads, metrics = jax_global_step
    stat_keys = [k for k in want_state if "running_" in k]
    assert len(stat_keys) == 2 * 2
    for out in four_ranks["outs"]:
        dp = out["dp_update"]
        for name, g in dp["dp"]["grads"].items():
            np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        for name, t in dp["dp"]["state"].items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(t.numpy(), want_state[name].numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=name)
        np.testing.assert_allclose(dp["loss"], float(metrics["loss"]), rtol=RTOL)
        np.testing.assert_allclose(dp["split"].numpy(), np.asarray(metrics["loss_split"]),
                                   rtol=RTOL)


def test_dp_update_needs_global_statistics_and_the_global_loss(four_ranks, jax_global_step):
    """The power of the test above: the same step with per-rank BatchNorm
    statistics (DDP's default), and with the mean of per-rank NMSEs as the
    loss, each misses JAX's parameters by more than its tolerance."""
    want_state, _, _ = jax_global_step
    params = {k: v for k, v in want_state.items() if "running_" not in k
              and not k.endswith("num_batches_tracked")}
    stats = {k: v for k, v in want_state.items() if "running_" in k}
    dp = four_ranks["outs"][0]["dp_update"]
    assert not _misses(dp["dp"]["state"], params) and not _misses(dp["dp"]["state"], stats)
    assert _misses(dp["per_rank_batch_stats"]["state"], params)
    assert _misses(dp["per_rank_batch_stats"]["state"], stats)
    assert _misses(dp["mean_of_nmses"]["state"], params)


def test_train_chunk_dp_draws_from_each_rank_shard_and_learns(four_ranks):
    """The counterpart of JAX test_train_chunk_dp_per_shard_sampling: every
    step of every rank drew its 4 windows from that rank's shard and no
    other dataset (asserted in the ranks), the parameters and losses stayed
    the same on every rank, and the loss is finite and falls."""
    losses = four_ranks["outs"][0]["chunk_dp"]["losses"]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses
    assert all(out["chunk_dp"]["losses"] == losses for out in four_ranks["outs"])


def test_train_chunk_dp_with_use_pallas(four_ranks):
    """The counterpart of JAX test_train_chunk_dp_with_pallas_attention: the
    kernel route (on the CPU the bd kernels' plain versions) composes with
    the data-parallel chunk: loss finite, parameters replicated."""
    for out in four_ranks["outs"]:
        assert all(np.isfinite(out["chunk_dp_pallas"]["losses"]))


def test_ring_is_forward_only_and_needs_a_mesh():
    """Under autograd the ring raises, naming ROADMAP item 13, before it
    touches the mesh; an ``attn="ring"`` layer with no mesh raises as JAX's."""
    q = torch.randn(1, 4, 1, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        ring_attention(q, q, q, mesh=None)
    layer = AttentionLayer(8, 1, attn="ring")
    with torch.no_grad(), pytest.raises(ValueError, match="requires a mesh with a 'seq' axis"):
        layer(torch.randn(1, 4, 8), torch.randn(1, 4, 8), torch.randn(1, 4, 8))
