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
  an SGD step at lr 1 and the BatchNorm statistics;
- ring attention's dQ, dK, dV against ``jax.grad`` of JAX's ring, the ring
  Informer's step, the tensor-parallel forward and step: the same rtol
  2e-4 / atol 2e-5 (in the ranks too, against the port's replicated model);
- two axes (data 2 x model 2 against JAX ``_update`` on ``shard_params``'
  placements with the batch sharded on ``data``; model 2 x seq 2 and data
  2 x seq 2 against the replicated step), the LSQ-fibbinary step at model
  2 (``step_size`` gradients included), the baselines at model 2, and
  ``cli/multichip.py``'s three legs against ``__graft_entry__.py``'s at 4
  devices: the same rtol 2e-4 / atol 2e-5. Resuming a tensor-parallel
  ``Trainer`` from its gathered checkpoint: bit for bit, in the ranks.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import optax

from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from channelestimationtransformer_tpu.channel import beamforming as jbf
from channelestimationtransformer_tpu.channel import cdl as jcdl
from channelestimationtransformer_tpu.channel import dataset as jds
from channelestimationtransformer_tpu.core import config as jconfig
from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.core.config import TrainConfig as JaxTrainConfig
from channelestimationtransformer_tpu.core.metrics import nmse as jax_nmse
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.recurrent import RecurrentPredictor as JaxRecurrent
from channelestimationtransformer_tpu.models.transformer import Transformer as JaxTransformer
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
from channelestimationtransformer_tpu.parallel.sharding import (
    param_shardings as jax_param_shardings,
)
from channelestimationtransformer_tpu.parallel.sharding import shard_params as jax_shard_params
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update
from channelestimationtransformer_tpu.train.trainer import (
    create_train_state as jax_create_train_state,
)
from channelestimationtransformer_tpu.train.trainer import train_step as jax_train_step

from channelestimationtransformer_torch.cli import multichip
from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models.attention import AttentionLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.parallel.ring import ring_attention
from channelestimationtransformer_torch.utils import convert
from channelestimationtransformer_torch.utils.convert import FlaxBridge, _join, from_flax

from test_torch_channel import CHANNEL_TOL
from test_torch_informer import SMALL, _perturb, _variables
from test_torch_lsq import SMALL as LSQ_SMALL
from test_torch_lsq import _lsq_pair
from test_torch_training import _grad_recorder
from torch_parallel_worker import spawn

RTOL, ATOL = 2e-4, 2e-5
# JAX test_ring_informer_matches_full's config.
RING_CFG = dict(seq_len=32, label_len=8, pred_len=5, d_model=32, n_heads=4, e_layers=(2,),
                d_layers=1, d_ff=16, distil=False, dropout=0.0)
DP_RANKS, DP_PER_RANK = 4, 2
# The tensor-parallel cases: the flagship's structure (distil on, two
# encoders) at small widths, on 2 ranks (model axis 2).
TP_CFG = dict(seq_len=24, label_len=6, pred_len=5, d_model=32, n_heads=4, e_layers=(2, 1),
              d_layers=2, d_ff=32, dropout=0.0)
# The baselines at model 2 (2 ranks).
BASELINE_TCFG = dict(seq_len=12, label_len=4, pred_len=4, d_model=16, n_heads=2,
                     num_encoder_layers=2, num_decoder_layers=1, d_ff=32, dropout=0.0)
BASELINE_RCFG = dict(input_size=8, hidden_size=12, num_layers=2)
CELLS = ("lstm", "gru", "rnn")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ring_qkv(p, seed):
    """JAX test_ring_attention_matches_dense's inputs at P ranks: [2, 8P, 2, 16]."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 8 * p, 2, 16)).astype(np.float32) for _ in range(3)]


def _ring_cotangent(p, seed):
    """The output gradient of the ring gradient cases: [2, 8P, 2, 16]."""
    return np.random.default_rng(seed).normal(size=(2, 8 * p, 2, 16)).astype(np.float32)


def _tp_inputs(fused):
    """TP_CFG (fused or not) with perturbed flax weights, and a batch of 4
    (the same for both)."""
    rng = np.random.default_rng(40)
    x_enc = rng.normal(size=(4, TP_CFG["seq_len"], 16)).astype(np.float32)
    x_dec = rng.normal(size=(4, TP_CFG["label_len"] + TP_CFG["pred_len"], 16)).astype(np.float32)
    target = rng.normal(size=(4, TP_CFG["pred_len"], 16)).astype(np.float32)
    fmod = jax_build_informer(JaxInformerConfig(**TP_CFG, fuse_qkv=fused))
    params, stats = _variables(fmod, np.random.default_rng(41 + fused), x_enc, x_dec)
    return fmod, params, stats, (x_enc, x_dec, target)


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
    target = np.random.default_rng(2).normal(size=(2, 5, 16)).astype(np.float32)
    fmod, params, stats, batch = _dp_inputs()
    tp_fmod, tp_params, tp_stats, tp_batch = _tp_inputs(False)
    mc_inputs, mc_run = _multichip_jax(4)
    inputs = {
        "sharding_cfg": SMALL,
        "ring_qkv_4": [torch.from_numpy(t) for t in _ring_qkv(4, 4)],
        "ring_cot_4": torch.from_numpy(_ring_cotangent(4, 5)),
        "ring_cfg": RING_CFG,
        "ring_state": from_flax(ring_vars["params"], ring_vars.get("batch_stats")),
        "ring_x_enc": torch.from_numpy(x_enc),
        "ring_x_dec": torch.from_numpy(x_dec),
        "ring_batch": [torch.from_numpy(t) for t in (x_enc, x_dec, target)],
        "dp_cfg": SMALL,
        "dp_state": from_flax(params, stats),
        "dp_batch": [torch.from_numpy(t) for t in batch],
        "dp_per_rank": DP_PER_RANK,
        "tp_cfg": TP_CFG,
        "tp_state_False": from_flax(tp_params, tp_stats),
        "tp2d_batch": [torch.from_numpy(t) for t in tp_batch],
        **mc_inputs,
    }
    # The JAX dry run's legs compile while the ranks run.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            spawn, tmp_path_factory.mktemp("four_ranks"),
            ["mesh", "sharding", "ring", "ring_grad", "ring_informer", "ring_train", "dp_update",
             "chunk_dp", "chunk_dp_pallas", "dp_tp_update", "seq_axes", "trainer_2d_resume",
             "multichip"], DP_RANKS, inputs)
        mc = mc_run()
        outs = ranks.result()
    return dict(outs=outs, inputs=inputs, ring_fmod=ring_fmod, ring_vars=ring_vars,
                dp=(fmod, params, stats, batch), tp=(tp_fmod, tp_params, tp_stats, tp_batch),
                multichip=mc)


def _lsq_inputs():
    """The small LSQ-fibbinary stack with perturbed flax weights and step
    sizes (``tests/test_torch_lsq.py:_lsq_pair``), and a batch of 3."""
    rng = np.random.default_rng(44)
    _, fmod, params, stats, x_enc, x_dec = _lsq_pair(rng, True)
    target = rng.normal(size=(3, LSQ_SMALL["pred_len"], 16)).astype(np.float32)
    return fmod, params, stats, (x_enc, x_dec, target)


def _multichip_jax(n):
    """``__graft_entry__.py:dryrun_multichip``'s three legs on the first
    ``n`` virtual devices, as that file builds them, at dropout 0 in the
    training step (its inits jitted: the same values, sooner). Returns the
    ranks' inputs (each leg's weights, the window draws of the step: JAX's
    ``train_step`` keys them from ``key(1)``, ``make_batch``'s split, then
    ``sample_windows``', and the channel of the beam sweep) and a function
    that runs the legs and returns what the ranks are held to."""
    devices = jax.devices()[:n]
    m_axis = multichip.model_axis(n)
    mesh = jax_make_mesh(data=n // m_axis, model=m_axis, devices=devices)
    cfg = JaxInformerConfig(**multichip.TRAIN_CFG, dropout=0.0)
    tc = JaxTrainConfig(batch_size=2 * n, num_epochs=1, steps_per_epoch=4)
    model = jax_build_informer(cfg)
    state = jax.jit(lambda rng: jax_create_train_state(model, rng=rng, cfg=cfg, train_cfg=tc))(
        jax.random.key(0))
    init = from_flax(_np(state.params), _np(state.batch_stats))
    k_data = jax.random.split(jax.random.key(1), 3)[0]
    k_idx, k_start, k_noise = jax.random.split(k_data, 3)
    length = cfg.seq_len + cfg.pred_len
    draws = {"idx": np.array(jax.random.randint(k_idx, (2 * n,), 0, 2 * n)),
             "starts": np.array(jax.random.randint(k_start, (2 * n,), 0, 48 - length + 1)),
             "noise": np.array(jax.random.normal(k_noise, (2 * n, 48, 16)))}
    seq_mesh = jax_make_mesh(data=1, model=1, seq=n, devices=devices)
    rcfg = JaxInformerConfig(**multichip.ring_cfg(n))
    rmodel = jax_build_informer(rcfg, mesh=seq_mesh)
    x_enc = jnp.zeros((4, rcfg.seq_len, rcfg.enc_in), jnp.float32)
    x_dec = jnp.zeros((4, rcfg.dec_len, rcfg.dec_in), jnp.float32)
    rvars = jax.jit(rmodel.init)(jax.random.key(2), x_enc, x_dec)
    cdl_model = jcdl.CDLModel()
    hr = jcdl.generate_cdl_channel(jax.random.key(4), cdl_model, 2, 6)

    def run():
        repl = NamedSharding(mesh, P())
        placed = state.replace(
            params=jax.device_put(state.params, jax_param_shardings(state.params, mesh)),
            opt_state=jax.tree.map(lambda x: jax.device_put(x, repl), state.opt_state),
            batch_stats=jax.device_put(state.batch_stats, repl))
        h = np.random.default_rng(0).normal(size=(2 * n, 48, 16)).astype(np.float32)
        stepped, metrics = jax_train_step(
            placed, jax.device_put(jnp.asarray(h), NamedSharding(mesh, P("data"))),
            jax.random.key(1), batch_size=tc.batch_size, label_len=cfg.label_len,
            seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=20.0)
        ring_loss, ring_grads = jax.jit(jax.value_and_grad(
            lambda v, a, b: jnp.sum(rmodel.apply(v, a, b) ** 2)))(rvars, x_enc, x_dec)
        hgen = jds.generate_beamformed_dataset_sharded(
            jax.random.key(3), mesh, model=cdl_model, num_samples=n * 2 // m_axis, num_slots=8)
        h_eff, selected = jbf.beam_sweep_project_sharded(
            hr, jbf.dft_codebook_ri(cdl_model.num_bs_ant), 4,
            jax_make_mesh(data=1, model=n, devices=devices))
        # Adam's first moment after one step is (1 - b1) times the gradient.
        mu = from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1, stepped.opt_state[0].mu),
                       _np(stepped.batch_stats))
        return {
            "loss": float(metrics["loss"]),
            "state": from_flax(_np(stepped.params), _np(stepped.batch_stats)),
            "grads": {k: v for k, v in mu.items() if "running_" not in k
                      and not k.endswith("num_batches_tracked")},
            "ring_loss": float(ring_loss),
            "ring_grads": from_flax(_np(ring_grads["params"])),
            "dataset_shape": hgen.shape,
            "dataset_finite": bool(jnp.isfinite(hgen).all()),
            "h_eff": np.asarray(h_eff),
            "selected": np.asarray(selected),
        }

    inputs = {"mc_train_state": init,
              "mc_draws": {k: torch.from_numpy(v) for k, v in draws.items()},
              "mc_ring_state": from_flax(_np(rvars["params"])),
              "mc_h": torch.from_numpy(np.array(hr))}
    return inputs, run


def _baseline_inputs():
    """The Transformer and the LSTM, GRU and RNN predictors at
    BASELINE_TCFG / BASELINE_RCFG with perturbed flax weights, and their
    inputs (a batch of 3). Returns the flax modules, their params, the
    inputs as numpy and the ranks' inputs."""
    rng = np.random.default_rng(46)
    x = {k: rng.normal(size=shape).astype(np.float32) for k, shape in (
        ("x_enc", (3, 12, 16)), ("x_dec", (3, 8, 16)), ("target", (3, 4, 16)),
        ("seq", (3, 10, 16)))}
    fmods = {"transformer": JaxTransformer(config=jconfig.TransformerConfig(**BASELINE_TCFG)),
             **{cell: JaxRecurrent(config=jconfig.RecurrentConfig(**BASELINE_RCFG, cell=cell))
                for cell in CELLS}}
    args = {name: (x["x_enc"], x["x_dec"]) if name == "transformer" else (x["seq"],)
            for name in fmods}
    params = {name: _perturb(jax.jit(f.init)(jax.random.key(0), *args[name])["params"], rng)
              for name, f in fmods.items()}
    states = {name: (convert.from_flax_transformer if name == "transformer"
                     else convert.from_flax_recurrent)(p) for name, p in params.items()}
    inputs = {"cfgs": {"transformer": BASELINE_TCFG, "recurrent": BASELINE_RCFG},
              "states": states, "x": {k: torch.from_numpy(v) for k, v in x.items()}}
    return fmods, params, x, inputs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tp = {fused: _tp_inputs(fused) for fused in (False, True)}
    lsq = _lsq_inputs()
    baselines = _baseline_inputs()
    inputs = {"ring_qkv_2": [torch.from_numpy(t) for t in _ring_qkv(2, 2)],
              "ring_cot_2": torch.from_numpy(_ring_cotangent(2, 3)),
              "tp_cfg": TP_CFG,
              "tp_batch": [torch.from_numpy(t) for t in tp[False][3]],
              **{f"tp_state_{fused}": from_flax(params, stats)
                 for fused, (_, params, stats, _) in tp.items()},
              "lsq_cfg": LSQ_SMALL,
              "lsq_state": from_flax(lsq[1], lsq[2]),
              "lsq_batch": [torch.from_numpy(t) for t in lsq[3]],
              "baselines": baselines[3]}
    outs = spawn(tmp_path_factory.mktemp("two_ranks"),
                 ["ring", "ring_grad", "ring_trainer", "tp_forward", "tp_step", "tp_lsq",
                  "tp_baselines", "train_lsq_tp"], 2, inputs)
    return dict(outs=outs, inputs=inputs, tp=tp, lsq=lsq, baselines=baselines[:3])


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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_ring_attention_grads_match_jax(four_ranks, two_ranks, p, causal):
    """dQ, dK and dV of the port's ring on P gloo ranks (every rank holds
    the global gradients) against ``jax.grad`` of JAX ``ring_attention``
    on a seq=P sub-mesh, for ``sum(out * cotangent)``; P = 2 and 4, where a
    rotation too few or too many shows."""
    group = four_ranks if p == 4 else two_ranks
    q, k, v = (jnp.asarray(t.numpy()) for t in group["inputs"][f"ring_qkv_{p}"])
    cot = jnp.asarray(group["inputs"][f"ring_cot_{p}"].numpy())
    mesh = jax_make_mesh(data=1, model=1, seq=p, devices=jax.devices()[:p])
    want = jax.grad(lambda q, k, v: jnp.sum(jax_ring_attention(q, k, v, mesh, causal=causal)
                                            * cot), argnums=(0, 1, 2))(q, k, v)
    for out in group["outs"]:
        for got, w in zip(out["ring_grad"][causal], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_ring_step(four_ranks):
    """JAX ``_update`` (SGD at lr 1) of JAX's ring model (``jax.grad``
    through its ``shard_map``) on a seq=4 sub-mesh, from the ring weights on
    the ring batch: (parameters after the step, metrics)."""
    cfg = JaxInformerConfig(**RING_CFG, attn="ring")
    mesh = jax_make_mesh(data=1, model=1, seq=4, devices=jax.devices()[:4])
    fmod = jax_build_informer(cfg, mesh=mesh)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=four_ranks["ring_vars"]["params"],
                                 batch_stats=None, tx=optax.sgd(1.0))
    batch = [jnp.asarray(t.numpy()) for t in four_ranks["inputs"]["ring_batch"]]
    key = jax.random.key(0)
    stepped, metrics = jax.jit(jax_update)(state, *batch, key, key)
    return from_flax(_np(stepped.params)), metrics


def test_ring_informer_step_matches_jax_update(four_ranks, jax_ring_step):
    """One ``_update`` (SGD at lr 1) of the ring Informer on 4 ranks, equal
    in the ranks to the full model's step, against JAX ``_update`` of JAX's
    ring model (``jax.grad`` through its ``shard_map``) on 4 devices with
    the same weights and batch: the loss and every parameter after it."""
    want, metrics = jax_ring_step
    for out in four_ranks["outs"]:
        got = out["ring_train"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=RTOL)
        for name, w in want.items():
            np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


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


def test_ring_is_forward_only_and_needs_a_mesh(two_ranks):
    """The ring is no longer forward-only: ``Trainer(mesh=...)`` trains a
    ring Informer over a 2-rank seq axis (in the ranks: parameters the same
    on every rank; at dropout 0 its run ends where the full model's ends
    within rtol 2e-4 / atol 2e-5), its validation NMSE finite and falling
    at dropout 0.1. An ``attn="ring"`` layer with no mesh raises as JAX's,
    and so does the ring itself."""
    for out in two_ranks["outs"]:
        hist = out["ring_trainer"][0.1]
        assert all(np.isfinite(hist)) and hist[-1] < hist[0], hist
    q = torch.randn(1, 4, 1, 8, requires_grad=True)
    with pytest.raises(AttributeError):
        ring_attention(q, q, q, mesh=None)
    layer = AttentionLayer(8, 1, attn="ring")
    with torch.no_grad(), pytest.raises(ValueError, match="requires a mesh with a 'seq' axis"):
        layer(torch.randn(1, 4, 8), torch.randn(1, 4, 8), torch.randn(1, 4, 8))


# --- tensor parallelism ------------------------------------------------------------


def _jax_tp_mesh():
    return jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])


@pytest.mark.parametrize("fused", [False, True])
def test_tensor_parallel_forward_matches_jax_shard_params(two_ranks, fused):
    """The port's tensor-parallel forward on 2 gloo ranks (in the ranks:
    equal to the replicated port model, every shard its rows of the full
    weight) against JAX's apply on ``shard_params``' placements at model 2,
    eval mode, fused and unfused; every weight of the model is sharded."""
    fmod, params, stats, (x_enc, x_dec, _) = two_ranks["tp"][fused]
    mesh = _jax_tp_mesh()
    variables = {"params": jax_shard_params(params, mesh), "batch_stats": stats}
    want = np.asarray(jax.jit(fmod.apply)(variables, jnp.asarray(x_enc), jnp.asarray(x_dec)))
    port = dict(build_informer(InformerConfig(**TP_CFG, fuse_qkv=fused),
                               device="cpu").named_parameters())
    for out in two_ranks["outs"]:
        np.testing.assert_allclose(out["tp_forward"][fused]["out"].numpy(), want, rtol=RTOL,
                                   atol=ATOL)
        assert set(out["tp_forward"][fused]["sharded"]) == {n for n, p in port.items()
                                                             if p.ndim >= 2}


@pytest.mark.parametrize("fused", [False, True])
def test_tensor_parallel_step_matches_jax_update(two_ranks, fused):
    """One tensor-parallel ``_update`` (SGD at lr 1) on 2 gloo ranks (in the
    ranks: each shard equal to its rows of the replicated model's step, the
    replicated parameters' gradients equal on both ranks bit for bit),
    gathered, against JAX ``_update`` on ``shard_params``' placements at
    model 2: the loss, every parameter and the BatchNorm statistics."""
    fmod, params, stats, batch = two_ranks["tp"][fused]
    mesh = _jax_tp_mesh()
    state = JaxTrainState.create(apply_fn=fmod.apply, params=jax_shard_params(params, mesh),
                                 batch_stats=stats, tx=optax.sgd(1.0))
    key = jax.random.key(0)
    stepped, metrics = jax.jit(jax_update)(state, *map(jnp.asarray, batch), key, key)
    want = from_flax(_np(stepped.params), _np(stepped.batch_stats))
    for out in two_ranks["outs"]:
        got = out["tp_step"][fused]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=RTOL)
        for name, w in want.items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(got["state"][name].numpy(), w.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=name)


def test_tensor_parallel_trainer_matches_the_replicated_trainer(two_ranks):
    """``Trainer(mesh=...)`` with a model axis of 2: two epochs of Adam at
    dropout 0.1 end where the replicated model's Trainer (a mesh of the same
    draws) ends (in the ranks: validation NMSE rtol 2e-4; the checkpoints'
    gathered parameters and Adam moments against the replicated ones), the
    same history on both ranks."""
    hists = [out["tp_step"]["trainer"] for out in two_ranks["outs"]]
    assert hists[0] == hists[1] and all(np.isfinite(hists[0]))


# --- two axes, every model under tensor parallelism, resuming, the dry run --------------


def _close_state(got, want):
    for name, w in want.items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=name)


def test_data_x_model_update_matches_jax_update_on_shard_params(four_ranks):
    """One ``_update`` (SGD at lr 1) on a data 2 x model 2 mesh of 4 gloo
    ranks (each its data coordinate's half of the batch, its rows of every
    sharded weight; gathered, the same on every rank) against JAX
    ``_update`` on ``shard_params``' placements of a 2 x 2 mesh with the
    batch sharded on ``data``: the loss, every parameter and the BatchNorm
    statistics."""
    fmod, params, stats, batch = four_ranks["tp"]
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    state = JaxTrainState.create(apply_fn=fmod.apply, params=jax_shard_params(params, mesh),
                                 batch_stats=stats, tx=optax.sgd(1.0))
    sharded = [jax.device_put(jnp.asarray(t), jax_batch_sharding(mesh)) for t in batch]
    key = jax.random.key(0)
    stepped, metrics = jax.jit(jax_update)(state, *sharded, key, key)
    want = from_flax(_np(stepped.params), _np(stepped.batch_stats))
    assert sum("running_" in k for k in want) == 2  # the one distilling BatchNorm
    for out in four_ranks["outs"]:
        got = out["dp_tp_update"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=RTOL)
        _close_state(got["state"], want)


@pytest.mark.parametrize("axes", ["1x2x2", "2x1x2"])
def test_seq_axis_beside_model_or_data_matches_the_replicated_step(four_ranks, jax_ring_step,
                                                                   axes):
    """The ring Informer (distil off) on a model 2 x seq 2 and a data 2 x
    seq 2 mesh of 4 gloo ranks: one ``_update`` (SGD at lr 1), equal in the
    ranks to the full model's replicated step on the global batch, and here
    to JAX ``_update`` of JAX's ring model on the same weights and batch:
    the loss and every parameter after the step."""
    want, metrics = jax_ring_step
    for out in four_ranks["outs"]:
        got = out["seq_axes"][axes]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=RTOL)
        _close_state(got["state"], want)


def test_tensor_parallel_run_resumes_bit_for_bit(four_ranks):
    """``Trainer`` on a data 2 x model 2 mesh (dropout 0.1) resumed from its
    gathered checkpoint at epoch 1 (``load_checkpoint`` into each rank's
    shards, ``fit(start_epoch=1)``) ends where two uninterrupted epochs end,
    histories, parameters and Adam moments bit for bit; so does
    ``cli/train_informer.py --resume`` on the mesh (in the ranks). The
    histories are finite and the same on every rank."""
    hists = [out["trainer_2d_resume"] for out in four_ranks["outs"]]
    assert all(h == hists[0] for h in hists)
    assert all(np.isfinite(hists[0]["nmse"])) and all(np.isfinite(hists[0]["cli"]))


def test_lsq_fibbinary_step_at_model_2_matches_jax_on_shard_params(two_ranks):
    """One step of the small LSQ-fibbinary stack at model 2 on 2 gloo ranks
    (in the ranks: every gradient against the replicated port model's, the
    replicated gradients equal on both ranks bit for bit, each
    ``reset_step_size`` from the whole weight) against JAX ``_update`` on
    ``shard_params``' placements at model 2: the loss and every gradient,
    gathered, each of the 28 ``step_size``s' included."""
    fmod, params, stats, batch = two_ranks["lsq"]
    mesh = _jax_tp_mesh()
    state = JaxTrainState.create(apply_fn=fmod.apply, params=jax_shard_params(params, mesh),
                                 batch_stats=stats, tx=_grad_recorder())
    key = jax.random.key(0)
    stepped, metrics = jax.jit(jax_update)(state, *map(jnp.asarray, batch), key, key)
    want = {k: v for k, v in from_flax(_np(stepped.opt_state), _np(stepped.batch_stats)).items()
            if "running_" not in k and not k.endswith("num_batches_tracked")}
    assert sum(k.endswith("step_size") for k in want) == 28
    for out in two_ranks["outs"]:
        got = out["tp_lsq"]
        np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=RTOL)
        assert set(got["grads"]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_train_lsq_preloads_into_a_tensor_parallel_trainer(two_ranks):
    """``cli/train_lsq.py`` with ``main(argv, mesh=...)`` at model 2 on 2 gloo
    ranks (in the ranks: each rank's rows of the gathered FP32 checkpoint
    overlaid, the validation NMSE within rtol 2e-4 and the gathered LSQ
    checkpoint within the run's tolerance of a run on a mesh of the same
    draws with nothing sharded; rank 0 alone writes the files): the same
    finite NMSE on both ranks."""
    nmse = [out["train_lsq_tp"]["nmse"] for out in two_ranks["outs"]]
    assert nmse[0] == nmse[1] and np.isfinite(nmse[0])


def _jax_baseline_step(name, fmod, params, x):
    """JAX's eval output (and rollout), loss and gradients of a baseline on
    ``shard_params``' placements at model 2: the Transformer through
    ``_update``, a recurrent predictor through ``jax.grad`` of its NMSE."""
    placed = {"params": jax_shard_params(params, _jax_tp_mesh())}
    if name == "transformer":
        args = (jnp.asarray(x["x_enc"]), jnp.asarray(x["x_dec"]))
        state = JaxTrainState.create(apply_fn=fmod.apply, params=placed["params"],
                                     batch_stats={}, tx=_grad_recorder())
        key = jax.random.key(0)
        stepped, metrics = jax.jit(jax_update)(state, *args, jnp.asarray(x["target"]), key, key)
        return {"out": jax.jit(fmod.apply)(placed, *args), "loss": metrics["loss"],
                "grads": convert.from_flax_transformer(_np(stepped.opt_state))}
    seq = jnp.asarray(x["seq"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_nmse(fmod.apply({"params": p}, seq)[:, 1:], seq[:, 1:])))(placed["params"])
    rollout = jax.jit(lambda v, a: fmod.apply(v, a, 4, method=JaxRecurrent.rollout))
    return {"out": jax.jit(fmod.apply)(placed, seq), "rollout": rollout(placed, seq),
            "loss": loss, "grads": convert.from_flax_recurrent(_np(grads))}


@pytest.mark.parametrize("model", ["transformer", "lstm", "gru", "rnn", "conv_lsq"])
def test_baselines_take_a_model_axis(two_ranks, model):
    """Each baseline and a quantized ``ConvLSQ`` at model 2 on 2 gloo ranks
    (in the ranks: the forward, the recurrent rollout and one SGD step
    against the replicated port model at rtol 2e-4 / atol 2e-5, the
    replicated gradients equal bit for bit): the recurrent cells, the
    recurrent predictors' ``nn.Linear``s and ``ConvLSQ`` gather their rows
    at use, the Transformer's layers run column-parallel. The baselines
    against JAX's on ``shard_params``' placements at model 2, at the same
    tolerance: the eval output (the recurrent ones' rollout too), the loss
    and every gradient, gathered. ``ConvLSQ`` has no JAX model: it is held
    to the replicated port model only."""
    want_shard = {"transformer": "ffn1.weight", "lstm": "cells_0.weight_hh",
                  "gru": "cells_1.weight_ih", "rnn": "decoder.weight",
                  "conv_lsq": "weight"}[model]
    outs = [out["tp_baselines"][model] for out in two_ranks["outs"]]
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    assert any(n.endswith(want_shard) for n in outs[0]["sharded"])
    if model == "conv_lsq":
        return
    fmods, params, x = two_ranks["baselines"]
    want = _jax_baseline_step(model, fmods[model], params[model], x)
    for got in outs:
        for key in ("out", "rollout"):
            if key in want:
                np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=RTOL,
                                           atol=ATOL, err_msg=key)
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=RTOL)
        assert set(got["grads"]) == set(want["grads"])
        for name, w in want["grads"].items():
            np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_multichip_legs_match_the_jax_dry_run(four_ranks):
    """``cli/multichip.py`` at 4 ranks against ``__graft_entry__.py``'s legs
    built as that file builds them on 4 virtual devices (dropout 0 in the
    training step, its window draws injected): the data 2 x model 2 step's
    loss, gradients and parameters after Adam; the ring's loss
    ``sum(out ** 2)`` and its gradients at the same weights; the beam sweep
    of the same channel over a model 4 axis (selected beams equal, ``h_eff``
    within the sweep's tolerance); the sharded dataset's shape. The dry run
    with the port's own draws is finite on every rank."""
    want = four_ranks["multichip"]
    for out in four_ranks["outs"]:
        got = out["multichip"]
        np.testing.assert_allclose(got["train"]["loss"], want["loss"], rtol=RTOL)
        assert set(got["train"]["grads"]) == set(want["grads"])
        for name, w in want["grads"].items():
            np.testing.assert_allclose(got["train"]["grads"][name].numpy(), w.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        _close_state(got["train"]["state"], want["state"])
        np.testing.assert_allclose(got["ring"]["loss"], want["ring_loss"], rtol=RTOL)
        for name, w in want["ring_grads"].items():
            np.testing.assert_allclose(got["ring"]["grads"][name].numpy(), w.numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=name)
        pipe = got["pipeline"]
        np.testing.assert_array_equal(pipe["selected"].numpy(), want["selected"])
        assert np.abs(pipe["h_eff"].numpy() - want["h_eff"]).max() <= CHANNEL_TOL
        assert (pipe["shard"].shape[0] * 2,) + tuple(pipe["shard"].shape[1:]) == \
            tuple(want["dataset_shape"])
        assert want["dataset_finite"] and bool(torch.isfinite(pipe["shard"]).all())
        dry = got["dryrun"]
        assert dry["model_axis"] == 2 and np.isfinite([dry["train_loss"], dry["ring_loss"]]).all()
        assert dry["ring_grads_finite"] and dry["dataset_finite"] and dry["h_eff_finite"]
