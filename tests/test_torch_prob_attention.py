"""The port's ProbSparse attention and fused QKV projections against the JAX
package's, on the CPU.

- ``prob_sparse_attention`` fed JAX's own ``index_sample`` (drawn from the
  key JAX's function draws from), in both of the port's layouts against
  both of JAX's, masked and unmasked, at the flagship's sparse lengths (L
  90, 45, 23) and where ``n_top == L`` (12, and 15 causal: there it equals
  full attention too): atol 1e-5, float32. bf16 against JAX's bf16 at
  ``tests/test_torch_bf16.py``'s module tolerance (max|diff| / max|ref| <=
  2e-2).
- Whole InformerStacks (small widths) with ``attn="prob"`` and with
  ``fuse_qkv=True``, weights through ``from_flax``, in eval and over one
  training step at dropout 0, at the tolerances of
  ``tests/test_torch_informer.py`` and ``tests/test_torch_training.py``
  (rtol 2e-4, atol 2e-5). JAX's per-layer ``index_sample`` draws are
  recorded by wrapping ``jax.random.randint`` while the flax model applies
  unjitted, and fed to the port's layers in call order.
- The configs no other test pins (``PROBED``): prob with ``mix=False``,
  ``pre_norm``, ``distil=False``, an int ``e_layers``, ``output_attention``,
  relu, ``fuse_qkv`` and ``factor=3``; fused with ``pre_norm``,
  ``output_attention``, ``mix=False`` and ``distil=False``: each on the
  kernel route against flax in eval at atol 1e-5 (rtol 2e-4), the
  attention maps included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.models import attention as jattention
from channelestimationtransformer_tpu.train.trainer import TrainState as JaxTrainState
from channelestimationtransformer_tpu.train.trainer import _update as jax_update

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.core.metrics import nmse, nmse_split
from channelestimationtransformer_torch.models import attention
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.utils.convert import from_flax

from test_torch_bf16 import MODULE_TOL, _rel_err
from test_torch_informer import RTOL, ATOL, SMALL, _flax_apply, _model_pair, _torch_apply
from test_torch_training import _grad_recorder, _np, _train_step_against_jax_update

PROB_ATOL = 1e-5
B, H, E = 3, 4, 8
FACTOR = 5
# (l_q, l_k, masked): the flagship encoder's sparse lengths; its L 12 and the
# decoder's causal L 15, where n_top == L; a masked sparse length; and the
# cross-attention shape (l_q != l_k, unmasked).
SHAPES = [(90, 90, False), (45, 45, False), (23, 23, False), (12, 12, False),
          (15, 15, True), (45, 45, True), (15, 24, False)]


def _qkv(rng, l_q, l_k, b=B, h=H, e=E):
    return tuple(rng.normal(size=(b, l, h, e)).astype(np.float32) for l in (l_q, l_k, l_k))


def _jax_prob(q, k, v, masked, key, dense_layout):
    return np.asarray(jattention.prob_sparse_attention(
        *map(jnp.asarray, (q, k, v)), mask_flag=masked, factor=FACTOR, sample_rng=key,
        dense_layout=dense_layout)[0])


def _jax_index_sample(key, l_q, l_k):
    """JAX's draw inside ``prob_sparse_attention`` (``models/attention.py:112``)."""
    sample_k, _ = attention.prob_sizes(l_q, l_k, FACTOR)
    return np.array(jax.random.randint(key, (l_q, sample_k), 0, l_k))


@pytest.mark.parametrize("port_dense", [True, False])
@pytest.mark.parametrize("l_q,l_k,masked", SHAPES)
def test_prob_sparse_attention_matches_jax(l_q, l_k, masked, port_dense):
    """Both port layouts against both JAX layouts, on JAX's index_sample."""
    rng = np.random.default_rng(l_q + 100 * masked)
    q, k, v = _qkv(rng, l_q, l_k)
    key = jax.random.key(l_q)
    idx = torch.from_numpy(_jax_index_sample(key, l_q, l_k))
    got, maps = attention.prob_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), mask_flag=masked, factor=FACTOR, index_sample=idx,
        dense_layout=port_dense)
    assert maps is None and got.shape == (B, l_q, H, E) and got.dtype == torch.float32
    for jax_dense in (True, False):
        np.testing.assert_allclose(got.numpy(), _jax_prob(q, k, v, masked, key, jax_dense),
                                   rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("l,masked", [(12, False), (15, True)])
def test_prob_sparse_attention_with_every_query_kept_is_full_attention(l, masked):
    """n_top == L: every row attends, so the result is full attention (JAX's
    and the port's) whatever the draw."""
    assert attention.prob_sizes(l, l, FACTOR)[1] == l
    rng = np.random.default_rng(l)
    q, k, v = _qkv(rng, l, l)
    idx = torch.randint(0, l, (l, attention.prob_sizes(l, l, FACTOR)[0]),
                        generator=torch.Generator().manual_seed(3))
    got, _ = attention.prob_sparse_attention(*map(torch.from_numpy, (q, k, v)),
                                             mask_flag=masked, factor=FACTOR, index_sample=idx)
    full, _ = attention.full_attention(*map(torch.from_numpy, (q, k, v)), mask_flag=masked)
    want, _ = jattention.full_attention(*map(jnp.asarray, (q, k, v)), mask_flag=masked)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_element_budget_picks_the_gather_layout(monkeypatch, masked):
    """With the port's DENSE_SCORES_ELEM_BUDGET below b*h*l_q*l_k the switch
    takes the gather layout (its per-query key einsum runs), and the result
    still equals JAX's (at JAX's own constants, its dense layout)."""
    b, h, l = 1, 2, 90
    monkeypatch.setattr(attention, "DENSE_SCORES_ELEM_BUDGET", b * h * l * l - 1)
    equations = []
    real_einsum = torch.einsum
    monkeypatch.setattr(attention.torch, "einsum",
                        lambda eq, *ops: equations.append(eq) or real_einsum(eq, *ops))
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, l, l, b=b, h=h)
    key = jax.random.key(5)
    got, _ = attention.prob_sparse_attention(
        *map(torch.from_numpy, (q, k, v)), mask_flag=masked, factor=FACTOR,
        index_sample=torch.from_numpy(_jax_index_sample(key, l, l)))
    assert "bhle,bhlse->bhls" in equations and "bhle,bhse->bhls" not in equations
    np.testing.assert_allclose(got.numpy(), _jax_prob(q, k, v, masked, key, None),
                               rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("l,masked", [(90, False), (15, True), (45, True)])
def test_bf16_prob_sparse_attention_matches_flax_bf16(l, masked):
    """bf16 q, k, v: the port computes in bf16 as JAX's XLA path does."""
    rng = np.random.default_rng(11 + l)
    q, k, v = _qkv(rng, l, l)
    key = jax.random.key(l + 1)
    got, _ = attention.prob_sparse_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), mask_flag=masked,
        factor=FACTOR, index_sample=torch.from_numpy(_jax_index_sample(key, l, l)))
    want, _ = jattention.prob_sparse_attention(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)), mask_flag=masked,
        factor=FACTOR, sample_rng=key)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got, want) <= MODULE_TOL


def test_index_sample_draws_from_the_generator_or_a_fixed_seed():
    """A prob layer draws [L_Q, sample_k] indices from its generator; with
    none, the fixed draw of a generator seeded 0, the same every call."""
    a = attention.draw_index_sample(90, 90, FACTOR, torch.Generator().manual_seed(1), "cpu")
    b = attention.draw_index_sample(90, 90, FACTOR, torch.Generator().manual_seed(1), "cpu")
    c = attention.draw_index_sample(90, 90, FACTOR, None, "cpu")
    assert a.shape == (90, 25) and torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(c, attention.draw_index_sample(90, 90, FACTOR, None, "cpu"))
    assert torch.equal(c, torch.randint(0, 90, (90, 25),
                                        generator=torch.Generator().manual_seed(0)))
    assert int(a.min()) >= 0 and int(a.max()) < 90


# --- whole models -----------------------------------------------------------

# SMALL at the flagship's input lengths, so its prob layers are sparse at L 90,
# 45 and 23 and full at L 12 and in the decoder's causal L 15.
PROB = dict(SMALL, seq_len=90, label_len=10, e_layers=(4, 3), d_layers=2, attn="prob")


class _Draws:
    """Records JAX's ``jax.random.randint`` results while the flax model
    applies unjitted, then hands them to the port's layers in call order."""

    def __init__(self, monkeypatch):
        self.recorded, self.monkeypatch = [], monkeypatch
        real = jax.random.randint
        monkeypatch.setattr(jax.random, "randint", lambda *a, **kw: self._keep(real(*a, **kw)))

    def _keep(self, x):
        self.recorded.append(np.array(x))
        return x

    def inject(self):
        draws = list(self.recorded)

        def draw(l_q, l_k, factor, generator, device):
            idx = draws.pop(0)
            assert idx.shape == (l_q, attention.prob_sizes(l_q, l_k, factor)[0])
            return torch.from_numpy(idx).to(device)
        self.monkeypatch.setattr(attention, "draw_index_sample", draw)
        return draws


# (l_q, sample_k) of PROB's prob layers in call order: encoder 0 at L 90, 45,
# 23, 12; encoder 1 at 45, 23, 12; the decoder's self-attention at 15, twice.
PROB_DRAWS = [(90, 25), (45, 20), (23, 20), (12, 12), (45, 20), (23, 20), (12, 12),
              (15, 15), (15, 15)]


def test_prob_informer_stack_matches_flax_in_eval(monkeypatch):
    rng = np.random.default_rng(31)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 3, port_pallas=True, **PROB)
    draws = _Draws(monkeypatch)
    want = fmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x_enc),
                      jnp.asarray(x_dec), rngs={"sample": jax.random.key(3)})
    assert [d.shape for d in draws.recorded] == PROB_DRAWS
    left = draws.inject()
    got = _torch_apply(tmod, x_enc, x_dec)
    assert left == []
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_prob_informer_stack_train_step_matches_jax_update(monkeypatch):
    """One training step at dropout 0 against JAX ``_update`` applied
    unjitted: output, loss, split, BatchNorm statistics and every gradient."""
    rng = np.random.default_rng(32)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 3, port_pallas=True, **PROB)
    target = rng.normal(size=(3, PROB["pred_len"], 16)).astype(np.float32)
    state = JaxTrainState.create(apply_fn=fmod.apply, params=params, batch_stats=stats,
                                 tx=_grad_recorder())
    draws = _Draws(monkeypatch)
    new_state, metrics = jax_update(state, *map(jnp.asarray, (x_enc, x_dec, target)),
                                    jax.random.key(0), jax.random.key(1))
    assert [d.shape for d in draws.recorded] == PROB_DRAWS
    draws.inject()

    tmod.train()
    pred = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                generator=torch.Generator().manual_seed(0))
    t_target = torch.from_numpy(target)
    loss = nmse(pred, t_target)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=RTOL)
    np.testing.assert_allclose(nmse_split(pred.detach(), t_target).numpy(),
                               np.asarray(metrics["loss_split"]), rtol=RTOL)
    want = from_flax(_np(new_state.opt_state), _np(new_state.batch_stats))
    got_state = tmod.state_dict()
    for name in [k for k in want if "running_" in k]:
        np.testing.assert_allclose(got_state[name].numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_prob_model_draws_from_its_generator_in_eval_and_full_models_do_not():
    """A prob model's eval forward depends on its generator's draws; a full
    model's eval forward draws nothing from it."""
    x_enc, x_dec = torch.randn(2, 90, 16), torch.randn(2, 15, 16)
    small = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1)
    prob = build_informer(InformerConfig(attn="prob", **small), device="cpu")
    full = build_informer(InformerConfig(**small), device="cpu")
    with torch.no_grad():
        a, b = (prob(x_enc, x_dec, generator=torch.Generator().manual_seed(s)) for s in (1, 2))
        assert not torch.equal(a, b)
        assert torch.equal(a, prob(x_enc, x_dec, generator=torch.Generator().manual_seed(1)))
        assert torch.equal(prob(x_enc, x_dec), prob(x_enc, x_dec))  # the fixed draw
        gen = torch.Generator().manual_seed(4)
        before = gen.get_state()
        full(x_enc, x_dec, generator=gen)
        assert torch.equal(gen.get_state(), before)


# Prob and fused configs no other test pins, each a change to PROB_SMALL (L
# 48 and its distilled 24 both sparse, the decoder's 15 full; fewer layers
# than PROB, as flax applies them unjitted) or to SMALL with fuse_qkv.
PROB_SMALL = dict(SMALL, seq_len=48, label_len=10, e_layers=(2, 1), d_layers=1, attn="prob")
FUSED = dict(SMALL, fuse_qkv=True)
PROBED = {
    "prob_no_mix": dict(PROB_SMALL, mix=False),
    "prob_pre_norm": dict(PROB_SMALL, pre_norm=True),
    "prob_no_distil": dict(PROB_SMALL, distil=False),
    "prob_e_layers_int": dict(PROB_SMALL, e_layers=2),
    "prob_output_attention": dict(PROB_SMALL, output_attention=True),
    "prob_relu": dict(PROB_SMALL, activation="relu"),
    "prob_fuse_qkv": dict(PROB_SMALL, fuse_qkv=True),
    "prob_factor_3": dict(PROB_SMALL, factor=3),
    "fused_pre_norm": dict(FUSED, pre_norm=True),
    "fused_output_attention": dict(FUSED, output_attention=True),
    "fused_no_mix": dict(FUSED, mix=False),
    "fused_no_distil": dict(FUSED, distil=False),
}


def _maps(maps):
    if isinstance(maps, (list, tuple)):
        return [a for m in maps for a in _maps(m)]
    if isinstance(maps, torch.Tensor):
        maps = maps.numpy()
    return [] if maps is None else [np.asarray(maps)]


@pytest.fixture
def one_torch_thread():
    """torch on one thread for a test of many small ops, which the default
    intra-op pool slows several-fold on a shared machine (as under
    pytest-xdist's workers); restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(PROBED))
def test_probed_prob_and_fused_configs_match_flax(name, monkeypatch, one_torch_thread):
    """Eval on the kernel route against flax (prob: applied unjitted, JAX's
    ``index_sample`` draws injected in call order): atol 1e-5 (all within
    3.2e-6 when probed), the attention maps too with ``output_attention``."""
    rng = np.random.default_rng(36)
    cfg = PROBED[name]
    prob = cfg.get("attn") == "prob"
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 2, port_pallas=True, **cfg)
    draws = _Draws(monkeypatch)
    want = (fmod.apply if prob else jax.jit(fmod.apply))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x_enc), jnp.asarray(x_dec),
        rngs={"sample": jax.random.key(3)})
    left = draws.inject()
    assert bool(left) == prob
    with torch.no_grad():
        got = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    assert left == []
    if cfg.get("output_attention"):
        (got, got_maps), (want, want_maps) = got, want
        got_maps, want_maps = _maps(got_maps), _maps(want_maps)
        # ProbSparse layers return no map (as JAX's); the fused full ones do.
        assert len(got_maps) == len(want_maps) and bool(got_maps) == ("fused" in name)
        for g, w in zip(got_maps, want_maps):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fused_qkv_informer_stack_matches_flax(use_pallas):
    """fuse_qkv=True through from_flax (qkv kernels [d_model, 3d]; query and
    a kv pair in cross-attention), in eval."""
    rng = np.random.default_rng(33)
    cfg = dict(SMALL, fuse_qkv=True)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 2, port_pallas=use_pallas, **cfg)
    enc_attn = params["encoder"]["encoder_0"]["layer_0"]["attention"]
    cross = params["decoder"]["layer_0"]["cross_attention"]
    assert set(enc_attn) == {"qkv", "out"} and set(cross) == {"query", "kv", "out"}
    assert set(params["decoder"]["layer_0"]["self_attention"]) == {"qkv", "out"}
    np.testing.assert_allclose(_torch_apply(tmod, x_enc, x_dec),
                               _flax_apply(fmod, params, stats, x_enc, x_dec),
                               rtol=RTOL, atol=ATOL)


def test_fused_qkv_train_step_matches_jax_update():
    _train_step_against_jax_update(dict(SMALL, fuse_qkv=True), jax_pallas=False,
                                   port_pallas=True, seed=34)


def test_fused_projection_needs_one_tensor():
    """A fused qkv layer refuses q, k, v that are not one tensor; a fused kv
    layer refuses keys that are not the values. LSQ keeps them unfused."""
    layer = attention.AttentionLayer(16, 2, fuse_qkv=True)
    cross = attention.AttentionLayer(16, 2, fuse_qkv=True, cross=True)
    x, y = torch.randn(2, 5, 16), torch.randn(2, 7, 16)
    with torch.no_grad():
        assert layer(x, x, x)[0].shape == (2, 5, 16)
        assert cross(x, y, y)[0].shape == (2, 5, 16)
        with pytest.raises(ValueError, match="one tensor"):
            layer(x, x.clone(), x)
        with pytest.raises(ValueError, match="keys and values"):
            cross(x, y, y.clone())
    lsq = attention.AttentionLayer(16, 2, fuse_qkv=True, lsq_nbits=8)
    assert {n.split(".")[0] for n, _ in lsq.named_parameters()} == {"query", "key", "value",
                                                                   "out"}


@pytest.mark.parametrize("fuse_qkv", [False, True])
def test_prob_and_fused_models_keep_the_flagship_routes(monkeypatch, fuse_qkv):
    """At the flagship width with use_pallas, a prob model sends only its
    three cross-attention calls (15 x 24) to the bd kernel and none to mha;
    a fused full model sends all 13."""
    calls = []
    real = attention.bd_attention
    monkeypatch.setattr(attention, "bd_attention", lambda q, k, v, **kw: (
        calls.append((q.shape[1], k.shape[1])) or real(q, k, v, **kw)))
    monkeypatch.setattr(attention, "mha_attention", lambda *a, **kw: pytest.fail("mha"))
    cfg = InformerConfig(use_pallas=True, **(dict(fuse_qkv=True) if fuse_qkv else
                                             dict(attn="prob")))
    model = build_informer(cfg, device="cpu")
    with torch.no_grad():
        model(torch.randn(2, 90, 16), torch.randn(2, 15, 16),
              generator=torch.Generator().manual_seed(0))
    assert len(calls) == (13 if fuse_qkv else 3)
    assert calls.count((15, 24)) == 3
