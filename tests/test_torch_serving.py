"""int8 serving and the storage-rate report in the port against the JAX
package's (``ops/quant/serving.py``, ``ops/quant/rate.py``), on the CPU.

- The table: the same key set as JAX's (its paths joined by ``.``) on a
  small InformerStack, on the LSQ-fibbinary stack and at the flagship (77
  entries), and ``w_q`` / ``w_scale`` / ``bias`` bit for bit, for dense
  layers, distil convs and LSQ step sizes.
- ``int8_dense_apply``, ``int8_dense_weight_only_apply`` and
  ``int8_circular_conv_apply`` within 1e-6 of the max against JAX's under
  ``jax.jit`` (the JAX driver's path: XLA turns the activation scale's
  ``/ 127.0`` into ``* (1 / 127)``, which the port follows). Weight-only
  sums its bf16 products in f32; a bf16 result misses by far more.
- ``predict_int8`` in both modes against the JAX intercept under
  ``jax.jit`` on the small InformerStack and the LSQ-fibbinary stack:
  max|Δ|/max ≤ 1e-3 and NMSE ≤ 1e-8 (seen: ~4e-7 and ~6e-14; the limits
  leave room for one activation code flipped at a rounding boundary).
- ``hits``, the no-hit ``RuntimeError``, the partial-hit warning, the
  unknown mode, the forwards restored on exit, the int8 GEMM's shape rule.
- ``model_rate_report`` against JAX's, key for key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from channelestimationtransformer_tpu.core.config import InformerConfig as JaxInformerConfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.ops.quant import rate as jrate
from channelestimationtransformer_tpu.ops.quant import serving as js

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.models import build_informer, build_informer_lsq
from channelestimationtransformer_torch.ops.quant import rate as trate
from channelestimationtransformer_torch.ops.quant import serving as ts
from channelestimationtransformer_torch.utils.convert import load_flax

from test_torch_informer import SMALL, _model_pair
from test_torch_lsq import SMALL as LSQ_SMALL
from test_torch_lsq import _lsq_pair


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    """The small InformerStack pair (batch 4: 96 encoder and 44 decoder
    tokens, past the int8 GEMM's m > 16)."""
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(np.random.default_rng(0), 4, **SMALL)
    return fmod, tmod, {"params": params, "batch_stats": stats}, x_enc, x_dec


@pytest.fixture(scope="module")
def lsq_fib():
    rng = np.random.default_rng(1)
    _, fmod, params, stats, _, _ = _lsq_pair(rng, fibbinary=True)
    tmod = build_informer_lsq(InformerConfig(**LSQ_SMALL), nbits=8, fibbinary=True,
                              device="cpu")
    load_flax(tmod, params, stats)
    cfg = InformerConfig(**LSQ_SMALL)
    x_enc = rng.normal(size=(4, cfg.seq_len, 16)).astype(np.float32)
    x_dec = rng.normal(size=(4, cfg.dec_len, 16)).astype(np.float32)
    return fmod, tmod, {"params": params, "batch_stats": stats}, x_enc, x_dec


def _assert_tables_equal(jtable, ttable):
    assert set(ttable) == {".".join(k) for k in jtable}
    for path, want in jtable.items():
        got = ttable[".".join(path)]
        assert got["w_q"].dtype == torch.int8 and got.get("taps") == want.get("taps")
        np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
        np.testing.assert_array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"]))
        np.testing.assert_array_equal(got["bias"].numpy(), np.asarray(want["bias"]))


@pytest.mark.parametrize("which", ["small", "lsq_fib"])
def test_table_matches_jax_bit_for_bit(which, request):
    """Keys, codes, scales and biases: dense layers (per-channel abs-max),
    the distil convs as tap-major im2col matrices, the LSQ layers'
    ``|step_size|``; embeddings and the projection left out."""
    _, tmod, variables, _, _ = request.getfixturevalue(which)
    jtable = js.build_int8_table(variables)
    ttable = ts.build_int8_table(tmod)
    _assert_tables_equal(jtable, ttable)
    convs = [k for k in ttable if "distil" in k]
    assert len(convs) == (2 if which == "small" else 1)
    assert all(ttable[k]["taps"] == 3 for k in convs)
    assert not any(p in k for k in ttable for p in ts.DEFAULT_EXCLUDE)
    if which == "lsq_fib":
        modules = dict(tmod.named_modules())
        steps = [k for k in ttable if hasattr(modules[k], "step_size")]
        assert len(steps) == len(ttable) - len(convs) == 28
        for k in steps:
            assert torch.equal(ttable[k]["w_scale"], modules[k].step_size.detach().abs())


def test_flagship_table_has_77_entries_equal_to_jax():
    """The flagship (52 attention projections, 20 FFN layers, 5 distil
    convs; ``experiments/artifacts/int8_serving.json`` "layers": 77), from
    seeded weights of flax's shapes."""
    fmod = jax_build_informer(JaxInformerConfig())
    shapes = jax.eval_shape(fmod.init, jax.random.key(0), jnp.zeros((1, 90, 16)),
                            jnp.zeros((1, 15, 16)))
    rng = np.random.default_rng(2)
    variables = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32)
                             + (1.0 if len(s.shape) == 1 else 0.0), shapes)
    tmod = load_flax(build_informer(InformerConfig(), device="cpu"), variables["params"],
                     variables["batch_stats"])
    jtable = js.build_int8_table(variables)
    ttable = ts.build_int8_table(tmod)
    assert len(jtable) == len(ttable) == 77
    assert sum("attention" in k for k in ttable) == 52
    assert sum(".ffn." in k for k in ttable) == 20
    assert sum("distil" in k for k in ttable) == 5
    _assert_tables_equal(jtable, ttable)


def _entry(rng, k, n, *, taps=None):
    kernel = (0.2 * rng.normal(size=(k, n))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(n,))).astype(np.float32)
    jentry = js._quantize_kernel({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, 8)
    tentry = ts._quantize_kernel(torch.from_numpy(kernel), 8, bias=torch.from_numpy(bias))
    if taps:
        jentry, tentry = dict(jentry, taps=taps), dict(tentry, taps=taps)
    return jentry, tentry


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(3, 24, 32), (40, 64)])
@pytest.mark.parametrize("mode", ["w8a8", "weight_only"])
def test_dense_apply_matches_jax(shape, mode):
    rng = np.random.default_rng(3)
    x = (2.0 * rng.normal(size=shape)).astype(np.float32)
    jentry, tentry = _entry(rng, shape[-1], 48)
    jfn, tfn = ((js.int8_dense_apply, ts.int8_dense_apply) if mode == "w8a8" else
                (js.int8_dense_weight_only_apply, ts.int8_dense_weight_only_apply))
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x), jentry))
    got = tfn(torch.from_numpy(x), tentry)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _max_rel(got.numpy(), want) <= 1e-6


def test_weight_only_needs_an_f32_result():
    """The bf16 products summed and returned in f32 are within 1e-6 of
    JAX's max; the same product with torch's plain bf16 result (rounded to
    bf16, ~3 significant digits) misses that by far."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    jentry, tentry = _entry(rng, 128, 64)
    want = np.asarray(jax.jit(js.int8_dense_weight_only_apply)(jnp.asarray(x), jentry))
    got = ts.int8_dense_weight_only_apply(torch.from_numpy(x), tentry).numpy()
    plain = (torch.from_numpy(x).bfloat16() @ tentry["w_q"].bfloat16()).float()
    plain = (plain * tentry["w_scale"] + tentry["bias"]).numpy()
    assert _max_rel(got, want) <= 1e-6
    assert _max_rel(plain, want) > 1e-3


@pytest.mark.parametrize("weight_only", [False, True])
def test_circular_conv_apply_matches_jax(weight_only):
    """The 3-tap im2col conv of the distil layers, taps rolled as JAX's,
    against JAX's; and the port's table entry of a ``ConvLayer`` weight
    against JAX's of the flax kernel (tap-major columns)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 23, 32)).astype(np.float32)
    kernel = (0.2 * rng.normal(size=(3, 32, 32))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(32,))).astype(np.float32)
    jentry = dict(js._quantize_kernel({"kernel": jnp.asarray(kernel.reshape(96, 32)),
                                       "bias": jnp.asarray(bias)}, 8), taps=3)
    conv = torch.nn.Module()
    conv.weight = torch.nn.Parameter(torch.from_numpy(kernel).permute(2, 1, 0).contiguous())
    conv.bias = torch.nn.Parameter(torch.from_numpy(bias))
    (tentry,) = ts.build_int8_table(conv).values()
    np.testing.assert_array_equal(tentry["w_q"].numpy(), np.asarray(jentry["w_q"]))
    want = np.asarray(jax.jit(lambda a: js.int8_circular_conv_apply(
        a, jentry, weight_only=weight_only))(jnp.asarray(x)))
    got = ts.int8_circular_conv_apply(torch.from_numpy(x), tentry, weight_only=weight_only)
    assert _max_rel(got.numpy(), want) <= 1e-6


@pytest.mark.parametrize("which", ["small", "lsq_fib"])
@pytest.mark.parametrize("mode", ["w8a8", "weight_only"])
def test_predict_int8_matches_jax(which, mode, request):
    fmod, tmod, variables, x_enc, x_dec = request.getfixturevalue(which)
    jtable = js.build_int8_table(variables)

    def served(v, a, b):
        with js.serving_intercept(jtable, mode=mode):
            return fmod.apply(v, a, b)
    want = np.asarray(jax.jit(served)(variables, jnp.asarray(x_enc), jnp.asarray(x_dec)))
    got = ts.predict_int8(tmod, torch.from_numpy(x_enc), torch.from_numpy(x_dec),
                          mode=mode).numpy()
    with torch.no_grad():
        f32 = tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec)).numpy()
    assert _max_rel(got, want) <= 1e-3
    assert np.square(got - want).sum() / np.square(want).sum() <= 1e-8
    assert np.abs(got - f32).max() > 1e-4  # served in int8, not a silent f32 forward


def test_intercept_hits_and_restores_forwards(small):
    """Every table entry is served (46 on the small stack), each module gets
    its own forward back on exit, also when the forward raises."""
    _, tmod, _, x_enc, x_dec = small
    table = ts.build_int8_table(tmod)
    before = {n: m.forward for n, m in tmod.named_modules()}
    hits = set()
    with torch.no_grad(), ts.serving_intercept(tmod, table, hits, mode="weight_only"):
        tmod(torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    assert hits == set(table) and len(table) == 46
    assert all("forward" not in m.__dict__ for m in tmod.modules())
    with pytest.raises(RuntimeError, match="boom"):
        with ts.serving_intercept(tmod, table):
            raise RuntimeError("boom")
    assert {n: m.forward for n, m in tmod.named_modules()} == before
    with pytest.raises(ValueError, match="unknown serving mode"):
        with ts.serving_intercept(tmod, table, mode="int4"):
            pass


def test_predict_int8_raises_on_no_hit_and_warns_on_a_partial_hit(small):
    _, tmod, _, x_enc, x_dec = small
    args = torch.from_numpy(x_enc), torch.from_numpy(x_dec)
    table = ts.build_int8_table(tmod)
    renamed = {"x." + k: v for k, v in table.items()}
    with pytest.raises(RuntimeError, match="matched no module path"):
        ts.predict_int8(tmod, *args, table=renamed)
    partial = dict(table, **{"x.unknown": next(iter(table.values()))})
    with pytest.warns(UserWarning, match=f"only {len(table)}/{len(table) + 1}"):
        ts.predict_int8(tmod, *args, table=partial)
    with pytest.raises(ValueError, match="unknown serving mode"):
        ts.predict_int8(tmod, *args, mode="fp8")


@pytest.mark.parametrize("m,k,n", [(16, 32, 32), (32, 12, 32), (32, 32, 20)])
def test_int8_matmul_shape_rule_raises(m, k, n):
    """cuBLAS's int8 GEMM takes m > 16 and k, n multiples of 8: another
    shape raises on either device, with no float fallback."""
    a = torch.zeros(m, k, dtype=torch.int8)
    b = torch.zeros(k, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="m > 16"):
        ts.int8_matmul(a, b)
    assert torch.equal(ts.int8_matmul(torch.ones(17, 8, dtype=torch.int8),
                                      torch.ones(8, 8, dtype=torch.int8)),
                       torch.full((17, 8), 8, dtype=torch.int32))


@pytest.mark.parametrize("which", ["small", "lsq_fib"])
def test_model_rate_report_matches_jax(which, request):
    _, tmod, variables, _, _ = request.getfixturevalue(which)
    want = jrate.model_rate_report(variables)
    got = trate.model_rate_report(tmod)
    assert set(got) == set(want)
    for key, row in want.items():
        assert set(got[key]) == set(row), key
        for name, value in row.items():
            assert got[key][name] == pytest.approx(value, rel=1e-12), (key, name)
    assert trate.symbol_entropy_bits(np.array([1, 1, 2, 2])) == 1.0


# --- the driver ---------------------------------------------------------------------

# experiments/int8_serving.py:135-165
JAX_RESULT_KEYS = {"nbits", "layers", "checkpoint", "nmse_f32", "nmse_int8", "nmse_int8_wo",
                   "split_f32", "split_int8", "split_int8_wo", "nmse_delta_db",
                   "nmse_delta_db_wo", "latency_ms_f32", "latency_ms_int8",
                   "latency_ms_int8_wo", "latency_speedup", "latency_speedup_wo"}
DRIVER_CFG = dict(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, d_ff=32)


def test_int8_driver_flags_match_the_jax_driver():
    """Every flag of ``experiments/int8_serving.py`` with its default, type,
    choices and nargs; the port adds ``--device``."""
    from channelestimationtransformer_torch.cli import int8_serving

    from test_torch_cli import _jax_flags, _port_flags

    want = _jax_flags("experiments/int8_serving.py")
    got = _port_flags(int8_serving.build_parser())
    assert set(got) == set(want) | {"--device"}
    for flag in want:
        assert got[flag] == want[flag], flag
    assert got["--device"]["default"] is None


def test_int8_driver_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """A small model at batch 16 from its checkpoint, 64 validation samples,
    2 batches: JAX's keys, the small stack's 29 layers (20 projections, 8
    FFN layers, a distil conv), the deltas from the NMSEs, latencies, and the
    newest flagship checkpoint taken by default (JAX's name filter)."""
    import functools
    import json
    import os

    from channelestimationtransformer_torch.cli import int8_serving
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.train.checkpoint import save_checkpoint
    from channelestimationtransformer_torch.train.trainer import create_train_state

    monkeypatch.setattr(int8_serving, "InformerConfig",
                        functools.partial(InformerConfig, **DRIVER_CFG))
    monkeypatch.setattr(int8_serving, "TrainConfig", functools.partial(TrainConfig, batch_size=16))
    model = build_informer(InformerConfig(**DRIVER_CFG), device="cpu", seed=1)
    state = create_train_state(model, TrainConfig())
    name = ("tmodel_ei_16_di_16_co_16_sl_90_ll_10_pl_5_f_5_dm_128_nh_8_el_[4, 3]_dl_3_df_64"
            "_do_0.05_at_full_em_fixed_ac_gelu_21_cal_v5_")
    weights = tmp_path / "weights"
    older = save_checkpoint(state, str(weights), name, 1)
    newest = save_checkpoint(state, str(weights), name, 2)
    os.utime(older, (1, 1))
    save_checkpoint(state, str(weights), name.replace("_sl_90_", "_sl_45_"), 3)
    monkeypatch.chdir(tmp_path)
    assert int8_serving.newest_flagship_checkpoint() == os.path.join("weights",
                                                                    os.path.basename(newest))
    out = tmp_path / "int8" / "int8_serving.json"
    res = int8_serving.main(["--device", "cpu", "--val-samples", "64", "--batches", "2",
                             "--calibrated", "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == [f"loaded weights/{os.path.basename(newest)} (epoch 2)",
                         "int8 layers: 29"]
    assert set(res) == JAX_RESULT_KEYS and json.loads(out.read_text()) == res
    assert json.loads(lines[-1]) == res
    assert res["layers"] == 29 and len(res["split_int8_wo"]) == 5
    assert res["nmse_delta_db"] == pytest.approx(
        10 * np.log10(res["nmse_int8"] / res["nmse_f32"]))
    assert res["nmse_int8"] != res["nmse_f32"] != res["nmse_int8_wo"]
    assert all(res[f"latency_ms_{m}"] > 0 for m in ("f32", "int8", "int8_wo"))
