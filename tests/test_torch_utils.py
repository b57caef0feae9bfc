"""The port's utilities (``utils/``: parse_logs, tensorboard, profiling,
complexity, export; ``native.py``) against the JAX package's.

- ``parse_logs`` equal to JAX's on every committed log and on a log the
  port's ``Trainer`` writes;
- ``MetricsWriter``'s two branches (TensorBoard events, and the JSONL file
  when the ``tensorboard`` import fails), each with the reference's scalars;
- ``count_params`` of the five models equal to ``complexity.json``, and
  ``estimate_macs`` equal to a walk of JAX's jaxpr over ``dot_general`` and
  ``conv_general_dilated`` (a ``scan`` body times its trip count): the
  flagship's 43,688,704 a sample;
- ``export_weights_json`` and ``weight_dynamic_range`` equal to JAX's on the
  same weights, through ``from_flax`` and ``to_flax``;
- ``native`` against JAX's binding, function by function, and against the
  port's plain versions of the quant kernels and packing, bit for bit;
- the profiling helpers run on the CPU (no time is asserted).
"""

import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.extend import core as jcore

from channelestimationtransformer_tpu import native as jax_native
from channelestimationtransformer_tpu.core import config as jconfig
from channelestimationtransformer_tpu.models import build_informer as jax_build_informer
from channelestimationtransformer_tpu.models.recurrent import RecurrentPredictor as JaxRecurrent
from channelestimationtransformer_tpu.models.transformer import Transformer as JaxTransformer
from channelestimationtransformer_tpu.utils import export as jax_export
from channelestimationtransformer_tpu.utils import parse_logs as jax_parse_logs

from channelestimationtransformer_torch import native
from channelestimationtransformer_torch.cli import train_informer
from channelestimationtransformer_torch.core.config import (
    InformerConfig,
    RecurrentConfig,
    TransformerConfig,
)
from channelestimationtransformer_torch.data.packing import complex_to_real
from channelestimationtransformer_torch.models import build_recurrent, build_transformer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.ops.cuda.quant import (
    fixed_point_quantize_reference,
    nearest_codeword_reference,
)
from channelestimationtransformer_torch.ops.quant import codebooks
from channelestimationtransformer_torch.utils import (
    MetricsWriter,
    count_params,
    device_memory_stats,
    estimate_macs,
    export_graph,
    export_weights_json,
    final_valid_losses,
    model_complexity,
    parse_log_file,
    parse_log_text,
    throughput,
    time_fn,
    time_fn_amortized,
    to_flax,
    trace,
    weight_dynamic_range,
)
from channelestimationtransformer_torch.utils.convert import (
    from_flax_recurrent,
    from_flax_transformer,
)

from test_torch_cli import SMALL as CLI_SMALL
from test_torch_informer import SMALL, _model_pair

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMPLEXITY = json.loads((ROOT / "experiments/artifacts/complexity.json").read_text())
SCALARS = {"Loss/train", "Loss/val"} | {f"Loss/val{i}" for i in range(1, 6)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- parse_logs ---------------------------------------------------------------

def test_parse_logs_equal_jax_on_every_committed_log():
    logs = sorted((ROOT / "logs").glob("*.log"))
    assert len(logs) > 100
    parsed_any = 0
    for path in logs:
        want = jax_parse_logs.parse_log_file(str(path))
        got = parse_log_file(str(path))
        assert got == want, path.name
        assert final_valid_losses(got) == jax_parse_logs.final_valid_losses(want)
        parsed_any += bool(want)
    assert parsed_any > 10


def test_parse_logs_equal_jax_on_the_port_trainers_log(tmp_path, capsys):
    result = train_informer.main(CLI_SMALL + ["--epochs", "2", "--steps-per-epoch", "2",
                                              "--log-every", "1", "--out", str(tmp_path)])
    text = capsys.readouterr().out
    got = parse_log_text(text)
    assert got == jax_parse_logs.parse_log_text(text)
    run = got[result["name"]]
    assert run["epochs"] == [0, 1] and len(run["ms_per_batch"]) == 2  # the last chunk unlogged
    assert all(len(s) == 5 for s in run["split"])
    assert run["valid_loss"][-1] == pytest.approx(np.mean(result["final_val_split"]), rel=1e-6)


# --- tensorboard -----------------------------------------------------------------

def read_scalars(logdir) -> dict:
    """``{tag: [(step, value), ...]}`` from a MetricsWriter's folder, either branch."""
    logdir = pathlib.Path(logdir)
    jsonl = logdir / "events.jsonl"
    out = {}
    if jsonl.exists():
        for line in jsonl.read_text().splitlines():
            e = json.loads(line)
            out.setdefault(e["tag"], []).append((e["step"], e["value"]))
        return out
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    for tag in acc.Tags()["scalars"]:
        out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
    return out


@pytest.mark.parametrize("branch", ["tensorboard", "jsonl"])
def test_metrics_writer_logs_the_reference_scalars(branch, tmp_path, monkeypatch):
    if branch == "tensorboard":
        pytest.importorskip("tensorboard")
    else:  # a machine without the tensorboard package: the import fails
        monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = MetricsWriter(str(tmp_path / "run"))
    assert (writer._tb is None) == (branch == "jsonl")
    for epoch in range(2):
        writer.log_epoch(epoch, 1.5 - epoch, 0.25 / (epoch + 1), [0.1, 0.2, 0.3, 0.4, 0.5])
    writer.close()
    scalars = read_scalars(tmp_path / "run")
    assert set(scalars) == SCALARS
    assert scalars["Loss/train"] == [(0, 1.5), (1, 0.5)]
    assert scalars["Loss/val"] == [(0, 0.25), (1, 0.125)]
    assert [v for _, v in scalars["Loss/val3"]] == pytest.approx([0.3, 0.3])
    assert ((tmp_path / "run" / "events.jsonl").exists()) == (branch == "jsonl")


# --- complexity -----------------------------------------------------------------

def _sub_jaxprs(value):
    if isinstance(value, jcore.ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, jcore.Jaxpr):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _sub_jaxprs(v)


def jaxpr_macs(jaxpr) -> int:
    """Multiply-accumulates of every ``dot_general`` and
    ``conv_general_dilated`` of ``jaxpr``, sub-jaxprs included, a ``scan``
    body counted once per trip."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += (int(np.prod(eqn.outvars[0].aval.shape))
                      * int(np.prod([lhs[i] for i in contract])))
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            out_feature = eqn.params["dimension_numbers"].rhs_spec[0]
            total += int(np.prod(eqn.outvars[0].aval.shape)) * int(np.prod(rhs)) // rhs[out_feature]
        assert name != "while", "a loop of unknown trip count"
        trips = eqn.params["length"] if name == "scan" else 1
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                total += trips * jaxpr_macs(sub)
    return total


def _jax_macs(module, *inputs) -> int:
    """The jaxpr count of ``module.apply`` (traced on the variables' shapes
    alone: nothing is computed)."""
    variables = jax.eval_shape(module.init, jax.random.key(0), *inputs)
    return jaxpr_macs(jax.make_jaxpr(lambda v, *a: module.apply(v, *a))(variables, *inputs).jaxpr)


def _five_models(batch):
    """(name, JAX module, port model, JAX inputs, port inputs) as
    ``experiments/complexity_report.py:42-66`` builds them."""
    icfg = InformerConfig()
    x_enc, x_dec = np.zeros((batch, 90, 16), np.float32), np.zeros((batch, 15, 16), np.float32)
    yield ("informer_stack", jax_build_informer(jconfig.InformerConfig()),
           build_informer(icfg, device="cpu"), (x_enc, x_dec))
    tcfg = TransformerConfig()
    yield ("transformer", JaxTransformer(config=jconfig.TransformerConfig()),
           build_transformer(tcfg, device="cpu"),
           (x_enc, np.zeros((batch, tcfg.dec_len, 16), np.float32)))
    for cell in ("rnn", "gru", "lstm"):
        yield (cell, JaxRecurrent(config=jconfig.RecurrentConfig(cell=cell)),
               build_recurrent(RecurrentConfig(cell=cell), device="cpu"), (x_enc,))


@pytest.mark.parametrize("name", ["informer_stack", "transformer", "rnn", "gru", "lstm"])
def test_complexity_equals_the_jaxpr_count_and_the_committed_params(name):
    """At batch 1: the parameters equal ``complexity.json``'s and the MACs
    the jaxpr count (the flagship 43,688,704; XLA's committed count adds the
    elementwise work, and its recurrent counts a scan body times T - 1)."""
    _, fmod, model, inputs = next(m for m in _five_models(1) if m[0] == name)
    got = model_complexity(model, *map(torch.from_numpy, inputs))
    assert got["params"] == COMPLEXITY[name]["params"]
    assert count_params(model) == COMPLEXITY[name]["params"]
    want = _jax_macs(fmod, *map(jnp.asarray, inputs))
    assert got["macs_total"] == got["macs_per_sample"] == want > 0
    if name == "informer_stack":
        assert want == 43_688_704
        assert COMPLEXITY[name]["macs_per_sample"] == 44_853_756  # XLA's, elementwise too


def test_estimate_macs_small_config_kernel_route_and_batch():
    """A small stack at batch 3: the plain path's count equals the jaxpr's;
    a ``use_pallas`` model is counted on its plain twin and gives the same,
    and BatchNorm buffers are not parameters."""
    rng = np.random.default_rng(0)
    fmod, tmod, params, stats, x_enc, x_dec = _model_pair(rng, 3, **SMALL)
    want = jaxpr_macs(jax.make_jaxpr(lambda p, s, a, b: fmod.apply(
        {"params": p, "batch_stats": s}, a, b))(params, stats, x_enc, x_dec).jaxpr)
    args = (torch.from_numpy(x_enc), torch.from_numpy(x_dec))
    assert estimate_macs(tmod, *args) == want
    kernel = build_informer(InformerConfig(use_pallas=True, **SMALL), device="cpu")
    report = model_complexity(kernel, *args)
    assert report["macs_total"] == want and report["macs_per_sample"] == want / 3
    assert kernel.encoder.encoder_0.layer_0.attention.use_pallas  # the model is left as it was
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert report["params"] == n_flax < sum(t.numel() for t in tmod.state_dict().values())


# --- export -----------------------------------------------------------------------

def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype == np.float32


def test_export_weights_json_and_dynamic_range_equal_jax(tmp_path):
    """The same weights (flax's, through ``from_flax``) dump to the same JSON
    file, byte for byte, and give the same dynamic-range report; ``to_flax``
    gives back flax's params and BatchNorm statistics exactly."""
    rng = np.random.default_rng(1)
    _, tmod, params, stats, _, _ = _model_pair(rng, 2, **SMALL)
    back_params, back_stats = to_flax(tmod.state_dict())
    _tree_equal(back_params, params)
    _tree_equal(back_stats, stats)
    jax_export.export_weights_json(params, str(tmp_path / "jax.json"))
    export_weights_json(tmod, str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert weight_dynamic_range(tmod) == jax_export.weight_dynamic_range(params)
    assert weight_dynamic_range(tmod.state_dict()) == weight_dynamic_range(tmod)


def test_to_flax_inverts_the_baselines_bridges():
    """The Transformer and the three recurrent cells' stacked gates."""
    x = jnp.zeros((1, 90, 16))
    tparams = JaxTransformer(config=jconfig.TransformerConfig()).init(
        jax.random.key(0), x, jnp.zeros((1, 15, 16)))["params"]
    tparams = jax.tree.map(np.asarray, tparams)
    state = {k: v for k, v in from_flax_transformer(tparams).items()}
    _tree_equal(to_flax(state)[0], tparams)
    for cell in ("rnn", "gru", "lstm"):
        rparams = JaxRecurrent(config=jconfig.RecurrentConfig(cell=cell, input_size=8,
                                                              hidden_size=12)).init(
            jax.random.key(1), x)["params"]
        rparams = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.01), rparams)
        _tree_equal(to_flax(from_flax_recurrent(rparams))[0], rparams)
    with pytest.raises(KeyError, match="no flax counterpart"):
        to_flax({"layer.unknown": torch.zeros(2)})


def test_export_graph_writes_the_plain_paths_program(tmp_path):
    model = build_informer(InformerConfig(use_pallas=True, **SMALL), device="cpu")
    path = export_graph(model, torch.zeros(2, 24, 16), torch.zeros(2, 11, 16),
                        path=str(tmp_path / "graph.txt"))
    text = pathlib.Path(path).read_text()
    assert "ExportedProgram" in text and ("aten.bmm" in text or "aten.einsum" in text)
    assert model.encoder.encoder_0.layer_0.attention.use_pallas


# --- native -------------------------------------------------------------------------

@pytest.fixture
def jax_binding():
    """The JAX package's binding, which builds its library on first use
    (decided here, not at import)."""
    if not jax_native.available():
        pytest.skip("the JAX package's native library does not build here")
    return jax_native


def _quant_input(n=20011, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    x[:8] = [0.0, -0.0, 0.03125, -0.03125, 0.09375, 7.96875, -8.0, 100.0]  # ties, +-0, clamp
    return x


@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_native_fixed_point_equals_jax_binding(rounding, jax_binding):
    x = _quant_input()
    for wl, fl, symmetric, clamp in ((8, 4, False, True), (4, 0, True, True), (15, 11, False,
                                                                                False)):
        kw = dict(clamp=clamp, symmetric=symmetric, rounding=rounding, seed=7)
        np.testing.assert_array_equal(native.fixed_point_quantize(x, wl, fl, **kw),
                                      jax_binding.fixed_point_quantize(x, wl, fl, **kw))


def test_native_partial_codeword_fibbinary_and_packing_equal_jax_binding(jax_binding):
    x = _quant_input(seed=1).reshape(-1, 1)
    for pct, proximal in ((0.0, True), (0.3, True), (0.7, False), (1.0, False)):
        np.testing.assert_array_equal(
            native.fixed_point_quantize_partial(x, pct, 8, 4, proximal=proximal),
            jax_binding.fixed_point_quantize_partial(x, pct, 8, 4, proximal=proximal))
    cb = codebooks.lsq_fibbinary_codebook(6)
    np.testing.assert_array_equal(native.nearest_codeword(x * 8, cb),
                                  jax_binding.nearest_codeword(x * 8, cb))
    for bits in (1, 5, 12):
        np.testing.assert_array_equal(native.fibbinary_ints(bits), jax_binding.fibbinary_ints(bits))
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((5, 30, 2, 4)) + 1j * rng.standard_normal((5, 30, 2, 4))).astype(
        np.complex64)
    starts = rng.integers(0, 11, size=5)
    np.testing.assert_array_equal(native.pack_windows(h, starts, 20),
                                  jax_binding.pack_windows(h, starts, 20))


def test_native_equals_the_ports_plain_versions():
    """Bit for bit with what ``chip_smoke.py`` holds it to on the card: the
    fixed-point and codeword kernels' plain versions and the packing; the
    stochastic rounding (another random stream) by its mean."""
    x = _quant_input(seed=3)
    for wl, fl, symmetric, clamp in ((8, 4, False, True), (4, 0, True, True), (2, -2, False,
                                                                               True)):
        want = fixed_point_quantize_reference(torch.from_numpy(x), wl, fl, clamp=clamp,
                                              symmetric=symmetric).numpy()
        np.testing.assert_array_equal(
            native.fixed_point_quantize(x, wl, fl, clamp=clamp, symmetric=symmetric), want)
    for cb in (codebooks.lsq_fibbinary_codebook(8), codebooks.fibbinary_codebook(8, 4)):
        np.testing.assert_array_equal(
            native.nearest_codeword(x, cb),
            nearest_codeword_reference(torch.from_numpy(x), torch.from_numpy(cb)).numpy())
    rng = np.random.default_rng(4)
    h = (rng.standard_normal((6, 40, 2, 4)) + 1j * rng.standard_normal((6, 40, 2, 4))).astype(
        np.complex64)
    starts = rng.integers(0, 16, size=6)
    packed = complex_to_real(torch.from_numpy(h)).numpy()
    want = np.stack([packed[i, s:s + 25] for i, s in enumerate(starts)])
    np.testing.assert_array_equal(native.pack_windows(h, starts, 25), want)
    u = (rng.random(1 << 18) * 2 - 1).astype(np.float32)
    got = native.fixed_point_quantize(u, 8, 4, rounding="stochastic", seed=11)
    res = 2.0 ** -4
    assert set(np.unique(got / res)) <= set(range(-16, 17))
    assert abs(float(got.mean()) - float(u.mean())) < 4 * res / 2 / np.sqrt(u.size)


def test_native_build_failure_raises_with_the_log(monkeypatch, tmp_path):
    with monkeypatch.context() as m:
        m.setattr(native, "BUILD_DIR", tmp_path)
        m.setenv("CXX", "false")
        native._load.cache_clear()
        assert not native.available()
        with pytest.raises(RuntimeError, match="false failed on"):
            native.fibbinary_ints(4)
    native._load.cache_clear()
    assert native.available() and not any(tmp_path.iterdir())


# --- profiling -----------------------------------------------------------------------

def test_profiling_helpers_on_the_cpu(tmp_path, monkeypatch):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with trace(str(tmp_path / "tr")) as prof:
        torch.mm(a, b)
    events = json.loads(pathlib.Path(prof.trace_path).read_text())["traceEvents"]
    assert pathlib.Path(prof.trace_path).parent == tmp_path / "tr"
    assert any(e.get("name") == "aten::mm" for e in events)
    for mean, std in (time_fn(torch.mm, a, b, warmup=1, reps=3),
                      time_fn_amortized(torch.mm, a, b, inner=2, warmup=1, reps=3)):
        assert np.isfinite(mean) and mean > 0 and std >= 0
    assert throughput(torch.mm, a, b, batch=64, warmup=1, reps=2) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_memory_stats() is None
