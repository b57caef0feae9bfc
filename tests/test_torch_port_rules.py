"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
its entry points refuse to run on the CPU unless asked, its CUDA kernels'
build and wrappers never run at import, and its random draws in training
come from an explicit generator."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.channel.cdl import CDLModel, generate_cdl_channel
from channelestimationtransformer_torch.channel.dataset import generate_beamformed_dataset
from channelestimationtransformer_torch.cli import (
    ar_oracle,
    calibrate_channel,
    calibrate_fast,
    channel_spread,
    collect_e2e,
    collect_results,
    comparison,
    complexity_report,
    end_to_end_sim,
    eval_parity_ci,
    generate_dataset,
    int8_scale_ab,
    int8_serving,
    interleaved_ab,
    make_figures,
    pallas_ab,
    perf_study,
    prob_crossover,
    prob_profile,
    scale_demo,
    step_profile,
    timing_analysis,
    train_informer,
    train_streaming,
)
from channelestimationtransformer_torch.core.config import (
    InformerConfig,
    RecurrentConfig,
    TransformerConfig,
)
from channelestimationtransformer_torch.models import (
    build_recurrent,
    build_transformer,
    init_stream,
)
from channelestimationtransformer_torch.data.windows import WindowDataset
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.sim import simulate_ber, simulate_coded_ber

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "channelestimationtransformer_tpu",
             "experiments"}


def _port_files():
    files = sorted((ROOT / "channelestimationtransformer_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "attention_ablation.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("cli/train_informer.py", "cli/generate_dataset.py", "channel/cdl.py",
                   "channel/beamforming.py", "channel/dataset.py", "channel/interpolate.py",
                   "data/packing.py", "cli/ptq_sweep.py", "cli/qat_incremental.py",
                   "cli/prune.py", "cli/_study.py", "ops/prune.py", "ops/quant/auto_low.py",
                   "ops/quant/functional.py", "ops/quant/optim.py", "ops/quant/serving.py",
                   "ops/quant/rate.py", "models/transformer.py", "models/recurrent.py",
                   "models/streaming.py", "cli/int8_serving.py", "cli/comparison.py",
                   "cli/train_streaming.py", "sim/__init__.py", "sim/qam.py",
                   "sim/precoding.py", "sim/estimation.py", "sim/ofdm.py", "sim/coding.py",
                   "sim/ldpc.py", "sim/link.py", "cli/end_to_end_sim.py", "cli/collect_e2e.py",
                   "cli/scale_demo.py", "cli/int8_scale_ab.py", "parallel/launch.py",
                   "parallel/mesh.py", "parallel/sharding.py", "parallel/ring.py",
                   "parallel/collectives.py", "cli/scaling_study.py", "utils/complexity.py",
                   "utils/profiling.py", "utils/export.py", "utils/tensorboard.py",
                   "utils/figures.py", "utils/parse_logs.py", "native.py",
                   "cli/complexity_report.py", "cli/timing_analysis.py", "cli/ar_oracle.py",
                   "cli/collect_results.py", "cli/eval_parity_ci.py", "cli/make_figures.py",
                   "parallel/tensor.py", "cli/calibrate_channel.py", "cli/calibrate_fast.py",
                   "cli/prob_crossover.py", "cli/prob_profile.py", "cli/step_profile.py",
                   "cli/perf_study.py", "cli/interleaved_ab.py", "cli/pallas_ab.py",
                   "cli/channel_spread.py", "cli/multichip.py"):
        assert f"channelestimationtransformer_torch/{module}" in names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """With no CUDA device and no ``device``, the entry points raise (the
    model builder, the dataset, the channel generator, the link simulation
    and the command-line drivers, before they write anything); the batch
    and eval functions run where the dataset and model were placed, so they
    cannot reach the CPU unless the caller asked for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_informer(InformerConfig(d_model=16, n_heads=2, e_layers=(1,), d_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowDataset(h=np.zeros((2, 30, 16), np.float32), seq_len=20, pred_len=5,
                      snr_db=10.0)
    ds = WindowDataset(h=np.zeros((2, 30, 16), np.float32), seq_len=20, pred_len=5,
                       snr_db=10.0, device="cpu")
    assert ds.h.device.type == "cpu"
    # The channel generator and the drivers: the card unless the CPU is asked for.
    model = CDLModel(num_bs_ant=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_beamformed_dataset(0, model=model, num_samples=2, num_slots=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_cdl_channel(model, 2, 10, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_informer.main(["--d-model", "16", "--e-layers", "1", "--d-layers", "1",
                             "--train-samples", "8", "--val-samples", "8"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_dataset.main(["--num-samples", "2", "--num-slots", "10", "--out-dir",
                               str(tmp_path)])
    # The baselines, the stream state, int8 serving's and the comparison's drivers.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_transformer(TransformerConfig(d_model=16, n_heads=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_recurrent(RecurrentConfig(input_size=8, hidden_size=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_stream(2, InformerConfig())
    for cli, argv in ((int8_serving, ["--out", str(tmp_path / "int8.json")]),
                      (train_streaming, ["--checkpoint", "x.pt",
                                         "--out", str(tmp_path / "stream.json")]),
                      (comparison, ["--out", str(tmp_path / "cmp")]),
                      # the link and scale drivers
                      (end_to_end_sim, ["--checkpoint", "x.pt",
                                        "--out", str(tmp_path / "e2e.json")]),
                      (scale_demo, ["--sizes", "reference", "--out", str(tmp_path / "s.json")]),
                      (int8_scale_ab, ["--sizes", "reference",
                                       "--out", str(tmp_path / "ab.json")]),
                      # the analysis drivers that compute
                      (complexity_report, ["--out", str(tmp_path / "cx.json")]),
                      (timing_analysis, ["--params", "seq_len", "--out", str(tmp_path / "t.json")]),
                      (ar_oracle, ["--out", str(tmp_path / "ar.json")]),
                      (eval_parity_ci, ["--parity", "missing.json",
                                        "--out", str(tmp_path / "ci.json")]),
                      # the calibration and profiling drivers
                      (calibrate_channel, ["--out", str(tmp_path / "cal.json")]),
                      (calibrate_fast, ["--out", str(tmp_path / "calf.json")]),
                      (prob_crossover, ["--out", str(tmp_path / "pc.json")]),
                      (prob_profile, ["--out", str(tmp_path / "pp.json")]),
                      (step_profile, ["--out", str(tmp_path / "sp.json")]),
                      (perf_study, ["--out", str(tmp_path / "ps.json")]),
                      (interleaved_ab, ["--out", str(tmp_path / "ia.json")]),
                      (channel_spread, ["--out", str(tmp_path / "cs.json")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    # The link functions run where ``device`` says, the card by default.
    h = torch.eye(2, dtype=torch.complex64)[None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_ber(torch.Generator(), h, h, 6.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_coded_ber(torch.Generator(), h, h, 6.0)
    assert not any(tmp_path.iterdir())
    # The log and result collectors, the figures and the kernel A/B summary
    # compute on no device: they run without a card.
    assert collect_e2e.main(["--out", str(tmp_path / "e2e_branches.json")])
    monkeypatch.chdir(tmp_path)
    assert make_figures.main(["--weights-dir", str(tmp_path), "--out",
                              str(tmp_path / "figures")]) == []
    assert collect_results.main([str(tmp_path)])["sweeps"]["snr"]["rows"] == {}
    assert pallas_ab.main([str(tmp_path)]) is None  # no A/B run in the folder
    ber, total = simulate_ber(torch.Generator(), h, h, 30.0, device="cpu")
    assert float(ber) == 0.0 and total == 256
    h = generate_beamformed_dataset(0, model=model, num_samples=2, num_slots=10, device="cpu")
    assert h.device.type == "cpu" and h.shape == (2, 10, 2, 4, 2)


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone, and its mesh."""
    import torch.distributed as dist

    from channelestimationtransformer_torch.parallel.launch import _free_port, init_group
    from channelestimationtransformer_torch.parallel.mesh import make_mesh

    init_group(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(data=1, model=1, seq=1)
    finally:
        dist.destroy_process_group()


def test_unported_options_raise(world_of_one):
    """``attn="ring"`` builds with distil off and refuses distil on; a ring
    model trains (its ring has a backward: one ``_update`` on a seq axis of
    one equals the full model's with the same weights, rtol 2e-4 / atol
    2e-5); float16 builds and serves (f32 parameters, a float16 output),
    and a float dtype the port does not run (longdouble) raises."""
    from channelestimationtransformer_torch.train.trainer import TrainState, _update

    small = dict(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2, e_layers=(1,),
                 d_layers=1, dropout=0.0)
    with pytest.raises(ValueError, match="distil=False"):
        InformerConfig(attn="ring", **small)
    g = torch.Generator().manual_seed(0)
    batch = (torch.randn(2, 16, 16, generator=g), torch.randn(2, 6, 16, generator=g),
             torch.randn(2, 2, 16, generator=g))
    models = {}
    for attn in ("ring", "full"):
        model = build_informer(InformerConfig(attn=attn, distil=False, **small), device="cpu",
                               mesh=world_of_one)
        state = TrainState(model=model, optimizer=torch.optim.SGD(model.parameters(), lr=1.0),
                           schedule=lambda count: 1.0)
        _update(state, *batch, torch.Generator().manual_seed(1))
        models[attn] = model
    assert models["ring"].encoder.layer_0.attention.attn == "ring"
    assert models["ring"].decoder.layer_0.self_attention.attn == "full"
    want = models["full"].state_dict()
    for name, t in models["ring"].state_dict().items():
        assert torch.allclose(t, want[name], rtol=2e-4, atol=2e-5), name
    f16 = build_informer(InformerConfig(dtype="float16", **small), device="cpu").eval()
    with torch.no_grad():
        out = f16(batch[0], batch[1])
    assert out.dtype == torch.float16 and torch.isfinite(out).all()
    assert all(p.dtype == torch.float32 for p in f16.parameters())
    with pytest.raises(NotImplementedError, match="float16"):
        build_informer(InformerConfig(dtype="longdouble"), device="cpu")


def test_model_serves_only_in_eval_mode():
    """Built models serve: eval mode needs no generator and is
    deterministic. Train mode with dropout refuses to run without one."""
    model = build_informer(InformerConfig(d_model=16, n_heads=2, e_layers=(1,), d_layers=1),
                           device="cpu")
    assert not model.training
    x_enc, x_dec = torch.randn(2, 90, 16), torch.randn(2, 15, 16)
    with torch.no_grad():
        assert torch.equal(model(x_enc, x_dec), model(x_enc, x_dec))
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(x_enc, x_dec)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_trains_with_a_generator(use_pallas):
    """Train mode runs from an explicit generator (same seed, same output;
    the global RNG is not read), updates the BatchNorm statistics, and gives
    every parameter a gradient."""
    cfg = InformerConfig(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1, dropout=0.1,
                         use_pallas=use_pallas)
    model = build_informer(cfg, device="cpu").train()
    x_enc, x_dec = torch.randn(4, 90, 16), torch.randn(4, 15, 16)
    norm = model.encoder.encoder_0.distil_0.norm
    before = norm.running_var.clone()
    outs = []
    for _ in range(2):
        torch.manual_seed(len(outs))  # a different global RNG state each time
        outs.append(model(x_enc, x_dec, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], model(x_enc, x_dec, generator=torch.Generator().manual_seed(4)))
    assert not torch.equal(norm.running_var, before) and norm.num_batches_tracked == 3
    outs[0].square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def test_build_is_seeded():
    cfg = InformerConfig(d_model=16, n_heads=2, e_layers=(2, 1), d_layers=1)
    a, b, c = (build_informer(cfg, device="cpu", seed=s).state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["projection.weight"], c["projection.weight"])
    # flax's lecun-normal: truncated at 2 std, variance 1/fan_in.
    w = build_informer(InformerConfig(), device="cpu").state_dict()[
        "encoder.encoder_0.layer_0.attention.query.weight"]
    assert abs(w.std().item() - (1 / 128) ** 0.5) < 0.1 * (1 / 128) ** 0.5


def test_multichip_runs_on_the_card_unless_asked(monkeypatch):
    """``cli/multichip.py`` raises without a card before it starts a rank,
    and its ``entry`` too; asked for the CPU, ``entry`` gives the flagship
    forward at batch 8 (``__graft_entry__.py:entry``'s shapes)."""
    from channelestimationtransformer_torch.cli import multichip

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        m.setattr(multichip.launch, "run_local",
                  lambda *a, **k: pytest.fail("a rank was started"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multichip.main(["--n-devices", "1"])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            multichip.entry()
    fn, (model, x_enc, x_dec) = multichip.entry("cpu")
    cfg = InformerConfig()
    assert x_enc.shape == (8, cfg.seq_len, cfg.enc_in) and x_dec.shape == (8, cfg.dec_len,
                                                                            cfg.dec_in)
    out = fn(model, x_enc, x_dec)
    assert out.shape == (8, cfg.pred_len, cfg.c_out) and bool(torch.isfinite(out).all())
    assert [multichip.model_axis(n) for n in (1, 2, 3, 4, 6, 8)] == [1, 1, 1, 2, 2, 2]


class _FakeMesh:
    """A ``(data, model, seq)`` mesh of the given sizes seen from its first
    rank, with no process group behind its axes (no collective runs)."""

    def __init__(self, **sizes):
        self.sizes = sizes
        self.mesh_dim_names = ("data", "model", "seq")
        self.shape = tuple(sizes[a] for a in self.mesh_dim_names)

    def __getitem__(self, axis):
        return type("Axis", (), {"size": lambda _: self.sizes[axis]})()

    def get_group(self, axis):
        return ("fake", axis)


@pytest.fixture
def fake_axes(monkeypatch, world_of_one):
    """``dist.get_world_size`` / ``get_rank`` answer for a fake mesh's axes
    (rank 0 of each); a real group of one stands behind everything else."""
    import torch.distributed as dist

    size, rank = dist.get_world_size, dist.get_rank
    sizes = {}

    def fake_size(group=None):
        return sizes[group[1]] if isinstance(group, tuple) else size(group)

    monkeypatch.setattr(dist, "get_world_size", fake_size)
    monkeypatch.setattr(dist, "get_rank",
                        lambda group=None: 0 if isinstance(group, tuple) else rank(group))

    def mesh(**kw):
        sizes.update(kw)
        return _FakeMesh(**kw)
    return mesh


def test_every_model_takes_a_model_axis(fake_axes):
    """Tensor parallelism at model 2 raises for no model the port builds
    (the Informer, the InformerStack, fused QKV, LSQ and LSQ-fibbinary, the
    Transformer, the RNN, GRU and LSTM predictors): every weight
    ``param_shardings`` shards keeps half its rows, in a column-parallel
    layer or one that gathers it at use."""
    from channelestimationtransformer_torch.models.informer_lsq import build_informer_lsq
    from channelestimationtransformer_torch.parallel.sharding import param_shardings
    from channelestimationtransformer_torch.parallel.tensor import sharded_names, tensor_parallel

    small = dict(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2, e_layers=(2, 1),
                 d_layers=1, d_ff=16)
    models = {
        "informer": build_informer(InformerConfig(**dict(small, e_layers=2)), device="cpu"),
        "stack": build_informer(InformerConfig(**small), device="cpu"),
        "fused": build_informer(InformerConfig(**small, fuse_qkv=True), device="cpu"),
        "lsq": build_informer_lsq(InformerConfig(**small), nbits=8, device="cpu"),
        "lsq_fibbinary": build_informer_lsq(InformerConfig(**small), nbits=8, fibbinary=True,
                                            device="cpu"),
        "transformer": build_transformer(TransformerConfig(d_model=16, n_heads=2, d_ff=16),
                                         device="cpu"),
        **{cell: build_recurrent(RecurrentConfig(input_size=8, hidden_size=8, cell=cell),
                                 device="cpu") for cell in ("rnn", "gru", "lstm")},
    }
    mesh = fake_axes(data=1, model=2, seq=1)
    for name, model in models.items():
        full = {n: p.shape for n, p in model.named_parameters()}
        want = {n for n, p in param_shardings(model, mesh).items() if not p.is_replicate()}
        tensor_parallel(model, mesh)
        assert sharded_names(model) == want and want, name
        for n, p in model.named_parameters():
            rows = full[n][0] // 2 if n in want else full[n][0] if full[n] else None
            assert (p.shape[0] if p.ndim else None) == rows, (name, n)


def test_trainer_takes_a_two_axis_mesh(fake_axes):
    """``Trainer`` takes a data 2 x model 2 mesh (it raised before tensor
    parallelism composed with the other axes): the model keeps its shards,
    the training set its data coordinate's half, and the optimizer holds
    the shards."""
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.parallel.tensor import sharded_names
    from channelestimationtransformer_torch.train.trainer import Trainer

    cfg = InformerConfig(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2,
                         e_layers=(1,), d_layers=1, d_ff=16)
    data = [WindowDataset(h=torch.zeros(n, 20, 16), seq_len=16, pred_len=2, snr_db=20.0,
                          device="cpu") for n in (8, 2)]
    t = Trainer(build_informer(cfg, device="cpu"), cfg, TrainConfig(batch_size=4), *data,
                mesh=fake_axes(data=2, model=2, seq=1), log=lambda msg: None)
    assert t._tp and t._train.h.shape[0] == 4 and sharded_names(t.model)
    held = {id(p) for g in t.state.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in t.model.parameters()}
