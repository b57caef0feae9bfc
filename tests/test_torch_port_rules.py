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
    collect_e2e,
    comparison,
    end_to_end_sim,
    generate_dataset,
    int8_scale_ab,
    int8_serving,
    scale_demo,
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
                   "parallel/collectives.py", "cli/scaling_study.py"):
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
                                       "--out", str(tmp_path / "ab.json")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    # The link functions run where ``device`` says, the card by default.
    h = torch.eye(2, dtype=torch.complex64)[None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_ber(torch.Generator(), h, h, 6.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_coded_ber(torch.Generator(), h, h, 6.0)
    assert not any(tmp_path.iterdir())
    # The log collector computes on no device: it runs without a card.
    assert collect_e2e.main(["--out", str(tmp_path / "e2e_branches.json")])
    ber, total = simulate_ber(torch.Generator(), h, h, 30.0, device="cpu")
    assert float(ber) == 0.0 and total == 256
    h = generate_beamformed_dataset(0, model=model, num_samples=2, num_slots=10, device="cpu")
    assert h.device.type == "cpu" and h.shape == (2, 10, 2, 4, 2)


def test_unported_options_raise():
    """``attn="ring"`` builds with distil off and refuses distil on; a ring
    model under autograd raises before its ring touches the mesh (the
    ring's backward is not ported); float16 is not ported."""
    small = dict(seq_len=16, label_len=4, pred_len=2, d_model=16, n_heads=2, e_layers=(1,),
                 d_layers=1, dropout=0.0)
    with pytest.raises(ValueError, match="distil=False"):
        InformerConfig(attn="ring", **small)
    model = build_informer(InformerConfig(attn="ring", distil=False, **small), device="cpu",
                           mesh=object()).train()
    assert model.encoder.layer_0.attention.attn == "ring"
    assert model.decoder.layer_0.self_attention.attn == "full"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        model(torch.randn(2, 16, 16), torch.randn(2, 6, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_informer(InformerConfig(dtype="float16"), device="cpu")


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
