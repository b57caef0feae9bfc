"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
its entry points refuse to run on the CPU unless asked, its CUDA kernels'
build and wrappers never run at import, and its random draws in training
come from an explicit generator."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from channelestimationtransformer_torch.core.config import InformerConfig
from channelestimationtransformer_torch.data.windows import WindowDataset
from channelestimationtransformer_torch.models.informer import build_informer

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "channelestimationtransformer_tpu",
             "experiments"}


def _port_files():
    files = sorted((ROOT / "channelestimationtransformer_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


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
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device and no ``device``, the entry points raise; the
    batch and eval functions run where the dataset and model were placed,
    so they cannot reach the CPU unless the caller asked for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_informer(InformerConfig(d_model=16, n_heads=2, e_layers=(1,), d_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowDataset(h=np.zeros((2, 30, 16), np.float32), seq_len=20, pred_len=5,
                      snr_db=10.0)
    ds = WindowDataset(h=np.zeros((2, 30, 16), np.float32), seq_len=20, pred_len=5,
                       snr_db=10.0, device="cpu")
    assert ds.h.device.type == "cpu"


def test_unported_options_raise():
    for kwargs in (dict(attn="prob"), dict(fuse_qkv=True), dict(dtype="bfloat16")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_informer(InformerConfig(**kwargs), device="cpu")


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
