"""The benchmark's plain reference against the port, at tiny sizes on the
CPU (the test may import the port; the reference may not), and the
reference's counts at the configurations' own widths."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import check, draws
from portbench.program import Program
from portbench.reference import informer_stack as ref
from portbench.reference import philox

HARNESS = Path(__file__).resolve().parents[1]


def config(name: str, **model) -> dict:
    cfg = json.loads((HARNESS / "configs" / f"{name}.json").read_text())
    cfg["model"].update(model)
    return cfg


def tiny(dtype: str = "float32") -> dict:
    cfg = config("flagship-f32", d_model=32, n_heads=4, d_ff=16, seq_len=24, e_layers=[2, 1],
                 d_layers=2, dtype=dtype)
    cfg["data"].update(samples=32, slots=32)
    return cfg


def ref_cfg(cfg: dict) -> dict:
    return {**cfg["model"], "snr_db": cfg["data"]["snr_db"]}


def port_model(cfg: dict):
    from channelestimationtransformer_torch.core.config import InformerConfig
    from channelestimationtransformer_torch.models.informer import InformerStack

    model = dict(cfg["model"], e_layers=tuple(cfg["model"]["e_layers"]))
    with torch.device("meta"):
        return InformerStack(InformerConfig(**model))


# the port's scale study's xl widths (cli/scale_demo.py SIZES), no cell of its own
XL = {"d_model": 1024, "d_ff": 4096, "seq_len": 256, "dtype": "bfloat16"}


@pytest.mark.parametrize("widths", [{}, XL], ids=["flagship", "xl"])
def test_parameter_spec_is_the_ports_state_dict(widths):
    cfg = config("flagship-f32", **widths)
    want = {k: tuple(v.shape) for k, v in port_model(cfg).state_dict().items()}
    got = {n: tuple(s) for n, s, _ in ref.parameter_spec(cfg["model"])}
    assert got == want


def test_xl_has_the_scale_studys_parameters():
    spec = ref.parameter_spec(config("flagship-f32", **XL)["model"])
    shapes = {n: s for n, s, _ in spec}
    assert sum(torch.Size(shapes[n]).numel() for n in ref.trainable(spec)) == 154_428_432


def test_flagship_forward_macs():
    # 43,688,704 MACs a window (matmuls, convolutions and attention products)
    assert ref.flops_per_sample(config("flagship-f32")["model"], train=False) == 2 * 43_688_704


def test_training_flops_count_the_backward():
    model = config("flagship-f32")["model"]
    fwd = ref.flops_per_sample(model, train=False)
    assert 2.5 * fwd < ref.flops_per_sample(model, train=True) < 3.5 * fwd


@pytest.mark.parametrize("shape", [(2, 3, 15, 15), (1, 2, 90, 90), (3, 1, 15, 24), (2, 2, 7, 5)])
def test_keep_mask_is_the_ports(shape):
    from channelestimationtransformer_torch.ops.cuda.bd_attention import dropout_keep_mask

    gen = torch.Generator().manual_seed(sum(shape))
    seed = philox.draw_seed(gen, "cpu")
    assert torch.equal(philox.keep_mask(seed, *shape, 0.95),
                       dropout_keep_mask(seed, *shape, 0.95))


def test_make_batch_is_the_ports():
    from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch

    cfg = tiny()
    m = cfg["model"]
    h = draws.dataset(cfg, 3, "cpu")
    gen = draws.generator("cpu", 3, draws.TRAIN, 0)
    d = ref.draw_batch(gen, 32, 32, m["seq_len"] + m["pred_len"], 8, 16, "cpu")
    ds = WindowDataset(h=h, seq_len=m["seq_len"], pred_len=m["pred_len"],
                       snr_db=cfg["data"]["snr_db"], device="cpu")
    got = make_batch(ds, 8, m["label_len"], idx=d[0], starts=d[1], noise=d[2])
    for g, w in zip(got, ref.make_batch(h, ref_cfg(cfg), *d)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_learning_rate_is_the_ports_schedule():
    from channelestimationtransformer_torch.core.config import TrainConfig
    from channelestimationtransformer_torch.train.trainer import make_schedule

    for train in (config("flagship-f32")["train"],
                  dict(config("flagship-f32")["train"], warmup_steps=0),
                  dict(config("flagship-f32")["train"], schedule="constant")):
        fields = {f.name for f in dataclasses.fields(TrainConfig)}
        port = make_schedule(TrainConfig(**{k: v for k, v in train.items() if k in fields}))
        for count in (0, 1, 2, 999, 1000, 1001, 11_000, 22_599, 22_600, 30_000):
            assert ref.learning_rate(count, train) == pytest.approx(port(count), rel=1e-12)


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-10), ("bfloat16", 1e-3)])
def test_predict_is_the_ports_eval_forward(dtype, limit):
    cfg = tiny(dtype)
    h = draws.dataset(cfg, 5, "cpu")
    spec = ref.parameter_spec(cfg["model"])
    prog = Program(cfg, draws.weights(spec, 5, "cpu"), h, torch.device("cpu"))
    got, want = [], []
    for r in draws.serve_draws(cfg, 8, 2, 5, "cpu"):
        got.append(prog.serve(8, *r).float())
        want.append(ref.predict(draws.weights(spec, 5, "cpu"), ref_cfg(cfg), h, *r,
                                ref.Precision("float32")))
    assert check.serve_numbers(got, want)["nmse"] < limit


def test_train_steps_are_the_ports():
    cfg = tiny()
    h = draws.dataset(cfg, 6, "cpu")
    spec = ref.parameter_spec(cfg["model"])
    train = {**cfg["train"], "batch": 8}
    prog = Program(cfg, draws.weights(spec, 6, "cpu"), h, torch.device("cpu"))
    prog.train_state(train)
    losses = []
    for c in range(3):
        losses.append(float(prog.train_chunk(1, 8, draws.generator("cpu", 6, draws.TRAIN, c))))
        if c == 0:
            grads = {n: float(g.norm()) for n, g in prog.first_gradients(0.9).items()}
    w0 = draws.weights(spec, 6, "cpu")
    change = {n: float((p.detach() - w0[n]).norm()) for n, p in prog.parameters().items()}
    gens = [draws.generator("cpu", 6, draws.TRAIN, c) for c in range(3)]
    want = ref.train_steps(w0, ref_cfg(cfg), train, h, gens, ref.Precision("float32"))
    numbers = check.train_numbers({"losses": losses, "grad_norms": grads,
                                   "change_norms": change}, want)
    assert numbers["loss"] < 1e-5 and numbers["grad"] < 1e-4 and numbers["change"] < 1e-3


def test_fp8_control_rounds_every_product():
    prec = ref.Precision("fp8")
    x = torch.linspace(-3.0, 3.0, 1001)
    q = prec.q(x)
    assert q.abs().max() == pytest.approx(3.0)
    assert 1e-3 < float((q - x).abs().max()) < 0.2
    assert torch.equal(ref.Precision("float32").q(x), x)
