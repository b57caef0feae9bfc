"""The port's profiler spans (``core/runtime.py:span``) on the CPU: nothing
is recorded without a profiler, one training step under a profiler gives
one ``cet.step`` holding its four phases in order and one ``cet.conv`` a
circular convolution, a served batch gives the data and model spans alone,
and a step under the profiler takes the same numbers, bit for bit, as one
without it."""

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile

from channelestimationtransformer_torch.core import runtime
from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
from channelestimationtransformer_torch.data.windows import WindowDataset, make_batch
from channelestimationtransformer_torch.models.encoder import ConvLayer
from channelestimationtransformer_torch.models.informer import build_informer
from channelestimationtransformer_torch.train.trainer import create_train_state, train_step

CFG = dict(seq_len=24, label_len=6, pred_len=5, d_model=16, n_heads=4, e_layers=(2, 1),
           d_layers=1, d_ff=16)
PHASES = ["cet.batch", "cet.model", "cet.backward", "cet.optimizer"]
BATCH = 8


def _setup(dropout=0.05, use_pallas=False):
    cfg = InformerConfig(dropout=dropout, use_pallas=use_pallas, **CFG)
    h = torch.randn(32, 40, cfg.enc_in, generator=torch.Generator().manual_seed(1))
    data = WindowDataset(h=h, seq_len=cfg.seq_len, pred_len=cfg.pred_len, snr_db=20.0,
                         device="cpu")
    model = build_informer(cfg, device="cpu", seed=0)
    state = create_train_state(model, TrainConfig(batch_size=BATCH, lr=1e-3, steps_per_epoch=4,
                                                  num_epochs=1))
    return cfg, data, state


def _step(cfg, data, state):
    return train_step(state, data, batch_size=BATCH, label_len=cfg.label_len,
                      generator=torch.Generator().manual_seed(7))


def _spans(prof) -> list:
    """The ``cet.`` host spans, ``(name, start_ns, end_ns)`` in start order."""
    rows = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events() if ev.name().startswith("cet.")]
    return sorted(rows, key=lambda r: r[1])


def _convs(model) -> int:
    """Circular convolutions a forward runs: both embeddings and each distil conv."""
    return 2 + sum(isinstance(m, ConvLayer) for m in model.modules())


def test_no_profiler_no_span():
    assert not torch.autograd._profiler_enabled()
    assert runtime.span("cet.step") is runtime.span("cet.conv")
    cfg, data, state = _setup()
    _step(cfg, data, state)  # runs through every span with none recorded
    taken = runtime.span("cet.model")  # taken with no profiler running
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with taken:
            torch.ones(3).sum()
    assert _spans(prof) == []


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_spans(use_pallas):
    cfg, data, state = _setup(use_pallas=use_pallas)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _step(cfg, data, state)
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "cet.step"]
    assert len(steps) == 1
    _, s0, s1 = steps[0]
    assert all(s0 <= s and e <= s1 for _, s, e in spans)
    phases = [s for s in spans if s[0] in PHASES]
    assert [name for name, _, _ in phases] == PHASES
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))  # one after another
    _, m0, m1 = phases[1]
    convs = [s for s in spans if s[0] == "cet.conv"]
    assert _convs(state.model) == 2 + 1  # e_layers (2, 1): one distil conv
    assert len(convs) == _convs(state.model)
    assert all(m0 <= s and e <= m1 for _, s, e in convs)
    assert len(spans) == 1 + len(PHASES) + len(convs)


def test_served_batch_spans():
    cfg, data, state = _setup()
    model = state.model.eval()
    g = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        x_enc, x_dec, _ = make_batch(data, BATCH, cfg.label_len, generator=g)
        model(x_enc, x_dec)
    names = [name for name, _, _ in _spans(prof)]
    assert names == ["cet.batch", "cet.model"] + ["cet.conv"] * _convs(model)


@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_a_profiled_step_takes_the_same_numbers(dropout):
    cfg, data, plain = _setup(dropout)
    _, _, traced = _setup(dropout)
    want = _step(cfg, data, plain)
    with profile(activities=[ProfilerActivity.CPU]):
        got = _step(cfg, data, traced)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["loss_split"], want["loss_split"])
    for (name, p), q in zip(traced.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p, q), name
    assert traced.step == plain.step == 1
