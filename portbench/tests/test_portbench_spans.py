"""The program's spans in the traced slice (``spans.py``): a synthetic
slice of two steps, with kernels launched from the step's thread and from
autograd's inside the backward, convolution kernels in the forward and in
their backward nodes, and idle gaps; the readers that were there before
read the same whether the program's spans are in the slice or not; and a
CPU profile of a training step keeps the program's host spans."""

from __future__ import annotations

import pytest
import torch

from portbench import spans
from portbench.manifest import Manifest
from portbench.tests.test_portbench_arithmetic import context
from portbench.trace import Trace

NEW = ["batch_ms.train", "forward_ms.train", "backward_ms.train", "optimizer_ms.train",
       "conv_ms.train"]
EARLIER = ["launches_per_step.train", "mfu.train", "bd_fwd_roofline.train",
           "bd_bwd_roofline.train", "device_idle.train"]
LAUNCH = 0.01  # seconds a launch call takes on the host


def _step(o: float):
    """One step at ``o`` s: host rows, and device rows each with the host
    time of its launch call."""
    host = [
        ("cet.step", o, o + 9),
        ("cet.batch", o, o + 1),
        ("cet.model", o + 1, o + 4),
        ("cet.conv", o + 1.5, o + 2),
        ("aten::convolution", o + 1.6, o + 1.9),
        ("aten::mm", o + 2.5, o + 2.8),
        ("cet.backward", o + 4.5, o + 7),
        # autograd's thread, while the step's thread waits in cet.backward
        ("autograd::engine::evaluate_function: ConvolutionBackward0", o + 5, o + 5.5),
        ("ConvolutionBackward0", o + 5.01, o + 5.49),
        ("autograd::engine::evaluate_function: MmBackward0", o + 5.6, o + 6),
        ("autograd::engine::evaluate_function: AddBackward0", o + 6.1, o + 6.4),
        ("cet.optimizer", o + 7, o + 8.5),
    ]
    kernels = [
        ("fill", o + 0.3, o + 0.8, o + 0.2),
        ("fft", o + 1.8, o + 2.6, o + 1.7),  # conv, forward
        ("gemm", o + 2.7, o + 3.5, o + 2.6),
        ("reduce", o + 4.3, o + 4.6, o + 4.2),  # the loss: the step's remainder
        ("fft_bwd", o + 5.3, o + 6.0, o + 5.2),  # conv, backward
        ("gemm_bwd", o + 6.0, o + 6.5, o + 5.8),
        ("add", o + 6.6, o + 6.9, o + 6.2),
        ("adam", o + 7.6, o + 8.4, o + 7.5),
        ("sum", o + 9.7, o + 9.8, o + 9.6),  # after the step: outside steps
    ]
    transfers = [("Memcpy HtoD", o + 0.05, o + 0.25, o + 0.02)]
    return host, kernels, transfers


def synthetic(with_spans=True) -> Trace:
    host, kernels, transfers = [], [], []
    for o in (0.0, 10.0):
        h, k, t = _step(o)
        host += h
        kernels += k
        transfers += t
    kernels.append(("tail", 19.9, 19.95, 19.85))
    host += [("cudaLaunchKernel", t, t + LAUNCH) for *_, t in kernels]
    host += [("cudaMemcpyAsync", t, t + LAUNCH) for *_, t in transfers]
    if not with_spans:
        host = [r for r in host if not r[0].startswith("cet.")]
    return Trace(window_s=20.0, kernels=[r[:3] for r in kernels],
                 transfers=[r[:3] for r in transfers], host=sorted(host, key=lambda r: r[1]))


def test_phases_partition_the_slice():
    tr = synthetic()
    assert spans.steps(tr) == 2
    parts = spans.partition(tr)
    assert sum(b + i for b, i in parts.values()) == pytest.approx(tr.window_s)
    assert sum(b for b, _ in parts.values()) == pytest.approx(tr.busy_s)
    # each phase's busy and idle seconds over the two steps
    want = {"cet.batch": (1.4, 0.15), "cet.model": (3.2, 3.8), spans.REMAINDER: (0.6, 0.0),
            "cet.backward": (3.0, 1.6), "cet.optimizer": (1.6, 1.4),
            spans.OUTSIDE: (0.25, 3.0)}
    assert parts.keys() == want.keys()
    for phase, (busy, idle) in want.items():
        assert parts[phase] == pytest.approx((busy, idle)), phase


def test_readers_of_the_phases_and_the_convs():
    manifest = Manifest()
    ctx = context(synthetic(), units=2)
    got = {name: manifest.reader(name)(ctx) for name in NEW}
    assert got == pytest.approx({"batch_ms.train": 775.0, "forward_ms.train": 3500.0,
                                 "backward_ms.train": 2300.0, "optimizer_ms.train": 1500.0,
                                 "conv_ms.train": 1500.0})


def test_conv_kernels_cross_into_the_backward():
    tr = synthetic()
    names = {(s, e): name for name, s, e in tr.kernels}
    assert [names[a] for a in spans.conv_activities(tr)] == ["fft", "fft_bwd"] * 2


def test_a_launch_left_out_ties_nothing():
    tr = synthetic()
    first = next(i for i, r in enumerate(tr.host) if r[0] == "cudaLaunchKernel")
    del tr.host[first]
    assert spans.launched(tr) is None
    ctx = context(tr, units=2)
    assert all(Manifest().reader(name)(ctx) is None for name in NEW)


def test_a_program_without_spans_reads_nothing():
    manifest = Manifest()
    ctx = context(synthetic(with_spans=False), units=2)
    assert all(manifest.reader(name)(ctx) is None for name in NEW)
    convless = synthetic()
    convless.host = [r for r in convless.host if r[0] != "cet.conv"]
    ctx = context(convless, units=2)
    assert manifest.reader("conv_ms.train")(ctx) is None
    assert manifest.reader("forward_ms.train")(ctx) == pytest.approx(3500.0)


@pytest.mark.parametrize("name", EARLIER)
def test_earlier_readers_read_the_same_with_the_spans(name):
    read = Manifest().reader(name)
    assert read(context(synthetic(), units=2)) == read(context(synthetic(False), units=2))


def test_a_cpu_profile_keeps_the_programs_spans():
    from channelestimationtransformer_torch.core.config import InformerConfig, TrainConfig
    from channelestimationtransformer_torch.data.windows import WindowDataset
    from channelestimationtransformer_torch.models.informer import build_informer
    from channelestimationtransformer_torch.train.trainer import create_train_state, train_step

    from portbench.workload import profiled

    cfg = InformerConfig(seq_len=24, label_len=6, pred_len=5, d_model=16, n_heads=4,
                         e_layers=(2, 1), d_layers=1, d_ff=16)
    data = WindowDataset(h=torch.randn(32, 40, 16, generator=torch.Generator().manual_seed(1)),
                         seq_len=24, pred_len=5, snr_db=20.0, device="cpu")
    state = create_train_state(build_informer(cfg, device="cpu", seed=0),
                               TrainConfig(batch_size=8, steps_per_epoch=4, num_epochs=1))
    tr = profiled(torch.device("cpu"), lambda: train_step(
        state, data, batch_size=8, label_len=6, generator=torch.Generator().manual_seed(7)))
    named = {}
    for name, s, e in tr.host:
        named.setdefault(name, []).append((s, e))
    assert spans.steps(tr) == 1 and len(named["cet.conv"]) == 3
    (s0, s1), = named["cet.step"]
    phases = [named[p][0] for p in spans.PHASES]
    assert all(len(named[p]) == 1 for p in spans.PHASES)
    assert s0 <= phases[0][0] and phases[-1][1] <= s1
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))  # one after another
    (m0, m1), (b0, b1) = named["cet.model"][0], named["cet.backward"][0]
    assert all(m0 <= s and e <= m1 for s, e in named["cet.conv"])
    nodes = [(s, e) for name, s, e in tr.host if spans.CONV_BACKWARD in name]
    assert nodes and all(b0 <= s and e <= b1 for s, e in nodes)
    parts = spans.partition(tr)  # no device activity on the CPU: the slice is idle
    assert sum(b for b, _ in parts.values()) == 0.0
    assert sum(i for _, i in parts.values()) == pytest.approx(tr.window_s)
