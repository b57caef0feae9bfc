"""The yardstick's arithmetic: the attention bounds at the flagship and
``xl`` shapes, the window's statistics, the trace's reduction and the
per-layer readers."""

from __future__ import annotations

import statistics

import pytest
import torch

from portbench import arith, stats
from portbench.manifest import Manifest
from portbench.trace import Trace
from portbench.workload import Context

FLAGSHIP = dict(seq_len=90, label_len=10, pred_len=5, d_model=128, n_heads=8, e_layers=[4, 3],
                d_layers=3, distil=True)
XL = dict(FLAGSHIP, d_model=1024, seq_len=256)


def _us(calls, bound):
    return 1e6 * sum(bound(c) for c in calls)


def test_bd_bounds_of_a_flagship_step():
    calls = arith.bd_calls(FLAGSHIP)
    assert len(calls) == 13 and not arith.mha_calls(FLAGSHIP)
    fwd = _us(calls, lambda c: arith.fwd_bound_s(c[0], c[1], c[3], "float32", b=256, h=8,
                                                 e=c[2], with_lse=True))
    eval_fwd = _us(calls, lambda c: arith.fwd_bound_s(c[0], c[1], c[3], "float32", b=256, h=8,
                                                      e=c[2]))
    bwd = _us(calls, lambda c: arith.bwd_bound_s(c[0], c[1], c[3], "float32", b=256, h=8,
                                                 e=c[2]))
    assert round(fwd, 1) == 56.2 and round(eval_fwd, 1) == 55.3 and round(bwd, 1) == 111.5


def test_mha_bound_of_an_xl_batch():
    calls = arith.mha_calls(XL)
    assert len(calls) == 13 and not arith.bd_calls(XL)
    self_calls = [c for c in calls if c[0] == c[1]]  # the 10 [B, L, H, E] calls

    def bound(c):
        return arith.fwd_bound_s(c[0], c[1], c[3], "bfloat16", b=64, h=8, e=c[2])
    assert len(self_calls) == 10 and round(_us(self_calls, bound), 1) == 117.2
    assert _us(calls, bound) > _us(self_calls, bound)


def test_no_float32_kernel_can_pass_its_roofline():
    # the bound takes TF32's rate: a float32 product cannot run faster
    assert arith.ATTN_PEAK_FLOPS["float32"] == 495e12
    assert arith.MODEL_PEAK_FLOPS["float32"] == 67e12


def _median_of_chunks(latencies, size=10):
    return statistics.median(sum(latencies[i:i + size]) / size
                             for i in range(0, len(latencies), size))


def test_a_stall_moves_the_rate_and_the_tail():
    steady = [0.030] * 200
    stalled = list(steady)
    for i in range(100, 112):  # 12 requests held up by a stall
        stalled[i] += 0.100
    assert stats.rate(len(stalled) * 256, sum(stalled)) < stats.rate(len(steady) * 256,
                                                                     sum(steady))
    assert stats.percentile(stalled, 95) > stats.percentile(steady, 95)
    assert _median_of_chunks(stalled) == _median_of_chunks(steady)


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def synthetic_trace() -> Trace:
    kernels = [("void bd_attention_fwd_kernel<float>", 0.0, 1.0),
               ("gemm", 0.5, 2.0),
               ("void bd_attention_fwd_kernel<float>", 3.0, 4.0)]
    transfers = [("Memcpy HtoD", 6.0, 6.5)]
    host = [("train_chunk", 0.0, 4.5), ("aten::mm", 2.0, 2.9), ("cudaStreamSynchronize", 7.0,
                                                                 9.0)]
    return Trace(window_s=10.0, kernels=kernels, transfers=transfers, host=host)


def test_trace_union_and_gaps():
    tr = synthetic_trace()
    assert tr.busy_intervals() == [[0.0, 2.0], [3.0, 4.0], [6.0, 6.5]]
    assert tr.busy_s == pytest.approx(3.5)
    assert tr.kernel_time(("bd_attention_fwd_kernel",)) == (2, 2.0)
    gaps = dict(tr.idle_gaps())
    assert gaps == {"aten::mm": pytest.approx(1.0), "host idle": pytest.approx(2.0),
                    "cudaStreamSynchronize": pytest.approx(3.5)}
    assert tr.device_ops()[0] == ["bd_attention_fwd_kernel<float>", 2.0]


def context(tr: Trace, units=1, kind="train", model=None, dtype="float32") -> Context:
    return Context(cell="x", kind=kind, dtype=dtype, model=model or FLAGSHIP, batch=256,
                   units=units, trace=tr, rate_samples_per_s=1000.0, flops_per_sample=67e6)


def test_readers_on_a_synthetic_trace():
    manifest = Manifest()
    tr = synthetic_trace()
    ctx = context(tr, units=2)
    assert manifest.reader("launches_per_step.train")(ctx) == 1.5
    assert manifest.reader("device_idle.train")(ctx) == pytest.approx(65.0)
    assert manifest.reader("mfu.train")(ctx) == pytest.approx(0.1)
    # two bd rows where a flagship step has 13 calls: the shapes are unknown
    assert manifest.reader("bd_fwd_roofline.train")(ctx) is None
    assert manifest.reader("bd_fwd_roofline.serve")(context(tr, kind="serve")) is None


def test_roofline_reads_its_calls_bound_over_their_time():
    calls = arith.bd_calls(FLAGSHIP)
    rows = [("bd_attention_fwd_kernel", 1e-4 * i, 1e-4 * i + 1e-4) for i in range(26)]
    ctx = context(Trace(window_s=1.0, kernels=rows, transfers=[], host=[]), units=2)
    share = Manifest().reader("bd_fwd_roofline.train")(ctx)
    least = sum(arith.fwd_bound_s(c[0], c[1], c[3], "float32", b=256, h=8, e=c[2],
                                  with_lse=True) for c in calls)
    assert share == pytest.approx(100.0 * least / 13e-4)


@pytest.mark.cuda
def test_trace_of_the_card_has_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench import trace as tracing
    from portbench.workload import _profiled

    x = torch.randn(2048, 2048, device="cuda")
    tr = _profiled(torch.device("cuda"), lambda: [x @ x for _ in range(10)])
    assert len(tr.kernels) >= 10 and 0 < tr.busy_s <= tr.window_s
    assert tracing.WINDOW
