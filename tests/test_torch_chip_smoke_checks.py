"""Checks of ``chip_smoke.py`` that read text, run here on recorded text:

- the build report, on ptxas and SASS text: each kernel instance's label,
  dtype, registers and spills, its tensor-core MMAs (HMMA and Hopper's
  HGMMA) by operand type, and the check that a bf16 instance issues bf16
  MMAs only, an f32 instance TF32 only, an f16 instance f16 only and a
  wgmma instance HGMMA (the report runs only beside nvcc on the card);
- the gloo probe's verdict on its two ranks' output, in the ways a card has
  ended the probe.
"""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

# Two anonymous-namespace kernels as nvcc mangles them; the second
# namespace's hash ends in digits, right before the kernel name's length.
BF16_FWD = ("_ZN52_GLOBAL__N__1b8f3b67_19_bd_attention_fwd_cu_ee3bb19023bd_attention_fwd_"
            "kernelI13__nv_bfloat16Li16ELi96EEEvPKT_S4_S4_PS2_PfPKxiiiiiifijfi")
F32_BWD = ("_ZN52_GLOBAL__N__801e7971_19_bd_attention_bwd_cu_e932194c23bd_attention_bwd_"
           "kernelIfLi32ELb1ELb0EEEvPKT_S3_S3_S3_S3_PKfPKxPS1_S8_S8_iiiiifijf")
LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{BF16_FWD}' for 'sm_90a'
ptxas info    : Function properties for {BF16_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 452 bytes cmem[0]
ptxas info    : Compiling entry function '{F32_BWD}' for 'sm_90a'
ptxas info    : Function properties for {F32_BWD}
    24 bytes stack frame, 20 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""
SASS = f"""
	code for sm_90a
		Function : {BF16_FWD}
        /*0400*/                   HMMA.16816.F32.BF16 R24, R4, R16, R24 ;
        /*0410*/                   HMMA.16816.F32.BF16 R28, R4, R18, R28 ;
		Function : {F32_BWD}
        /*0500*/                   HMMA.1688.F32.TF32 R8, R12, R2, R8 ;
        /*0510*/                   IMAD.MOV.U32 R1, RZ, RZ, c[0x0][0x28] ;
"""


# The mha library's wgmma instance as nvcc mangles it (E 128, D 128, two
# consumer warpgroups; four tensor maps by value), and lines of its SASS as
# cuobjdump printed them on the card: S = Q K^T from shared memory, then
# P V with P from registers and V's transpose bit.
WGMMA = ("_ZN53_GLOBAL__N__bdef217f_20_mha_attention_fwd_cu_6d00fbc326mha_attention_wgmma_"
         "kernelI13__nv_bfloat16Li128ELi128ELi2EEEv14CUtensorMap_stS2_S2_S2_iiiifi")
WGMMA_LOG = f"""ptxas info    : Compiling entry function '{WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {WGMMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""
WGMMA_SASS = f"""
		Function : {WGMMA}
        /*13e0*/                   WARPGROUP.ARRIVE ;
        /*1440*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*1c70*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*1d30*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*4230*/                   WARPGROUP.ARRIVE ;
        /*42f0*/                   HGMMA.64x128x16.F32.BF16 R88, R24, gdesc[UR4].tnspB, R88 ;
"""


@pytest.mark.parametrize("name,label,dtype", [
    (BF16_FWD, "bd_attention_fwd_kernel<bfloat16, 16, 96>", "bfloat16"),
    (F32_BWD, "bd_attention_bwd_kernel<float32, 32, 1, 0>", "float32"),
    (WGMMA, "mha_attention_wgmma_kernel<bfloat16, 128, 128, 2>", "bfloat16"),
    ("_Z14fixed_pt_kernelPfi", "_Z14fixed_pt_kernelPfi", None),
])
def test_instance_label_reads_the_mangled_template_arguments(name, label, dtype):
    assert chip_smoke._instance_label(name) == (label, dtype)


def test_build_instances_from_ptxas_and_sass():
    rows = chip_smoke._build_instances(LOG, chip_smoke._hmma_by_function(SASS))
    assert [(r["label"], r["registers"], r["spill_bytes"], r["hmma_bf16"], r["hmma_tf32"])
            for r in rows] == [
        ("bd_attention_fwd_kernel<bfloat16, 16, 96>", 94, 0, 2, 0),
        ("bd_attention_bwd_kernel<float32, 32, 1, 0>", 128, 52, 0, 1)]
    assert chip_smoke._mma_faults(rows) == []
    # Without cuobjdump the HMMA counts are unknown and only the dtype is checked.
    assert chip_smoke._mma_faults(chip_smoke._build_instances(LOG, None)) == []


def test_hgmma_counts_as_bf16_tensor_core_work():
    counts = chip_smoke._hmma_by_function(WGMMA_SASS + SASS)
    assert counts[WGMMA] == dict(bf16=3, tf32=0, f16=0, other=0, hgmma=3)
    assert counts[BF16_FWD] == dict(bf16=2, tf32=0, f16=0, other=0, hgmma=0)
    rows = chip_smoke._build_instances(WGMMA_LOG + LOG, counts)
    assert [(r["label"], r["registers"], r["spill_bytes"], r["hmma_bf16"], r["hgmma"])
            for r in rows] == [
        ("mha_attention_wgmma_kernel<bfloat16, 128, 128, 2>", 168, 0, 3, 3),
        ("bd_attention_fwd_kernel<bfloat16, 16, 96>", 94, 0, 2, 0),
        ("bd_attention_bwd_kernel<float32, 32, 1, 0>", 128, 52, 0, 0)]
    assert chip_smoke._mma_faults(rows) == []


def test_mma_faults_flag_a_wgmma_instance_without_hgmma_or_with_tf32():
    def row(label, bf16, tf32, hgmma):
        return dict(label=label, dtype="bfloat16", hmma_bf16=bf16, hmma_tf32=tf32, hmma_f16=0,
                    hmma_other=0, hgmma=hgmma)
    rows = [row("mha_attention_wgmma_kernel<bfloat16, 64, 64, 1>", 8, 0, 8),
            row("mha_attention_wgmma_kernel<bfloat16, 64, 64, 2>", 8, 0, 0),
            row("mha_attention_wgmma_kernel<bfloat16, 128, 64, 1>", 0, 0, 0),
            row("mha_attention_wgmma_kernel<bfloat16, 128, 64, 2>", 8, 4, 8)]
    assert chip_smoke._mma_faults(rows) == [r["label"] for r in rows[1:]]


def test_mma_faults_name_instances_issuing_the_other_dtype():
    def row(label, dtype, bf16, tf32, other=0):
        return dict(label=label, dtype=dtype, hmma_bf16=bf16, hmma_tf32=tf32, hmma_f16=0,
                    hmma_other=other)
    rows = [row("ok bf16", "bfloat16", 4, 0), row("ok f32", "float32", 0, 12),
            row("bf16 with tf32", "bfloat16", 4, 3), row("bf16 with none", "bfloat16", 0, 0),
            row("f32 with bf16", "float32", 2, 12), row("other hmma", "float32", 0, 12, 1),
            row("no dtype", None, 4, 0)]
    assert chip_smoke._mma_faults(rows) == ["bf16 with tf32", "bf16 with none", "f32 with bf16",
                                            "other hmma", "no dtype"]


# The float16 instances as nvcc mangles them (the anonymous namespaces as
# above), and SASS lines of f16 MMAs with f32 accumulators: their names carry
# no operand type.
F16_FWD = ("_ZN52_GLOBAL__N__1b8f3b67_19_bd_attention_fwd_cu_ee3bb19023bd_attention_fwd_"
           "kernelI6__halfLi16ELi96EEEvPKT_S4_S4_PS2_PfPKxiiiiiifijfi")
F16_WGMMA = ("_ZN53_GLOBAL__N__bdef217f_20_mha_attention_fwd_cu_6d00fbc326mha_attention_wgmma_"
             "kernelI6__halfLi128ELi128ELi2EEEv14CUtensorMap_stS2_S2_S2_iiiifi")
F16_LOG = f"""ptxas info    : Compiling entry function '{F16_FWD}' for 'sm_90a'
ptxas info    : Function properties for {F16_FWD}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 452 bytes cmem[0]
ptxas info    : Compiling entry function '{F16_WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {F16_WGMMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
"""


def _f16_sass(fwd_ops, wgmma_ops):
    """SASS of the two f16 instances issuing the given MMA lines."""
    lines = [f"\t\tFunction : {F16_FWD}"] + [f"        /*04{i}0*/  {op} R24, R4, R16, R24 ;"
                                             for i, op in enumerate(fwd_ops)]
    lines += [f"\t\tFunction : {F16_WGMMA}"] + [
        f"        /*14{i}0*/  {op} R24, gdesc[UR4], R24, gsb0 ;" for i, op in enumerate(wgmma_ops)]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("name,label", [
    (F16_FWD, "bd_attention_fwd_kernel<float16, 16, 96>"),
    (F16_WGMMA, "mha_attention_wgmma_kernel<float16, 128, 128, 2>"),
])
def test_instance_label_reads_half(name, label):
    assert chip_smoke._instance_label(name) == (label, "float16")


def test_f16_instances_issuing_f16_mmas_pass():
    """``HMMA.16816.F32`` and ``HGMMA.64x128x16.F32`` count as f16."""
    counts = chip_smoke._hmma_by_function(_f16_sass(
        ["HMMA.16816.F32"] * 3, ["HGMMA.64x128x16.F32"] * 2 + ["HMMA.16816.F32"]))
    assert counts[F16_FWD] == dict(bf16=0, tf32=0, f16=3, other=0, hgmma=0)
    assert counts[F16_WGMMA] == dict(bf16=0, tf32=0, f16=3, other=0, hgmma=2)
    rows = chip_smoke._build_instances(F16_LOG, counts)
    assert [(r["label"], r["dtype"], r["registers"], r["hmma_f16"], r["hgmma"]) for r in rows] == [
        ("bd_attention_fwd_kernel<float16, 16, 96>", "float16", 90, 3, 0),
        ("mha_attention_wgmma_kernel<float16, 128, 128, 2>", "float16", 168, 3, 2)]
    assert chip_smoke._mma_faults(rows) == []


@pytest.mark.parametrize("fwd_ops,wgmma_ops,faults", [
    (["HMMA.16816.F32.BF16"], ["HGMMA.64x128x16.F32"], ["fwd"]),
    (["HMMA.16816.F32", "HMMA.1688.F32.TF32"], ["HGMMA.64x128x16.F32"], ["fwd"]),
    (["HMMA.16816.F32"], ["HGMMA.64x128x16.F32.BF16"], ["wgmma"]),
    (["HMMA.16816.F32"], ["HMMA.16816.F32"], ["wgmma"]),  # no HGMMA
    (["HMMA.16816.F16"], ["HGMMA.64x128x16.F32"], ["fwd"]),  # f16 accumulators: "other"
    ([], ["HGMMA.64x128x16.F32"], ["fwd"]),  # no MMA at all
])
def test_f16_instances_issuing_other_mmas_fail(fwd_ops, wgmma_ops, faults):
    rows = chip_smoke._build_instances(F16_LOG, chip_smoke._hmma_by_function(
        _f16_sass(fwd_ops, wgmma_ops)))
    labels = {"fwd": rows[0]["label"], "wgmma": rows[1]["label"]}
    assert chip_smoke._mma_faults(rows) == [labels[f] for f in faults]


def test_bf16_and_f32_instances_issuing_f16_mmas_fail():
    def row(label, dtype, **kinds):
        return dict(label=label, dtype=dtype, hgmma=0,
                    **{f"hmma_{k}": kinds.get(k, 0) for k in chip_smoke.MMA_KINDS})
    rows = [row("bf16 ok", "bfloat16", bf16=4), row("bf16 with f16", "bfloat16", bf16=4, f16=1),
            row("f32 with f16", "float32", tf32=12, f16=2), row("f16 ok", "float16", f16=4),
            row("f16 with tf32", "float16", f16=4, tf32=1)]
    assert chip_smoke._mma_faults(rows) == ["bf16 with f16", "f32 with f16", "f16 with tf32"]


@pytest.mark.parametrize("l_q,e,d,aligned", [
    (256, 128, 128, True), (128, 128, 128, True), (64, 128, 128, True), (33, 64, 64, True),
    (32, 128, 128, True), (15, 128, 128, True), (256, 128, 64, True), (256, 96, 128, True),
    (256, 128, 128, False), (100, 64, 32, True)])
def test_mha_route_of_float16_is_bfloat16s(l_q, e, d, aligned):
    """``mha_route`` sends a float16 call where it sends the same bf16 call:
    "wgmma" at Lq > 32 with E and D 64 or 128 on 16-byte aligned tensors,
    "mma" otherwise; float32 always "mma"."""
    from channelestimationtransformer_torch.ops.cuda import mha_attention as mha

    torch = pytest.importorskip("torch")
    want = mha.mha_route(torch.bfloat16, l_q, l_q, e, d, aligned)
    assert mha.mha_route(torch.float16, l_q, l_q, e, d, aligned) == want
    assert want == ("wgmma" if l_q > 32 and e in (64, 128) and d in (64, 128) and aligned
                    else "mma")
    assert mha.mha_route(torch.float32, l_q, l_q, e, d, aligned) == "mma"


PROBE_OK = "".join(f"probe {op} start\nprobe {op} True\n"
                   for op in ("all_gather", "all_reduce", "broadcast"))


def _probe(outcome):
    """chip_smoke.gloo_probe on recorded rank output: ``outcome`` is the
    ranks' text (they exited 0) or (first line, text) of run_local's error."""
    def run_local(argv, n, timeout):
        if isinstance(outcome, str):
            return [outcome]
        raise RuntimeError(outcome[0] + "\n" + outcome[1])
    return chip_smoke.gloo_probe(run_local, 0.0)


def test_gloo_probe_reads_a_refused_p2p_that_aborts_the_rank():
    """P2P ends rank 0 inside the op with gloo's uncaught C++ exception."""
    text = (PROBE_OK + "probe p2p start\nterminate called after throwing an instance of "
            "'gloo::IoException'\n  what():  [/pytorch/third_party/gloo/gloo/transport/tcp/"
            "pair.cc:339] writev [127.0.0.1]:28363: Bad address\n")
    got = _probe(("2 local ranks: rank 0 exited with -6", text))
    assert {op: got[op] for op in chip_smoke.GLOO_OPS} == dict(
        all_gather="ok", all_reduce="ok", broadcast="ok", p2p="refused")
    assert "Bad address" in got["died"]


def test_gloo_probe_reads_a_refused_p2p_whose_pair_breaks_the_closing_barrier():
    """P2P raises gloo's error in rank 0 (refused), and the closing barrier on
    the pair it broke then ends both ranks."""
    text = (PROBE_OK + "probe p2p start\nprobe p2p refused: [/pytorch/third_party/gloo/gloo/"
            "transport/tcp/pair.cc:339] writev [127.0.0.1]:28363: Bad address\n"
            "[rank0]: RuntimeError: [/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:339] "
            "writev [127.0.0.1]:28363: Bad address\n")
    got = _probe(("2 local ranks: rank 0 exited with 1", text))
    assert got["p2p"] == "refused" and got["broadcast"] == "ok"
    assert "closing barrier" in got["died"]


@pytest.mark.parametrize("text", [
    "",  # no op started
    PROBE_OK,  # the last op started answered ok, then a rank died
    PROBE_OK + "probe p2p start\n[rank0]: RuntimeError: some other error\n",  # no gloo abort
])
def test_gloo_probe_fails_a_death_that_is_no_refusal(text):
    with pytest.raises(SystemExit):
        _probe(("2 local ranks: rank 0 exited with 1", text))


def test_gloo_probe_takes_every_op():
    got = _probe(PROBE_OK + "probe p2p start\nprobe p2p True\n")
    assert all(got[op] == "ok" for op in chip_smoke.GLOO_OPS) and got["died"] is None
