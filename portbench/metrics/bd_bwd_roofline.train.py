"""The bd attention backward kernel's share of its roofline."""

from portbench import arith

PATTERNS = ("bd_attention_bwd_kernel", "bd_attention_bwd_f16_kernel")


def read(ctx):
    h = ctx.model["n_heads"]
    return arith.roofline_share(
        ctx, PATTERNS, arith.bd_calls(ctx.model),
        lambda c: arith.bwd_bound_s(c[0], c[1], c[3], ctx.dtype, b=ctx.batch, h=h, e=c[2]))
