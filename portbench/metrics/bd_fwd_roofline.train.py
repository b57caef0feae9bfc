"""The bd attention forward kernel's share of its roofline in training (it
writes the row log-sum-exp for the backward)."""

from portbench import arith

PATTERNS = ("bd_attention_fwd_kernel",)


def read(ctx):
    h = ctx.model["n_heads"]
    return arith.roofline_share(
        ctx, PATTERNS, arith.bd_calls(ctx.model),
        lambda c: arith.fwd_bound_s(c[0], c[1], c[3], ctx.dtype, b=ctx.batch, h=h, e=c[2],
                                    with_lse=True))
