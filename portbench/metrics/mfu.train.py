"""The training step's share of the card's peak: the model's FLOPs a
window (forward and backward, counted on the reference) times the windows a
second of an untraced slice, over the dtype's peak."""

from portbench import arith


def read(ctx):
    return 100.0 * ctx.flops_per_sample * ctx.rate_samples_per_s / arith.MODEL_PEAK_FLOPS[ctx.dtype]
