"""Busy milliseconds a training step spends in the convolutions (span
``cet.conv``: both embeddings and every distil conv), forward and backward,
whatever kernels implement them."""

from portbench import spans


def read(ctx):
    return spans.conv_ms(ctx.trace)
