"""Milliseconds a training step spends in autograd's backward (span
``cet.backward``): the device activities launched while it is open, from
any thread, and the idle gaps while the host is inside it."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx.trace, "cet.backward")
