"""Milliseconds a training step spends in the data layer (``make_batch``,
span ``cet.batch``): its device activities and the idle gaps while the host
is inside it."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx.trace, "cet.batch")
