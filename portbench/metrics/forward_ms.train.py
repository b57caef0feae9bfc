"""Milliseconds a training step spends in the model's forward (span
``cet.model``): its device activities and the idle gaps while the host is
inside it."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx.trace, "cet.model")
