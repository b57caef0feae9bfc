"""Milliseconds a training step spends in the optimizer's update (span
``cet.optimizer``: the schedule and Adam): its device activities and the
idle gaps while the host is inside it."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx.trace, "cet.optimizer")
