"""Percent of the traced slice in which the device runs nothing: one minus
the union of its kernel and copy intervals over the slice."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
