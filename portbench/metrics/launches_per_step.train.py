"""Device kernels a training step launches, counted in the trace."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.units if ctx.trace.kernels else None
