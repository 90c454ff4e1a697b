"""Device kernels a train step in the traced slice: every kernel the
profiler recorded over the steps it covered."""
UNIT = "launches/step"
SOURCE = "device_trace"


def read(ctx):
    if ctx.slice is None or not ctx.steps:
        return None
    return ctx.slice.launches() / ctx.steps
