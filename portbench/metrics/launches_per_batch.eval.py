"""Device kernels a batch in the traced slice of whole eval passes: every
kernel the profiler recorded (CUDA graph replays included) over the
batches the passes returned."""
UNIT = "launches/batch"
SOURCE = "device_trace"


def read(ctx):
    if ctx.slice is None or not ctx.batches:
        return None
    return ctx.slice.launches() / len(ctx.batches)
