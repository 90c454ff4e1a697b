"""The device's idle share of the traced slice of whole train steps: its
wall time less the union of kernel and copy intervals, over its wall time
(torch.profiler)."""
UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    s = ctx.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
