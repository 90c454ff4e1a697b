"""The eval step's share of the card's peak: the model's operations for
the rows the traced slice's passes returned, each row at its own lengths
(counts/model.eval_batch), over the slice's wall time and the peak of the
configuration's compute dtype (counts/peaks.json)."""
from portbench.counts import model

UNIT = "%"
SOURCE = "device_trace"


def read(ctx):
    if ctx.slice is None or not ctx.batches:
        return None
    c = ctx.model_cfg()
    ops = sum(model.eval_batch(c, b) for b in ctx.batches)
    return 100.0 * ops / (ctx.slice.window_s * ctx.peak_ops())
