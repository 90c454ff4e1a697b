"""Kernel 6's share of its roofline in the eval passes: the least time for
the DETR encoder's self-attention of each batch's real rows, clips and the
global token as queries and keys (counts/kernels.attention_forward), over
the traced time of the fp32 batched attention kernel."""
from portbench.counts import kernels

UNIT = "%"
SOURCE = "device_trace"
KERNELS = ("attention_batched_3xtf32_kernel",)
COUNTER = "mesm_tpu_torch.ops.attention_batched:launches"


def read(ctx):
    n, t = ctx.checked_kernel_time(KERNELS, COUNTER)
    if n == 0 or t <= 0:
        return None
    c = ctx.model_cfg()
    ops = nbytes = 0.0
    for b in ctx.batches:
        lq, lk = kernels.encoder_rows(b)
        o, m = kernels.attention_forward(lq, lk, c["hidden_dim"])
        ops, nbytes = ops + c["enc_layers"] * o, nbytes + c["enc_layers"] * m
    least = kernels.roofline_seconds(ops, nbytes, ctx.peak_ops(), ctx.peak_bytes())
    return 100.0 * least / t
