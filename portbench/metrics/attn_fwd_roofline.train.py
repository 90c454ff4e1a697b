"""Kernel 6's share of its roofline in the train steps: the least time for
the DETR encoder's self-attention forward of each step's real rows, each
twice (the positive and the negative pass stacked), clips and the global
token as queries and keys (counts/kernels.attention_forward), over the
traced time of the fp32 batched attention kernel (the trainable
forward's)."""
import numpy as np

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
        lq, lk = (np.concatenate([x, x]) for x in kernels.encoder_rows(b))
        o, m = kernels.attention_forward(lq, lk, c["hidden_dim"])
        ops, nbytes = ops + c["enc_layers"] * o, nbytes + c["enc_layers"] * m
    least = kernels.roofline_seconds(ops, nbytes, ctx.peak_ops(), ctx.peak_bytes())
    return 100.0 * least / t
