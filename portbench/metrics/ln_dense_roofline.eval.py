"""Kernel 1's share of its roofline in the eval passes: the least time for
the fused LayerNorm -> Dense of the hoisted video projection over each
batch's unique videos' valid clips (counts/kernels.ln_dense), over the
traced time of its two kernels, the statistics pass and the product."""
import numpy as np

from portbench.counts import kernels

UNIT = "%"
SOURCE = "device_trace"
KERNELS = ("ln_stats_kernel", "ln_dense_wgmma_kernel")
COUNTER = "mesm_tpu_torch.ops.ln_dense:launches"


def read(ctx):
    n, t = ctx.checked_kernel_time(KERNELS, COUNTER, per_launch=len(KERNELS))
    if n == 0 or t <= 0:
        return None
    c = ctx.model_cfg()
    ops = nbytes = 0.0
    for b in ctx.batches:
        rm = np.asarray(b["row_mask"], bool)
        slots = np.unique(np.asarray(b["video_slot"])[rm])
        clips = int(np.asarray(b["video_mask_g"], bool).sum(1)[slots].sum())
        o, m = kernels.ln_dense(clips, c["v_feat_dim"], c["hidden_dim"])
        ops, nbytes = ops + o, nbytes + m
    least = kernels.roofline_seconds(ops, nbytes, ctx.peak_ops(), ctx.peak_bytes())
    return 100.0 * least / t
