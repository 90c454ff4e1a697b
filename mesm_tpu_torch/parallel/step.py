"""The train step (forward, matcher, losses, backward, global-norm clip,
AdamW) and the eval step (text encode -> MESM forward -> the predictions the
host decodes).

Parity target: mesm_tpu/parallel/step.py: the train step of :33-230 (also
with grad_accum k > 1: k microbatches, one update), and make_eval_step
(:233-488), with_loss False (inference: no negative pass) or True (the
trainer's eval: the negative pass and the loss terms), at coalesce=1 a plain
function over one staged batch, at coalesce=K > 1 the dispatch-coalesced
step over K batches (CoalescedEvalStep), which runs on the card as one CUDA
graph replay. The JAX step's `params_unravel` (one flat parameter buffer
instead of ~190 argument handles a dispatch) and EVAL_SCAN_UNROLL (the
scan's unroll factor) have no counterpart: a graph replay passes no
arguments, and it records all K bodies. Its tuple form and its flat hoist
(FLAT_HOIST, a TPU layout choice) have none either: the coalesced step takes
the superbatch form alone. Multi-clip
(QVHighlights) batches pass their rows' SS video (`ss_video_feat`,
`ss_video_mask`, expanded by data/pipeline.stage_batch) to the model, as
_model_kwargs does (:81-104).

Optimizer parity: optax.chain(clip_by_global_norm(grad_clip), adamw(lr,
b1=0.9, b2=0.999, eps=1e-8, weight_decay)) (reference runner.py:348-352,
train.py:70-72). The clip is optax's: gradients scale by
max_norm / max(norm, max_norm), not by torch's max_norm / (norm + 1e-6);
optax decays every parameter, so a parameter without a gradient gets a zero
one and is decayed too. The StepLR schedule is set per epoch by the
training loop (set_learning_rate).

Random draws: the JAX step folds the step count into its key; here each
step seeds its own draws from (seed, step) (`step_draws`): the negatives and
the MLM masks from explicit torch.Generators on the batch's device, and the
dropout masks from the default generators (torch.manual_seed), since
F.dropout takes no generator. A resumed run therefore repeats the draws of
the steps it repeats. The draws are not JAX's: the parity tests inject the
negatives and masks into both.

Data parallel (`make_train_step(..., data_parallel=True)`, the train entry
point under torchrun): each rank takes its rows of every batch
(multihost.local_view) and runs the step inside parallel/rows.row_shard, so
the negatives and MLM masks are drawn for the whole batch from the same
seeded generators and each rank keeps its rows of them, the losses'
normalisers are the whole batch's, and the ranks' gradients are summed
before the clip: the update is the single-process update on the whole batch
(up to the order of the sums). Each rank's dropout masks come from the
step's seed with its rank folded in. Parameters sharded over the model axis
(parallel/tp.py) count once in the clip's global norm.

Sequence parallel (`make_train_step(..., seq_parallel=True, seq_group=...)`,
the counterpart of the JAX package's shard_batch_seq step): the batch is
this rank's block of mesh.shard_batch_seq (its rows, and of the
video-length keys its slice of the video axis over the model ranks), and
the step runs inside parallel/seq.seq_shard as well. Every loss term is
then the whole sequence's on every model rank, so each rank backpropagates
its loss weighted by 1 / k and the gradients are summed over the model
ranks as well as the data ranks: the terms computed alike on every model
rank (the decoder and its losses, the matcher, SS-MESM, the MLM, the text
side) count once, and each collective's backward brings every rank's part
of the rest to the clips' owner. The draws follow the data rank alone, so
every model rank of one data rank draws the same negatives, MLM masks and
dropout seeds (the sharded per-clip dropout masks are not the single
process's: parity holds at dropout 0). The model dim carries the sequence
or parallel/tp.py's FFN split, never both: a model with TP-sharded
parameters is refused.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import kernels
from ..data.pipeline import staged_signature
from ..losses import CriterionConfig, compute_losses
from ..losses.criterion import RATIO_TERMS
from ..utils.profiling import span
from . import rows, seq


def build_optimizer(model: torch.nn.Module, lr: float, weight_decay: float = 1e-4):
    """AdamW with optax.adamw's constants over every parameter. torch's
    decoupled decay p *= 1 - lr * wd before the Adam step is optax's
    p -= lr * (adam + wd * p)."""
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
    )


def current_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of squares over every tensor."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def _tp_global_norm(params) -> torch.Tensor:
    """The global norm when some parameters are shards over the model axis
    (parallel/tp.py marks them with `tp_group`): their squares are summed
    over the model ranks, the replicated ones counted once."""
    rep_sq = sum((p.grad.float() ** 2).sum() for p in params if getattr(p, "tp_group", None) is None)
    tp = [p for p in params if getattr(p, "tp_group", None) is not None]
    tp_sq = sum((p.grad.float() ** 2).sum() for p in tp).reshape(1)
    dist.all_reduce(tp_sq, group=tp[0].tp_group)
    return torch.sqrt(rep_sq + tp_sq[0])


def apply_update(optimizer, grad_clip: float) -> torch.Tensor:
    """optax.clip_by_global_norm(grad_clip) on the gradients, then the
    optimizer step. Returns the global norm before the clip."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if any(getattr(p, "tp_group", None) is not None for p in params):
        norm = _tp_global_norm(params)
    else:
        norm = global_norm(grads)
    if grad_clip > 0:
        factor = grad_clip / torch.clamp(norm, min=grad_clip)
        for g in grads:
            g.mul_(factor.to(g.dtype))
    optimizer.step()
    return norm


def sample_out_of_group(generator: torch.Generator, group_id: torch.Tensor,
                        row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """For each row, another valid row of a different group, uniformly
    (mesm_tpu/parallel/step.py:57-73; reference sample_outclass_neg,
    utils/data_utils.py:113-124): the argmax of Gumbel noise over the
    candidates. A row with no candidate takes (i + 1) % B."""
    B = group_id.shape[0]
    u = torch.rand((B, B), generator=generator, device=group_id.device)
    return out_of_group_rows(u, group_id, row_mask)


def eval_noise(seed: int, B: int, device) -> torch.Tensor:
    """The (B, B) uniforms the eval step draws its negatives from: a
    generator on `device` seeded with `seed` at every call, so every batch
    of B rows gets the same draw (the JAX step uses one key for every
    batch)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((B, B), generator=gen, device=device)


def out_of_group_rows(u: torch.Tensor, group_id: torch.Tensor,
                      row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sample_out_of_group on the uniforms `u` (B, B) it would draw."""
    B = group_id.shape[0]
    cand = group_id[None, :] != group_id[:, None]
    if row_mask is not None:
        cand = cand & (row_mask[None, :] > 0)
    g = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    idx = torch.argmax(torch.where(cand, g, torch.full_like(g, -float("inf"))), dim=1)
    fallback = (torch.arange(B, device=group_id.device) + 1) % B
    return torch.where(cand.any(dim=1), idx, fallback)


def step_draws(seed: int, step: int, device, micro: Optional[int] = None,
               rank: int = 0) -> Tuple[torch.Generator, torch.Generator]:
    """The random draws of train step `step`: (negatives generator, MLM
    mask generator) on `device`, and the default generators reseeded for
    the step's dropout masks. All three follow from (seed, step) alone, and
    microbatch `micro` of a grad_accum step folds its index in. The two
    generators are the same on every rank of a data-parallel step (they draw
    for the whole batch); the dropout seed folds in the data-axis `rank`
    (rank 0 keeps the single-process seed)."""
    base = ((int(seed) * 1_000_003 + int(step)) * 3) % (2**62)
    if micro is not None:
        base = ((base * 1_000_003 + int(micro) + 1) * 3) % (2**62)
    neg = torch.Generator(device=device).manual_seed(base)
    mask = torch.Generator(device=device).manual_seed(base + 1)
    torch.manual_seed((base + 2 + int(rank) * 0x9E3779B97F4A7C15) % (2**63))
    return neg, mask


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


# videos staged once and rows built from them by expand_video_rows since
# import (or since the caller last set them to 0)
video_groups_staged = 0
video_rows_expanded = 0


def expand_video_rows(batch: Dict[str, torch.Tensor],
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A training batch that carries each video once (`video_feat_g` (NG, Lv,
    Dv) and the rows' `video_slot`, data/collate.py) with each row's video as
    `video_feat` (B, Lv, Dv), built by one gather on the batch's device; the
    unique videos are cast to `dtype` first. The per-video fields go: every
    later consumer (the microbatch split, the rows' and the sequence's
    shards, the model) reads the per-row layout. A batch without
    `video_feat_g`, or with `video_feat` already, is returned as it is."""
    global video_groups_staged, video_rows_expanded
    if "video_feat_g" not in batch or "video_feat" in batch:
        return batch
    out = {k: v for k, v in batch.items() if k not in ("video_feat_g", "video_mask_g")}
    slot = batch["video_slot"].long()
    out["video_feat"] = batch["video_feat_g"].to(dtype)[slot]
    video_groups_staged += batch["video_feat_g"].shape[0]
    video_rows_expanded += slot.shape[0]
    return out


def make_micro_grads(model, ccfg: CriterionConfig, encode_text: Callable,
                     compute_dtype: torch.dtype = torch.float32):
    """micro_grads(batch, neg_generator, mask_generator, neg_idx_rows=None,
    masked_words_loc=None) -> (total, losses): one batch forward in train
    mode, the losses, and the backward into the parameters' .grad (the
    spans `train.forward`: the text encode, the negatives' draw and the
    model call; `train.loss`: compute_losses, the matcher's launches
    included; `train.backward`). neg_idx_rows / masked_words_loc, when
    given, replace the draws."""

    @torch.enable_grad()  # whatever grad mode the caller is in
    def micro_grads(batch, neg_generator=None, mask_generator=None,
                    neg_idx_rows=None, masked_words_loc=None):
        model.train()
        with span("train.forward"):
            words_feat, words_mask, sentence_feat = encode_text(batch)
            if neg_idx_rows is None:  # drawn for the whole batch (parallel/rows.py)
                neg_idx_rows = rows.local(sample_out_of_group(
                    neg_generator, rows.gather(batch["group_id"]),
                    rows.gather(batch.get("row_mask"))))
            out = model(
                batch["video_mask"], words_feat.to(compute_dtype), words_mask, sentence_feat,
                video_feat=_cast(batch.get("video_feat"), compute_dtype),
                ss_sent_idx=batch.get("ss_sent_idx"), ss_sent_mask=batch.get("ss_sent_mask"),
                ss_own_pos=batch.get("ss_own_pos"),
                ss_video_feat=_cast(batch.get("ss_video_feat"), compute_dtype),
                ss_video_mask=batch.get("ss_video_mask"), neg_idx_rows=neg_idx_rows,
                clip_mask=batch.get("clip_mask"), words_weight=batch.get("words_weight"),
                unknown_mask=batch.get("unknown_mask"), masked_words_loc=masked_words_loc,
                mask_generator=mask_generator,
            )
        with span("train.loss"):
            losses, total = compute_losses(out, batch, ccfg, is_training=True)
        with span("train.backward"):
            (total / seq.world()).backward()  # the model ranks' gradients are summed
        return total, losses

    return micro_grads


def split_micro(batch: Dict[str, torch.Tensor], k: int, world: int = 1):
    """The k microbatches of a batch: every leaf's leading axis cut into k
    consecutive slices of B/k rows, as mesm_tpu/parallel/step.py:194-200
    reshapes it (a leading axis not divisible by k raises the same
    ValueError). The reference leaves `ss_sent_idx` (rows of the whole
    batch) as it is, and its gather clamps an index past a microbatch's rows
    to the last row (jnp indexing); torch's raises, so the indices are
    clamped here to read what the reference reads (ROADMAP.md section 3).
    In a data-parallel step the batch is this rank's rows of each of the k
    microbatches (multihost.local_view(..., micro=k)), and a microbatch has
    `world` times its rows here."""
    for key, x in batch.items():
        if x.shape[0] % k != 0:
            raise ValueError(
                f"grad_accum={k} needs batch leading axis divisible by {k}, got shape "
                f"{tuple(x.shape)} ({key})"
            )
    micro = [{key: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i] for key, x in batch.items()}
             for i in range(k)]
    for mb in micro:
        if "ss_sent_idx" in mb:
            mb["ss_sent_idx"] = mb["ss_sent_idx"].clamp(max=mb["ss_sent_idx"].shape[0] * world - 1)
    return micro


def _sum_over_ranks(params, shard) -> None:
    """Every gradient summed over the ranks of `shard` (a rows.Shard of the
    data or the model axis), as one flat f32 buffer."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.float().reshape(-1) for g in grads])
    dist.all_reduce(flat, group=shard.group)
    off = 0
    for p, g in zip(params, grads):
        p.grad = flat[off:off + g.numel()].reshape(g.shape).to(g.dtype)
        off += g.numel()


def _metrics_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's part of every summed term, added over the ranks; the
    ratio diagnostics are already the whole batch's."""
    return {k: v if k.startswith(RATIO_TERMS) else rows.all_sum(v) for k, v in metrics.items()}


def make_train_step(model, ccfg: CriterionConfig, encode_text: Callable, optimizer,
                    grad_clip: float, seed: int, compute_dtype: torch.dtype = torch.float32,
                    grad_accum: int = 1, data_parallel: bool = False, data_group=None,
                    seq_parallel: bool = False, seq_group=None):
    """train_step(batch, step, neg_idx_rows=None, masked_words_loc=None) ->
    metrics (device scalars: every loss term, loss_overall, grad_norm).

    One optimizer update per batch; a batch that carries each video once
    has its rows built first (expand_video_rows). With grad_accum = k > 1
    (mesm_tpu/parallel/step.py:141-230) the batch is cut into k microbatches
    of B/k rows (split_micro); each takes its own negatives, matching and
    loss normalisation, with the draws of step_draws(seed, step, micro=i);
    the gradients are summed in f32 and divided by k, then one clip + AdamW
    update; the metrics are the means of the k microbatches' terms.
    neg_idx_rows / masked_words_loc, when given with k > 1, hold one entry
    per microbatch (a sequence, or a leading axis of k).

    With `data_parallel`, `batch` is this rank's rows (of every microbatch)
    over the data-axis process group `data_group` (the default group when
    None), neg_idx_rows index the whole batch, and the returned metrics are
    the whole batch's (see the module docstring).

    With `seq_parallel`, `batch` is this rank's block of mesh.shard_batch_seq
    over the model-axis process group `seq_group` (the default group when
    None); with `data_parallel` as well, the rows are split over
    `data_group`. The metrics are the whole batch's."""
    if seq_parallel and any(getattr(p, "tp_group", None) is not None for p in model.parameters()):
        raise ValueError("sequence sharding and the FFN tensor-parallel split (parallel/tp.py) "
                         "both take the mesh's model dim; run one or the other")
    micro_grads = make_micro_grads(model, ccfg, encode_text, compute_dtype)
    k = int(grad_accum)

    def train_step(batch, step, neg_idx_rows=None, masked_words_loc=None):
        batch = expand_video_rows(batch, compute_dtype)
        with contextlib.ExitStack() as shards:
            if data_parallel:
                shards.enter_context(rows.row_shard(data_group))
            if seq_parallel:
                shards.enter_context(seq.seq_shard(seq_group))
            return local_step(batch, step, neg_idx_rows, masked_words_loc)

    def local_step(batch: Dict[str, torch.Tensor], step: int, neg_idx_rows=None,
                   masked_words_loc=None) -> Dict[str, torch.Tensor]:
        device = batch["video_mask"].device
        shard = rows.current()
        rank, world = (shard.rank, shard.world) if shard is not None else (0, 1)
        optimizer.zero_grad(set_to_none=True)
        if k <= 1:
            neg_gen, mask_gen = step_draws(seed, step, device, rank=rank)
            total, losses = micro_grads(batch, neg_gen, mask_gen, neg_idx_rows, masked_words_loc)
            metrics = {key: v.detach() for key, v in losses.items()}
            metrics["loss_overall"] = total.detach()
        else:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            totals, terms = [], []
            for i, mb in enumerate(split_micro(batch, k, world)):
                neg_gen, mask_gen = step_draws(seed, step, device, micro=i, rank=rank)
                total, losses = micro_grads(
                    mb, neg_gen, mask_gen,
                    None if neg_idx_rows is None else neg_idx_rows[i],
                    None if masked_words_loc is None else masked_words_loc[i])
                for a, p in zip(acc, params):
                    if p.grad is not None:
                        a.add_(p.grad.float())
                        p.grad = None
                totals.append(total.detach().float())
                terms.append({key: v.detach().float() for key, v in losses.items()})
            for a, p in zip(acc, params):
                p.grad = (a / k).to(p.dtype)
            metrics = {key: torch.stack([t[key] for t in terms]).mean() for key in terms[0]}
            metrics["loss_overall"] = torch.stack(totals).mean()
        shards = [s for s in (shard, seq.current()) if s is not None]
        if shards:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            for s in shards:
                _sum_over_ranks(params, s)
        if shard is not None:
            metrics = _metrics_over_ranks(metrics)
        with span("train.update"):
            metrics["grad_norm"] = apply_update(optimizer, grad_clip)
        return metrics

    return train_step


def make_eval_step(model, encode_text: Callable, compute_dtype: torch.dtype,
                   ccfg: Optional[CriterionConfig] = None, with_loss: bool = False,
                   seed: int = 0, coalesce: int = 1):
    """Returns eval_step(batch) -> {"scores", "pred_spans", "saliency_scores"}
    for a batch of device tensors (data/pipeline.stage_batch). Under bf16
    compute the saliency scores come back in bf16, as the JAX step ships
    them (step.py:302-309); the decode upcasts.

    with_loss (the trainer's eval, mesm_tpu/parallel/step.py:233-320):
    eval_step(batch, neg_idx_rows=None) -> (predictions, losses): the
    negative pass runs (out-of-group rows drawn by sample_out_of_group from
    a generator seeded with `seed` at every call, as the JAX step draws from
    one key at every batch, or injected), and `losses` holds every term of
    compute_losses(..., is_training=False) and loss_overall.

    coalesce=K > 1 returns a CoalescedEvalStep (mesm_tpu/parallel/step.py:
    233-488 at superbatch=True): it takes K same-shape batches as one dict
    stacked by data/pipeline.stage_superbatch (leading axis K), projects
    their unique videos in one call and runs the K per-batch bodies in
    order; its outputs carry a leading K axis. The returned callable has
    `.coalesce`."""

    @torch.no_grad()
    def body(batch: Dict[str, torch.Tensor], neg_idx_rows=None, noise=None):
        """One batch's forward and outputs. `noise`: the negatives' (B, B)
        uniforms, drawn from `seed` when None."""
        model.eval()
        words_feat, words_mask, sentence_feat = encode_text(batch)
        if with_loss and neg_idx_rows is None:
            neg_idx_rows = batch.get("neg_idx_rows")
        if with_loss and neg_idx_rows is None:
            if noise is None:
                noise = eval_noise(seed, batch["group_id"].shape[0], batch["group_id"].device)
            neg_idx_rows = out_of_group_rows(noise, batch["group_id"], batch.get("row_mask"))
        out = model(
            batch["video_mask"],
            words_feat.to(compute_dtype),
            words_mask,
            sentence_feat,
            video_feat=_cast(batch.get("video_feat"), compute_dtype),
            video_feat_g=_cast(batch.get("video_feat_g"), compute_dtype),
            video_mask_g=batch.get("video_mask_g"),
            video_slot=batch.get("video_slot"),
            video_proj_g=batch.get("video_proj_g"),
            ss_sent_idx=batch.get("ss_sent_idx"),
            ss_sent_mask=batch.get("ss_sent_mask"),
            ss_own_pos=batch.get("ss_own_pos"),
            ss_video_feat=_cast(batch.get("ss_video_feat"), compute_dtype),
            ss_video_mask=batch.get("ss_video_mask"),
            neg_idx_rows=neg_idx_rows if with_loss else None,
        )
        prob = torch.softmax(out["pred_logits"], dim=-1)
        sal = out["saliency_scores"]
        if compute_dtype == torch.bfloat16:
            sal = sal.to(torch.bfloat16)
        preds = {"scores": prob[..., 0], "pred_spans": out["pred_spans"], "saliency_scores": sal}
        if not with_loss:
            return preds
        losses, total = compute_losses(out, batch, ccfg, is_training=False)
        losses = dict(losses)
        losses["loss_overall"] = total
        return preds, losses

    if coalesce > 1:
        return CoalescedEvalStep(model, body, compute_dtype, int(coalesce), with_loss, seed)

    def eval_step(batch: Dict[str, torch.Tensor], neg_idx_rows=None):
        return body(batch, neg_idx_rows)

    eval_step.coalesce = 1
    return eval_step


# CUDA graphs captured and replayed by every CoalescedEvalStep since import
# (or since the caller last set them to 0)
graphs_captured = 0
graph_replays = 0


class _Graph:
    """One captured CUDA graph: its static inputs (written before each
    replay), its static outputs (overwritten by each replay), the
    negatives' uniforms it reads and its replays so far. The graph keeps
    its cudaGraph_t (keep_graph=True), whose kernel nodes are the kernels
    each replay launches (chip_smoke.py counts them)."""

    __slots__ = ("graph", "inputs", "outputs", "noise", "replays")

    def __init__(self, graph, inputs, outputs, noise):
        self.graph, self.inputs, self.outputs, self.noise = graph, inputs, outputs, noise
        self.replays = 0

    def load(self, staged: Dict[str, torch.Tensor]) -> None:
        for k, dst in self.inputs.items():
            if dst.data_ptr() != staged[k].data_ptr():
                dst.copy_(staged[k], non_blocking=True)


class CoalescedEvalStep:
    """K same-shape eval batches per call, values equal to K per-batch calls
    (mesm_tpu/parallel/step.py:233-488, make_eval_step(coalesce=K,
    superbatch=True)).

    The argument is one dict whose tensors carry a leading K axis, the
    unique videos as 2-D rows `video_feat_rows` (K * NG * Lv, Dv)
    (data/pipeline.stage_superbatch). The unique videos of all K batches
    are projected in one call (`_hoist_video_proj`), then the K per-batch
    bodies run in order, each given its part as `video_proj_g`; with the
    loss, every batch takes the same negatives' draw, as the JAX step folds
    one key. Returns the predictions (and the losses) stacked with a
    leading K axis.

    On the CPU the call runs eagerly. On CUDA tensors it runs as one CUDA
    graph replay: the first call of a key runs the step once on a side
    stream (which builds the kernels and fills the derived-weight caches of
    ops/_weight_cache.py), then captures it into a torch.cuda.CUDAGraph with
    static inputs of its own; a later call of that key copies its tensors
    into those inputs (data/pipeline.stage_superbatch writes there directly,
    given `static_inputs`) and replays. The key is the staged signature
    (names, shapes, dtypes), K, with_loss and kernels.dispatch_state(); every
    graph is dropped when a parameter's (data_ptr, _version) stamp changes
    (an optimizer step, load_state_dict), since the graph replays the
    derived weights of the version it was captured with. The graphs share
    one memory pool. The returned tensors are the graph's static outputs:
    valid until the next call of the same key. A capture or replay that
    fails raises; there is no eager fallback on CUDA."""

    def __init__(self, model, body: Callable, compute_dtype: torch.dtype, coalesce: int,
                 with_loss: bool, seed: int):
        self.model, self._body, self.compute_dtype = model, body, compute_dtype
        self.coalesce, self.with_loss, self.seed = coalesce, with_loss, seed
        self._graphs: Dict[tuple, _Graph] = {}
        self._stamps: Optional[tuple] = None
        self._pool = None

    # -- the computation (eager; what a graph records) ----------------------

    def _hoist_video_proj(self, stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Project the unique videos of all K batches in one call before the
        K bodies (mesm_tpu/parallel/step.py:321-404): `video_feat_rows`
        becomes `video_proj_g` (K, NG, Lv, d). The projection is row-wise,
        so the rows' flat view is exact."""
        vfr = stacked.pop("video_feat_rows", None)
        if vfr is not None:
            K, NG, Lv = stacked["video_mask_g"].shape
            proj = self.model.input_vid_proj(vfr.to(self.compute_dtype))
            stacked["video_proj_g"] = proj.reshape(K, NG, Lv, proj.shape[-1])
        return stacked

    @torch.no_grad()
    def run(self, staged: Dict[str, torch.Tensor], noise: Optional[torch.Tensor] = None):
        """The hoist and the K bodies, eagerly; outputs stacked (K, ...)."""
        self.model.eval()
        stacked = self._hoist_video_proj(dict(staged))
        outs = [self._body({k: v[j] for k, v in stacked.items()}, noise=noise)
                for j in range(self.coalesce)]
        if not self.with_loss:
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        preds = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
        return preds, {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}

    # -- the call ------------------------------------------------------------

    def _check(self, arg, neg_idx_rows):
        """The argument's form and leading axis (mesm_tpu/parallel/step.py:
        444-483); injected negatives (K, B) join it as a field."""
        K = self.coalesce
        if not isinstance(arg, dict):
            raise TypeError("a coalesced eval step takes one stacked dict "
                            "(data/pipeline.stage_superbatch)")
        lead = {k: v.shape[0] for k, v in arg.items() if k != "video_feat_rows"}
        if set(lead.values()) != {K}:
            raise ValueError(f"coalesced eval step expects leading axis {K}, got {lead}")
        vfr = arg.get("video_feat_rows")
        if vfr is not None:
            k_, NG, Lv = arg["video_mask_g"].shape
            if vfr.shape[0] != k_ * NG * Lv:
                raise ValueError(f"video_feat_rows expects {k_}*{NG}*{Lv}={k_ * NG * Lv} rows, "
                                 f"got {vfr.shape[0]}")
        return arg if neg_idx_rows is None else dict(arg, neg_idx_rows=neg_idx_rows)

    def __call__(self, arg, neg_idx_rows=None):
        with span("eval.step"):
            staged = self._check(arg, neg_idx_rows)
            if staged["video_mask"].device.type != "cuda":
                return self.run(staged)
            return self._replay(staged)

    # -- CUDA graphs ---------------------------------------------------------

    def _refresh(self) -> None:
        """Drop every graph, and their memory pool, when a parameter or
        buffer has a new stamp (a pool whose graphs are all freed is freed
        with them: the next capture takes a new one)."""
        stamps = tuple((t.data_ptr(), t._version)
                       for t in (*self.model.parameters(), *self.model.buffers()))
        if stamps != self._stamps:
            if self._graphs and torch.cuda.is_initialized():
                torch.cuda.synchronize()  # no replay of them still in flight
            self._graphs.clear()
            self._pool = None
            self._stamps = stamps

    def _key(self, sig: tuple) -> tuple:
        return sig, self.coalesce, self.with_loss, kernels.dispatch_state()

    def static_inputs(self, sig: tuple) -> Optional[Dict[str, torch.Tensor]]:
        """The static inputs of the graph of staged signature `sig` under
        the current dispatch state and parameters, or None (no such graph
        yet)."""
        self._refresh()
        g = self._graphs.get(self._key(sig))
        return None if g is None else g.inputs

    def _capture(self, key: tuple, staged: Dict[str, torch.Tensor]) -> _Graph:
        global graphs_captured
        with span("eval.capture"):
            device = staged["video_mask"].device
            inputs = {k: v.clone() for k, v in staged.items()}
            noise = (eval_noise(self.seed, inputs["group_id"].shape[-1], device)
                     if self.with_loss else None)
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.run(inputs, noise)  # builds the kernels, fills the weight caches
            current.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = self.run(inputs, noise)
            graph.instantiate()
            entry = self._graphs[key] = _Graph(graph, inputs, outputs, noise)
            graphs_captured += 1
            return entry

    def _replay(self, staged: Dict[str, torch.Tensor]):
        global graph_replays
        self._refresh()
        key = self._key(staged_signature(staged))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key, staged)
        else:
            entry.load(staged)
        entry.graph.replay()
        entry.replays += 1
        graph_replays += 1
        return entry.outputs
