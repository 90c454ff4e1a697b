"""The comparison that decides `correct`, and what the per-layer readers
read.

Eval: each kept batch is run by the reference (float32, TF32 off) from the
same host batch and weights; over the batch's real rows the numbers are
the widest gap of the foreground score (`score_gap`), of the spans'
center and width (`span_gap`) and of the saliency at the valid clips
(`saliency_gap`), and the count of submission rows that differ from the
reference's decode of the program's own outputs of that batch
(`decode_mismatch_rows`, limit 0) or never came (`rows_missing`, limit 0).

Train: the reference takes the first three steps from the same weights,
batches and draws. The numbers are the first step's relative gap of the
total loss (`loss1_gap`), the worst leaf's gap between the program's and
the reference's norm of the first clipped gradient (`grad1_gap`; the
program's read from AdamW's first moment after one step), and the median
leaf's gap of the norm of the parameters' change over the three steps
(`change3_gap`), each leaf's gap over the larger of the reference's norm of
that leaf and of the median leaf. The later steps' losses and the worst
leaf's change carry the matcher's argmin flips on near ties once
round-off has moved the two sides' weights apart; they are kept in the
result's `check_look`, not compared. Leaves whose reference gradient norm is under a thousandth of the
median leaf's are left out of both: Adam moves them by round-off alone.
The three steps the same step object takes after the window are compared
the same way (`loss_end_gap`, `change_end_gap`), the reference starting
from the program's weights and AdamW moments at the window's end: so a
step that changes only after warm-up is judged too.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class Context:
    """What a per-layer reader reads: the traced slice, the host batches
    (eval) or steps (train) it covered, the launches the kernel counters
    expect in it, the model's configuration and the table of peaks."""
    cfg: dict
    slice: object
    batches: list
    steps: int = 0
    expected_launches: Dict[str, float] = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)
    dtype: str = "float32"

    def model_cfg(self) -> dict:
        from dataclasses import asdict

        from .reference.model import model_config

        return asdict(model_config(self.cfg))

    def peak_ops(self) -> float:
        return float(self.peaks["ops_per_s"][self.dtype])

    def peak_bytes(self) -> float:
        return float(self.peaks["bytes_per_s"])

    def checked_kernel_time(self, names, counter: Optional[str], per_launch: int = 1):
        """(traced launches, seconds) of the kernels whose names hold any of
        `names`; raises when the trace holds fewer than the program's
        counter says were launched."""
        from .trace import TraceIncomplete

        n, t = self.slice.kernel_time(names)
        want = self.expected_launches.get(counter, 0) * per_launch if counter else 0
        if n < want:
            raise TraceIncomplete(f"{names}: {n} kernels in the trace, {want:.0f} launched")
        return n, t


@dataclass
class Judged:
    correct: bool
    failed: int
    checks: Dict[str, dict]


def _limits(h) -> dict:
    return h.cell["limits"]


def _verdict(values: dict, limits: dict, failed: int) -> Judged:
    out = {k: {"value": float(v), "limit": float(limits[k])} for k, v in values.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in out.values())
    return Judged(correct=bool(ok), failed=failed, checks=out)


def _stage(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def reference_precision(tf32: bool):
    """float32 with TF32 off (the reference), or on (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


@torch.no_grad()
def reference_eval_outputs(ref, batch: dict, device) -> Dict[str, np.ndarray]:
    ref.eval()
    out = ref(_stage(batch, device))
    return {"scores": torch.softmax(out["pred_logits"], -1)[..., 0].cpu().numpy(),
            "pred_spans": out["pred_spans"].cpu().numpy(),
            "saliency_scores": out["saliency_scores"].cpu().numpy()}


def eval_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], batch: dict, n: int):
    vm = np.asarray(batch["video_mask"], bool)[:n]
    return {
        "score_gap": float(np.abs(prog["scores"][:n] - ref["scores"][:n]).max()),
        "span_gap": float(np.abs(prog["pred_spans"][:n] - ref["pred_spans"][:n]).max()),
        "saliency_gap": float(np.abs(prog["saliency_scores"][:n] - ref["saliency_scores"][:n])[vm].max()),
    }


def judge_eval(h, batches, kept_batch: List[int], kept: List[dict], kept_rows: List[str],
               rows_missing: int, opt, rng, tf32: bool = False) -> Judged:
    """The eval cell's check over the kept batches (at most the cell's
    `check_batches`, drawn from the seed, the first and the last pass's
    always among them)."""
    from .reference.decode import decode_rows

    limit = int(h.cell.get("check_batches", 12))
    idx = list(range(len(kept)))
    if len(idx) > limit:
        mid = rng.choice(idx[1:-1], limit - 2, replace=False).tolist()
        idx = sorted({idx[0], idx[-1], *mid})
    reference_precision(tf32)
    ref = h.reference_model()
    gaps = {"score_gap": 0.0, "span_gap": 0.0, "saliency_gap": 0.0}
    mismatched = 0
    cache = {}
    for i in idx:
        b = kept_batch[i]
        batch, meta = batches[b]
        n = meta["n_rows"]
        if b not in cache:
            cache[b] = reference_eval_outputs(ref, batch, h.device)
        for k, v in eval_gaps(kept[i], cache[b], batch, n).items():
            gaps[k] = max(gaps[k], v)
        want = decode_rows(kept[i]["scores"][:n], kept[i]["pred_spans"][:n],
                           kept[i]["saliency_scores"][:n],
                           np.asarray(batch["video_mask"])[:n].sum(1), meta, opt.clip_len,
                           opt.max_ts_val, opt.sort_results)
        got = {r["qid"]: r for r in json.loads(kept_rows[i])}
        mismatched += sum(1 for w in want if got.get(w["qid"]) != w)
    reference_precision(False)
    del ref
    values = dict(gaps, decode_mismatch_rows=mismatched, rows_missing=rows_missing)
    return _verdict(values, _limits(h), failed=mismatched)


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep):
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref)), over the leaves in `keep`."""
    pn = {k: float(prog[k].double().norm()) for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep}


def judge_train(h, values: dict, failed: int) -> Judged:
    return _verdict(values, _limits(h), failed=failed)
