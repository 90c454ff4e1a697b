"""Host-side moment-retrieval metric suite.

Parity targets (reference eval.py): eval_submission (:164-230),
eval_moment_retrieval length ranges (:233-262), compute_mr_ap VOC-interpolated
AP (:265-409 + utils/data_utils.py:166-182), compute_mr_r1 + mIoU (:412-440),
get_data_by_range (:443-473). Math is bit-identical (including the loose
paired-IoU union used for R1); the implementation is plain numpy on host —
metrics are IO-bound bookkeeping, not device work.
"""
from __future__ import annotations

import copy
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np

from .ops.span import np_temporal_iou_cross, np_temporal_iou_paired

# (length ranges, names, global max) per dataset family (reference eval.py:234-241)
_TACOS_RANGES = ([[0, 10], [10, 30], [30, 150], [150, 600], [0, 600]],
                 ["short", "middle", "long", "superlong", "full"], 600)
_DEFAULT_RANGES = ([[0, 10], [10, 30], [30, 150], [0, 150]],
                   ["short", "middle", "long", "full"], 150)


def interpolated_precision_recall(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP (reference utils/data_utils.py:166-182)."""
    mprec = np.concatenate([[0.0], precision, [0.0]])
    mrec = np.concatenate([[0.0], recall, [1.0]])
    # make precision monotonically decreasing from the right
    mprec = np.maximum.accumulate(mprec[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_detection(
    ground_truth: List[Dict], prediction: List[Dict], tiou_thresholds: np.ndarray
) -> np.ndarray:
    """Greedy TP assignment at each IoU threshold, then interpolated AP
    (reference eval.py:326-409)."""
    n_thds = len(tiou_thresholds)
    n_gts = len(ground_truth)
    ap = np.zeros(n_thds)
    if not prediction:
        return ap

    lock_gt = np.full((n_thds, n_gts), -1)
    prediction = sorted(prediction, key=lambda x: -x["score"])
    tp = np.zeros((n_thds, len(prediction)))
    fp = np.zeros((n_thds, len(prediction)))

    gts_by_vid: Dict = {}
    for i, item in enumerate(ground_truth):
        item = dict(item, index=i)
        gts_by_vid.setdefault(item["video-id"], []).append(item)

    for p_idx, pred in enumerate(prediction):
        gts = gts_by_vid.get(pred["video-id"])
        if gts is None:
            fp[:, p_idx] = 1
            continue
        pred_arr = np.array([[pred["t-start"], pred["t-end"]]])
        gt_arr = np.array([[g["t-start"], g["t-end"]] for g in gts])
        tious = np_temporal_iou_cross(pred_arr, gt_arr)[0].reshape(-1)
        order = tious.argsort()[::-1]
        for t_idx, thd in enumerate(tiou_thresholds):
            for j in order:
                if tious[j] < thd:
                    fp[t_idx, p_idx] = 1
                    break
                if lock_gt[t_idx, gts[j]["index"]] >= 0:
                    continue
                tp[t_idx, p_idx] = 1
                lock_gt[t_idx, gts[j]["index"]] = p_idx
                break
            if fp[t_idx, p_idx] == 0 and tp[t_idx, p_idx] == 0:
                fp[t_idx, p_idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(float)
    fp_cum = np.cumsum(fp, axis=1).astype(float)
    recall = tp_cum / float(n_gts)
    precision = tp_cum / (tp_cum + fp_cum)
    for t_idx in range(n_thds):
        ap[t_idx] = interpolated_precision_recall(precision[t_idx], recall[t_idx])
    return ap


def compute_mr_ap(
    submission: List[Dict],
    ground_truth: List[Dict],
    iou_thds: np.ndarray = np.linspace(0.5, 0.95, 10),
    max_pred_windows: Optional[int] = 10,
) -> Dict[str, float]:
    iou_thds = [float(f"{t:.2f}") for t in iou_thds]
    preds_by_qid = defaultdict(list)
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        for w in windows:
            preds_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1], "score": w[2]}
            )
    gts_by_qid = defaultdict(list)
    for d in ground_truth:
        for w in d["relevant_windows"]:
            gts_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1]}
            )

    # one process: a worker pool gains nothing at eval-set sizes (charades'
    # 3,720 queries take about a second) and would leave its forkserver and
    # resource tracker running after the pool closes
    thds = np.asarray(iou_thds)
    ap_matrix = np.array([  # (#qids, #thds)
        average_precision_detection(gts_by_qid[qid], preds, thds)
        for qid, preds in preds_by_qid.items()
    ])
    ap_mean = ap_matrix.mean(0)
    out = {str(t): float(f"{100 * v:.2f}") for t, v in zip(iou_thds, ap_mean)}
    out["average"] = float(f"{100 * ap_mean.mean():.2f}")
    return out


def compute_mr_r1(
    submission: List[Dict],
    ground_truth: List[Dict],
    iou_thds: np.ndarray = np.linspace(0.5, 0.95, 10),
) -> Dict[str, float]:
    """Top-1 recall against the best-IoU GT window + mIoU
    (reference eval.py:412-440)."""
    iou_thds = [float(f"{t:.2f}") for t in iou_thds]
    pred_by_qid = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_by_qid = {}
    ious = []
    for d in ground_truth:
        windows = d["relevant_windows"]
        best = 0
        if len(windows) > 0:
            cur = np_temporal_iou_cross(
                np.array([pred_by_qid[d["qid"]]]), np.array(windows)
            )[0]
            ious.append(float(np.max(cur)))
            best = int(np.argmax(cur))
        gt_by_qid[d["qid"]] = windows[best]

    miou = float(np.mean(ious)) if ious else 0.0
    qids = list(pred_by_qid.keys())
    pred = np.array([pred_by_qid[q] for q in qids], dtype=float)
    gt = np.array([gt_by_qid[q] for q in qids], dtype=float)
    paired = np_temporal_iou_paired(pred, gt)
    out = {str(t): float(f"{np.mean(paired >= t) * 100:.2f}") for t in iou_thds}
    out["miou"] = float(f"{miou * 100:.2f}")
    return out


def get_data_by_range(submission, ground_truth, len_range, global_max_length):
    """Keep queries whose GT window length is in (min_l, max_l]
    (reference eval.py:443-473)."""
    min_l, max_l = len_range
    if min_l == 0 and max_l == global_max_length:
        return submission, ground_truth
    gt_in_range = []
    qids = set()
    for d in ground_truth:
        windows = [w for w in d["relevant_windows"] if min_l < (w[1] - w[0]) <= max_l]
        if windows:
            d = copy.deepcopy(d)
            d["relevant_windows"] = windows
            gt_in_range.append(d)
            qids.add(d["qid"])
    sub_in_range = [copy.deepcopy(d) for d in submission if d["qid"] in qids]
    return sub_in_range, gt_in_range


def eval_moment_retrieval(submission, ground_truth, dataset_name="charades"):
    ranges, names, max_len = _TACOS_RANGES if dataset_name == "tacos" else _DEFAULT_RANGES
    out = {}
    for rng, name in zip(ranges, names):
        sub, gt = get_data_by_range(submission, ground_truth, rng, max_len)
        if len(gt) == 0:
            continue
        ap = compute_mr_ap(sub, gt)
        if dataset_name == "tacos":
            iou_thds = np.array([0.1, 0.3, 0.5, 0.7])
        else:
            iou_thds = np.concatenate([np.array([0.3]), np.linspace(0.5, 0.95, 10)])
        r1 = compute_mr_r1(sub, gt, iou_thds=iou_thds)
        out[name] = {"MR-mAP": ap, "MR-R1": r1}
    return out


def eval_submission(submission, ground_truth, dataset_name="charades"):
    """Full metric bundle + the 'brief' dict the train loop keys off
    (reference eval.py:164-230)."""
    metrics = {}
    brief = OrderedDict()
    if submission and "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth, dataset_name)
        metrics.update(mr)
        full = mr.get("full", {})
        r1 = full.get("MR-R1", {})
        ap = full.get("MR-mAP", {})
        raw_brief = {
            "MR-full-R1@0.3": r1.get("0.3"),
            "MR-full-R1@0.5": r1.get("0.5"),
            "MR-full-R1@0.7": r1.get("0.7"),
            "MR-full-miou": r1.get("miou"),
            "MR-full-mAP": ap.get("average"),
            "MR-full-mAP@0.5": ap.get("0.5"),
            "MR-full-mAP@0.75": ap.get("0.75"),
            "MR-short-mAP": mr.get("short", {}).get("MR-mAP", {}).get("average"),
            "MR-middle-mAP": mr.get("middle", {}).get("MR-mAP", {}).get("average"),
            "MR-long-mAP": mr.get("long", {}).get("MR-mAP", {}).get("average"),
            "MR-superlong-mAP": mr.get("superlong", {}).get("MR-mAP", {}).get("average"),
        }
        brief.update(sorted(raw_brief.items(), key=lambda kv: kv[0]))
    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items(), key=lambda kv: kv[0]))
    return final
