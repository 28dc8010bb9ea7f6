"""Temporal action localization mAP (ActivityNet-style).

Behavioral spec: reference densevid_eval3/eval_tal.py (itself the official
ActivityNet eval): per class, predictions sorted by score match GT segments
greedily at each tIoU in 0.5:0.05:0.95; interpolated precision-recall AP;
mAP averaged over classes then thresholds. Returns
{'TAL_Average_mAP': float} like the reference's eval_tal (eval_tal.py:192).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

import numpy as np


def segment_iou(target, candidates) -> np.ndarray:
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(tt2 - tt1, 0, None)
    union = ((candidates[:, 1] - candidates[:, 0])
             + (target[1] - target[0]) - inter)
    return inter / np.maximum(union, 1e-8)


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_detection(gt_segments: np.ndarray,
                                pred_segments: np.ndarray,
                                pred_scores: np.ndarray,
                                gt_video_ids: List[str],
                                pred_video_ids: List[str],
                                tiou_thresholds: np.ndarray) -> np.ndarray:
    n_thr = len(tiou_thresholds)
    npos = len(gt_segments)
    ap = np.zeros(n_thr)
    if len(pred_segments) == 0 or npos == 0:
        return ap
    order = np.argsort(-pred_scores)
    pred_segments = pred_segments[order]
    pred_video_ids = [pred_video_ids[i] for i in order]

    gt_by_vid = defaultdict(list)
    for i, vid in enumerate(gt_video_ids):
        gt_by_vid[vid].append(i)

    lock = np.zeros((n_thr, npos), dtype=bool)
    tp = np.zeros((n_thr, len(pred_segments)))
    fp = np.zeros((n_thr, len(pred_segments)))
    for pi, (seg, vid) in enumerate(zip(pred_segments, pred_video_ids)):
        gt_idx = gt_by_vid.get(vid, [])
        if not gt_idx:
            fp[:, pi] = 1
            continue
        cands = np.array([gt_segments[i] for i in gt_idx])
        ious = segment_iou(seg, cands)
        order_iou = np.argsort(-ious)
        for ti, thr in enumerate(tiou_thresholds):
            hit = False
            for oi in order_iou:
                if ious[oi] < thr:
                    break
                if lock[ti, gt_idx[oi]]:
                    continue
                lock[ti, gt_idx[oi]] = True
                tp[ti, pi] = 1
                hit = True
                break
            if not hit:
                fp[ti, pi] = 1

    tp_cum = np.cumsum(tp, axis=1)
    fp_cum = np.cumsum(fp, axis=1)
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-8)
    for ti in range(n_thr):
        ap[ti] = interpolated_prec_rec(prec[ti], rec[ti])
    return ap


def eval_tal(ground_truth_filename: str, prediction_filename: str,
             subset: str = "validation",
             tiou_thresholds=np.linspace(0.5, 0.95, 10),
             verbose: bool = False) -> Dict[str, float]:
    with open(ground_truth_filename) as f:
        gt_data = json.load(f)
    with open(prediction_filename) as f:
        pred_data = json.load(f)

    activity_index: Dict[str, int] = {}
    gt_by_class = defaultdict(lambda: ([], []))   # label -> (segments, vids)
    for vid, v in gt_data["database"].items():
        if v["subset"] != subset:
            continue
        for ann in v["annotations"]:
            label = ann["label"]
            if label not in activity_index:
                activity_index[label] = len(activity_index)
            segs, vids = gt_by_class[label]
            segs.append([float(ann["segment"][0]), float(ann["segment"][1])])
            vids.append(vid)

    pred_by_class = defaultdict(lambda: ([], [], []))
    for vid, items in pred_data["results"].items():
        for item in items:
            label = item["label"]
            segs, scores, vids = pred_by_class[label]
            segs.append([float(item["segment"][0]), float(item["segment"][1])])
            scores.append(float(item["score"]))
            vids.append(vid)

    aps = []
    for label in activity_index:
        g_segs, g_vids = gt_by_class[label]
        p_segs, p_scores, p_vids = pred_by_class.get(label, ([], [], []))
        ap = average_precision_detection(
            np.array(g_segs), np.array(p_segs), np.array(p_scores),
            g_vids, p_vids, np.asarray(tiou_thresholds))
        aps.append(ap)
    ap_matrix = np.stack(aps) if aps else np.zeros((1, len(tiou_thresholds)))
    m_ap = ap_matrix.mean(axis=0)
    average_map = float(m_ap.mean())
    if verbose:
        print(f"TAL mAP per tIoU: {m_ap}")
    return {"TAL_Average_mAP": average_map}
