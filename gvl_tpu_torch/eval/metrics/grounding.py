"""Video grounding metrics: mIoU and R@k@IoU.

Behavioral spec: reference densevid_eval3/eval_grounding.py — per GT sentence
(keyed '<vid>-<anno_id>'), tIoU of the top prediction for mIoU (missing keys
count as 0 in the mean) and hit-at-k over thresholds {0.1,0.3,0.5,0.7} with
k in {1,5}.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict


def tiou(pred, gt) -> float:
    sp, ep = pred
    s, e = gt
    inter = max(0.0, min(e, ep) - max(s, sp))
    union = min(max(e, ep) - min(s, sp), (e - s) + (ep - sp))
    return float(inter) / (union + 1e-8)


def eval_grounding_result(result_file: str, gt_file: str) -> Dict[str, float]:
    with open(result_file) as f:
        results = json.load(f)["results"]
    with open(gt_file) as f:
        gt_data = json.load(f)

    gts = {}
    for vid, gd in gt_data.items():
        for anno_id, ts in enumerate(gd["timestamps"]):
            gts[f"{vid}-{anno_id}"] = ts

    scores: Dict[str, float] = {}
    ious = []
    for key, ts in gts.items():
        if key in results:
            ious.append(tiou(results[key][0]["timestamp"], ts))
    scores["mIOU"] = sum(ious) / max(len(gts), 1)

    for thr, k in itertools.product([0.7, 0.5, 0.3, 0.1], [1, 5]):
        hit = 0
        for key, ts in gts.items():
            preds = results.get(key, [])[:k]
            if any(tiou(p["timestamp"], ts) >= thr for p in preds):
                hit += 1
        scores[f"R@{k}IOU{thr}"] = hit / max(len(gts), 1)
    return scores
