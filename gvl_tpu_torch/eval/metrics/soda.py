"""SODA (Story-Oriented Dense-video-captioning evaluation) — SODA-c.

Behavioral spec: reference densevid_eval3/SODA/soda.py + eval_soda.py —
per video: IoU matrix (GT x pred) and METEOR score matrix; monotonic DP
assignment (dp[i,j] = max(dp[i-1,j], dp[i,j-1], dp[i-1,j-1]+s[i,j])) over
iou*score for SODA-c; precision = max_score/n_pred, recall = /n_gt, F1;
best reference set per video; mean over videos; eval_soda averages F1 across
reference files. Predictions and GT are sorted by start time
(SODA/dataset.py:56-58,75).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

from gvl_tpu_torch.eval.metrics.dvc_eval import _iou, remove_nonascii
from gvl_tpu_torch.eval.metrics.scorers import Meteor, ptb_tokenize


def chased_dp_assignment(scores: np.ndarray) -> float:
    """Monotonic alignment DP; returns the max total score."""
    M, N = scores.shape
    dp = np.zeros((M, N))
    for i in range(M):
        for j in range(N):
            best = scores[i, j]
            if i > 0 and j > 0:
                best = max(dp[i - 1, j], dp[i, j - 1],
                           dp[i - 1, j - 1] + scores[i, j])
            elif i > 0:
                best = max(dp[i - 1, j], scores[i, j])
            elif j > 0:
                best = max(dp[i, j - 1], scores[i, j])
            dp[i, j] = best
    return float(dp[M - 1, N - 1])


def _tokenize_sents(sents: List[str]) -> List[str]:
    toks = ptb_tokenize({i: [{"caption": remove_nonascii(s)}]
                         for i, s in enumerate(sents)})
    return [toks[i][0] for i in range(len(sents))]


def eval_soda(prediction_file: str, ref_list: List[str],
              verbose: bool = False) -> Dict[str, float]:
    with open(prediction_file) as f:
        preds_raw = json.load(f)["results"]
    meteor = Meteor()

    f1_per_ref = []
    for ref_file in ref_list:
        with open(ref_file) as f:
            gt = json.load(f)
        gt_vids = [v for v in gt.keys() if v in preds_raw]
        f_scores, p_scores, r_scores = [], [], []
        for vid in gt_vids:
            pred = sorted(preds_raw[vid], key=lambda x: x["timestamp"][0])
            if not pred:
                f_scores.append(0.0)
                p_scores.append(0.0)
                r_scores.append(0.0)
                continue
            g_ts, g_sents = zip(*sorted(
                zip(gt[vid]["timestamps"], gt[vid]["sentences"]),
                key=lambda x: x[0][0]))
            p_ts = [p["timestamp"] for p in pred]
            p_sents = _tokenize_sents([p["sentence"] for p in pred])
            g_sents = _tokenize_sents(list(g_sents))

            iou_mat = np.array([[_iou(pt, ct) for pt in p_ts]
                                for ct in g_ts])           # (n_gt, n_pred)
            # score[i, j] = METEOR(hyp=gold_i, ref=pred_j) — argument order
            # mirrors the reference's compute_score(res, gt) call
            # (SODA/soda.py:64-69)
            score_mat = np.array(
                [[meteor.score_segment(gs, [ps])[0] for ps in p_sents]
                 for gs in g_sents])
            max_score = chased_dp_assignment(iou_mat * score_mat)
            n_g, n_p = iou_mat.shape
            p = max_score / n_p
            r = max_score / n_g
            p_scores.append(p)
            r_scores.append(r)
            f_scores.append(2 * p * r / (p + r) if p + r > 0 else 0.0)
        f1_per_ref.append(float(np.mean(f_scores)) if f_scores else 0.0)

    out = {"soda_c": float(np.mean(f1_per_ref))}
    from gvl_tpu_torch.eval.metrics.meteor import approximations
    if approximations():             # SODA-c is METEOR-weighted (VERDICT #6)
        out["approx"] = approximations()
    return out
