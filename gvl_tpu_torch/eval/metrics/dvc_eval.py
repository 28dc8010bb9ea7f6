"""Dense-video-captioning evaluator (ActivityNet Captions 2018/2021 style).

Behavioral spec: reference densevid_eval3/evaluate2018.py / evaluate2021.py /
eval_dvc.py —
- per tIoU in {0.3,0.5,0.7,0.9}: each prediction is paired with every GT
  caption whose segment tIoU >= threshold across all reference sets; a
  prediction with no overlap is paired with a garbage GT ('abc123!@#' in the
  2018 toolkit, a random string in 2021);
- each scorer computes per VIDEO over that video's pairs, videos are
  averaged, and eval_metrics averages over tIoUs; non-verbose runs METEOR
  only (evaluate2018.py:54-63);
- '2018_cider' (evaluate2018_cider.py + eval_dvc.py:17-20): verbose forced,
  tIoU {0.9} only, and scoring is corpus-level over the bucket;
- detection Recall/Precision: per video, best-over-refsets fraction of GT
  segments covered / predictions valid at the tIoU.

Scorers are the pure-Python set in gvl_tpu_torch.eval.metrics.scorers (incl.
the faithful METEOR 1.5 port in gvl_tpu_torch/eval/metrics/meteor.py).
"""

from __future__ import annotations

import json
import random
import string
from typing import Dict, List

import numpy as np

from gvl_tpu_torch.eval.metrics.scorers import (Bleu, Cider, Meteor, Rouge,
                                          ptb_tokenize)


def _iou(interval_1, interval_2) -> float:
    start, end = interval_2
    start_i, end_i = interval_1
    intersection = max(0.0, min(end, end_i) - max(start, start_i))
    union = min(max(end, end_i) - min(start, start_i),
                end - start + end_i - start_i)
    return float(intersection) / (union + 1e-8)


def remove_nonascii(text: str) -> str:
    # reference evaluate2018.py:25 replaces non-ascii with a SPACE (it does
    # not drop the char): "naïve" -> "na ve" -> tokens ["na","ve"]
    return "".join(c if ord(c) < 128 else " " for c in text)


class DVCEvaluator:
    def __init__(self, ground_truth_filenames: List[str],
                 prediction_filename: str,
                 tious=(0.3, 0.5, 0.7, 0.9), max_proposals: int = 1000,
                 version: str = "2018", verbose: bool = False,
                 no_lang_eval: bool = False):
        self.tious = list(tious)
        self.version = version
        self.verbose = verbose
        self.no_lang_eval = no_lang_eval
        self.max_proposals = max_proposals
        self.ground_truths = [json.load(open(f)) for f in ground_truth_filenames]
        pred = json.load(open(prediction_filename))
        self.prediction = {k: v[:max_proposals]
                           for k, v in pred["results"].items()}
        full_set = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        if version == "2018_cider":
            # reference evaluate2018_cider.py:55-65: non-verbose runs CIDEr
            # only; scoring is corpus-level over the tIoU bucket instead of
            # per-video averaged. The reference's verbose set also includes
            # SPICE (evaluate2018_cider.py:62) — provided here by the pure-
            # Python port in metrics/spice.py (approximate parser; see its
            # module docstring).
            from gvl_tpu_torch.eval.metrics.spice import Spice
            self.scorers = (full_set + [(Spice(), "SPICE")]) if verbose \
                else [(Cider(), "CIDEr")]
        else:
            # reference evaluate2018.py:54-63: "if not verbose, we only use
            # the one we're testing on: METEOR"
            self.scorers = full_set if verbose else [(Meteor(), "METEOR")]

    def get_gt_vid_ids(self):
        vid_ids = set()
        for gt in self.ground_truths:
            vid_ids |= set(gt.keys())
        return list(vid_ids)

    def _garbage(self) -> str:
        if self.version == "2021":
            return "".join(random.choices(string.ascii_lowercase, k=10))
        return "abc123!@#"

    def evaluate(self) -> Dict[str, List[float]]:
        scores: Dict[str, List[float]] = {}
        if not self.no_lang_eval:
            for tiou in self.tious:
                out = self.evaluate_tiou(tiou)
                for metric, s in out.items():
                    scores.setdefault(metric, []).append(s)
        scores["Recall"] = []
        scores["Precision"] = []
        for tiou in self.tious:
            precision, recall = self.evaluate_detection(tiou)
            scores["Recall"].append(recall)
            scores["Precision"].append(precision)
        approx = self.approximations()
        if approx:
            scores["approx"] = approx
        return scores

    def approximations(self) -> List[str]:
        """Approximation markers for the scorers this run actually uses
        (VERDICT r4 #6): METEOR's absent jar data files, SPICE's chunker
        parser. Empty when the language eval is off or all data installed."""
        if self.no_lang_eval:
            return []
        from gvl_tpu_torch.eval.metrics import meteor as _meteor
        from gvl_tpu_torch.eval.metrics import spice as _spice
        out: List[str] = []
        for scorer, _ in self.scorers:
            if isinstance(scorer, Meteor):
                out.extend(_meteor.approximations())
            elif isinstance(scorer, _spice.Spice):
                out.extend(_spice.approximations())
        return sorted(set(out))

    def evaluate_detection(self, tiou: float):
        gt_vid_ids = self.get_gt_vid_ids()
        recall = np.zeros(len(gt_vid_ids))
        precision = np.zeros(len(gt_vid_ids))
        for vi, vid in enumerate(gt_vid_ids):
            best_r, best_p = 0.0, 0.0
            for gt in self.ground_truths:
                if vid not in gt:
                    continue
                refs = gt[vid]
                ref_cov, pred_cov = set(), set()
                if vid in self.prediction and self.prediction[vid]:
                    preds = self.prediction[vid]
                    for pi, pred in enumerate(preds):
                        for ri, ref_ts in enumerate(refs["timestamps"]):
                            if _iou(pred["timestamp"], ref_ts) > tiou:
                                ref_cov.add(ri)
                                pred_cov.add(pi)
                    best_p = max(best_p, len(pred_cov) / len(preds))
                best_r = max(best_r, len(ref_cov) / len(refs["timestamps"]))
            recall[vi] = best_r
            precision[vi] = best_p
        return float(precision.mean()), float(recall.mean())

    def evaluate_tiou(self, tiou: float) -> Dict[str, float]:
        gt_vid_ids = self.get_gt_vid_ids()
        vid2capid = {vid: [] for vid in gt_vid_ids}
        cur_res, cur_gts = {}, {}
        idx = 0
        for vid in gt_vid_ids:
            for pred in self.prediction.get(vid, []):
                added = False
                for gt in self.ground_truths:
                    if vid not in gt:
                        continue
                    caps = gt[vid]
                    for ci, ts in enumerate(caps["timestamps"]):
                        if _iou(pred["timestamp"], ts) >= tiou:
                            cur_res[idx] = [
                                {"caption": remove_nonascii(pred["sentence"])}]
                            cur_gts[idx] = [
                                {"caption": remove_nonascii(caps["sentences"][ci])}]
                            vid2capid[vid].append(idx)
                            idx += 1
                            added = True
                if not added:
                    cur_res[idx] = [
                        {"caption": remove_nonascii(pred["sentence"])}]
                    cur_gts[idx] = [{"caption": self._garbage()}]
                    vid2capid[vid].append(idx)
                    idx += 1

        tok_res = ptb_tokenize(cur_res)
        tok_gts = ptb_tokenize(cur_gts)

        output = {}
        for scorer, method in self.scorers:
            if self.version == "2018_cider":
                # corpus-level: one compute_score over every pair in the
                # bucket (reference evaluate2018_cider.py:226)
                score, _ = scorer.compute_score(tok_gts, tok_res) \
                    if tok_res else ([0] * len(method)
                                     if isinstance(method, list) else 0, None)
                if isinstance(method, list):
                    for mi, m in enumerate(method):
                        output[m] = float(score[mi])
                else:
                    output[method] = float(score)
                continue
            all_scores = {}
            for vid in gt_vid_ids:
                res_v = {i: tok_res[i] for i in vid2capid[vid]}
                gts_v = {i: tok_gts[i] for i in vid2capid[vid]}
                if not res_v or not gts_v:
                    score = [0] * len(method) if isinstance(method, list) else 0
                else:
                    score, _ = scorer.compute_score(gts_v, res_v)
                all_scores[vid] = score
            if isinstance(method, list):
                mean = np.mean(list(all_scores.values()), axis=0)
                for mi, m in enumerate(method):
                    output[m] = float(mean[mi])
            else:
                output[method] = float(np.mean(list(all_scores.values())))
        return output


def eval_dvc(json_path: str, reference: List[str], version: str = "2018",
             verbose: bool = False, no_lang_eval: bool = False
             ) -> Dict[str, List[float]]:
    """Dispatcher equivalent of reference densevid_eval3/eval_dvc.py:
    '2018_cider' forces verbose=True and tIoU {0.9} (eval_dvc.py:17-20)."""
    assert version in ("2018", "2021", "2018_cider")
    tious = (0.9,) if version == "2018_cider" else (0.3, 0.5, 0.7, 0.9)
    if version == "2018_cider":
        verbose = True
    ev = DVCEvaluator(reference, json_path, tious=tious, version=version,
                      verbose=verbose, no_lang_eval=no_lang_eval)
    return ev.evaluate()
