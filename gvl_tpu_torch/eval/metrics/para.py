"""Paragraph captioning evaluation.

Behavioral spec: reference densevid_eval3/para_evaluate.py + eval_para.py —
predictions are concatenated into one paragraph per video ('sentence' + '. '),
both sides are parsed with parse_sent (strip non-letters, lowercase, split),
scored with Bleu/METEOR/ROUGE/CIDEr across videos, and keys are prefixed
'para_'. GT files map vid -> paragraph string; vids get a 'v_' prefix when
missing (ensure_caption_key).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

from gvl_tpu_torch.eval.metrics.scorers import Bleu, Cider, Meteor, Rouge


def parse_sent(sent: str) -> List[str]:
    res = re.sub("[^a-zA-Z]", " ", sent)
    return res.strip().lower().split()


def _ensure_v_prefix(d: Dict) -> Dict:
    if not d:
        return d
    if not list(d.keys())[0].startswith("v_"):
        return {"v_" + k: v for k, v in d.items()}
    return d


def eval_para(prediction_file: str, referneces: List[str],
              verbose: bool = False) -> Dict[str, float]:
    with open(prediction_file) as f:
        submission = json.load(f)["results"]
    para_sub = {vid: "".join(info["sentence"] + ". " for info in items)
                for vid, items in submission.items()}
    para_sub = _ensure_v_prefix(para_sub)

    gts_list = []
    for fname in referneces:
        with open(fname) as f:
            gts_list.append(_ensure_v_prefix(json.load(f)))

    vid_ids = sorted(set().union(*[set(g.keys()) for g in gts_list]))
    gts = {i: [] for i in range(len(vid_ids))}
    for g in gts_list:
        for i, vid in enumerate(vid_ids):
            if vid in g:
                gts[i].append(" ".join(parse_sent(g[vid])))
    res = {i: [" ".join(parse_sent(para_sub[vid]))]
           if vid in para_sub and para_sub[vid] else [""]
           for i, vid in enumerate(vid_ids)}

    out = {}
    for scorer, method in [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"), (Rouge(), "ROUGE_L"), (Cider(), "CIDEr")]:
        score, _ = scorer.compute_score(gts, res)
        if isinstance(method, list):
            for m, s in zip(method, score):
                out["para_" + m] = float(s)
        else:
            out["para_" + method] = float(score)
    from gvl_tpu_torch.eval.metrics.meteor import approximations
    if approximations():             # para_METEOR inherits the marker
        out["approx"] = approximations()
    return out
