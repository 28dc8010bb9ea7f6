"""Metric harness façade.

Mirrors reference eval_utils.py:117-133 — eval_metrics averages each DVC
metric over its tIoU list, adds SODA-c, paragraph metrics, and
MetaScore = METEOR + soda_c; eval_metrics_grounding prefixes grounding keys.

The port's copy of gvl_tpu/eval/metrics, pure Python like it; the one change
is that METEOR stems with a copy of nltk's English Snowball stemmer
(snowball.py) instead of importing nltk.
"""

from __future__ import annotations

import collections
from typing import Dict, List

from gvl_tpu_torch.eval.metrics.dvc_eval import eval_dvc  # noqa: F401
from gvl_tpu_torch.eval.metrics.grounding import eval_grounding_result  # noqa: F401
from gvl_tpu_torch.eval.metrics.para import eval_para  # noqa: F401
from gvl_tpu_torch.eval.metrics.soda import eval_soda  # noqa: F401
from gvl_tpu_torch.eval.metrics.tal import eval_tal  # noqa: F401


def eval_metrics(dvc_filename: str, gt_filenames: List[str],
                 para_gt_filenames: List[str], dvc_eval_version: str = "2018",
                 verbose: bool = False) -> Dict[str, float]:
    score = collections.defaultdict(lambda: -1.0)
    approx: set = set()
    dvc_score = eval_dvc(json_path=dvc_filename, reference=gt_filenames,
                         version=dvc_eval_version, verbose=verbose)
    approx.update(dvc_score.pop("approx", []))
    dvc_score = {k: sum(v) / len(v) for k, v in dvc_score.items()}
    soda_score = eval_soda(dvc_filename, ref_list=gt_filenames)
    approx.update(soda_score.pop("approx", []))
    dvc_score.update(soda_score)
    if para_gt_filenames:
        para_score = eval_para(dvc_filename, para_gt_filenames)
        approx.update(para_score.pop("approx", []))
        dvc_score.update(para_score)
    dvc_score["MetaScore"] = dvc_score["METEOR"] + dvc_score["soda_c"]
    score.update(dvc_score)
    if approx:
        # non-numeric, deliberately: any consumer that blindly floats every
        # value (a parity comparison, a plot) fails loudly instead of
        # treating an approximate METEOR/SPICE number as exact. Selection
        # logic (criteria_score) reads specific keys and never sees it.
        score["approx"] = sorted(approx)
    return score


def eval_metrics_grounding(g_filename: str, gt_filename: str
                           ) -> Dict[str, float]:
    score = collections.defaultdict(lambda: -1.0)
    for k, v in eval_grounding_result(g_filename, gt_filename).items():
        score["grounding_" + k] = v
    return score
