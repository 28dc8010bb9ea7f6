"""Post-processing: top-k detection outputs and contrastive grounding.
Port of gvl_tpu/eval/postprocess.py:27-102."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from gvl_tpu_torch.train.criterion import cl_match_matrix
from gvl_tpu_torch.train.lap import batched_lap
from gvl_tpu_torch.utils.boxes import box_cl_to_xy


@dataclasses.dataclass(frozen=True)
class GroundingSpec:
    """The eval grounding matcher's weights (postprocess.py:27-35)."""
    cost_cl: float = 1.0
    cost_class: float = 0.0
    alpha: float = 0.25
    gamma: float = 2.0
    maximum_matching: bool = False

    @classmethod
    def from_config(cls, cfg: Any) -> "GroundingSpec":
        """As the JAX EvalRunner builds it (evaluate.py:91-95)."""
        return cls(
            cost_cl=float(getattr(cfg, "eval_set_cost_cl", 1.0)),
            cost_class=float(getattr(cfg, "eval_set_cost_class", 0.0)),
            alpha=float(getattr(cfg, "eval_grounding_cost_alpha", 0.25)),
            gamma=float(getattr(cfg, "eval_grounding_cost_gamma", 2.0)),
            maximum_matching=bool(getattr(
                cfg, "eval_enable_maximum_matching_for_grounding", False)))


def detection_outputs(outputs: Dict, durations: torch.Tensor) -> Dict:
    """Top-k over query x class scores + box scaling, from the last decoder
    layer (reference: PostProcess.forward, pdvc.py:1009-1028)."""
    logits = outputs["pred_logits"][-1]             # (B, Nq, K)
    boxes = outputs["pred_boxes"][-1]               # (B, Nq, 2)
    B, Nq, K = logits.shape
    prob = torch.sigmoid(logits).reshape(B, Nq * K)
    scores, topk = torch.topk(prob, Nq, dim=1)
    query_idx = topk // K
    labels = topk % K

    xy = box_cl_to_xy(boxes)
    raw_boxes = xy * durations[:, None, None]
    idx = query_idx[..., None].expand(B, Nq, 2)
    sel = torch.gather(xy.clamp(0.0, 1.0), 1, idx) * durations[:, None, None]
    pred_count = outputs["pred_count"][-1].argmax(-1).clamp(min=1)
    return dict(scores=scores, labels=labels, boxes=sel,
                raw_boxes=torch.gather(raw_boxes, 1, idx),
                query_idx=query_idx, pred_count=pred_count)


def grounding_outputs(outputs: Dict, text_embed: torch.Tensor,
                      durations: torch.Tensor, gt_mask: torch.Tensor,
                      spec: GroundingSpec, layer: int = -1) -> Dict:
    """One event per GT sentence by the contrastive match matrix of decoder
    layer `layer` (postprocess.py:63-102). Cost = cost_cl x (-cosine) +
    cost_class x focal cost of class 0; a Hungarian solve over the valid
    sentences (the port's `batched_lap`, one copy to the host), or each
    column's argmin with maximum_matching; padded columns take their argmin.
    text_embed (B, G, Dcl) is the JAX package's outputs['_grounding_text'].
    Returns boxes (B, G, 2) in seconds, confs (B, G), cl_scores (B, G), the
    cost at the chosen event."""
    logits = outputs["pred_logits"][layer]
    boxes = outputs["pred_boxes"][layer]
    cl_mat = cl_match_matrix(outputs["event_embed"][layer], text_embed)
    p = torch.sigmoid(logits[..., 0])                       # class 0
    a, g = spec.alpha, spec.gamma
    pos = a * ((1 - p) ** g) * (-torch.log(p + 1e-8))
    neg = (1 - a) * (p ** g) * (-torch.log(1 - p + 1e-8))
    C = spec.cost_cl * (-cl_mat) + spec.cost_class * (pos - neg)[..., None]

    event_j = C.argmin(dim=1)                               # (B, G)
    if not spec.maximum_matching:
        # the JAX package solves all columns of the cost with the padded
        # ones at 0, which leaves the valid columns' optimum as it is; here
        # they stay out of the solve (batched_lap: -1)
        matched = batched_lap(C, gt_mask)
        event_j = torch.where(gt_mask, matched, event_j)

    xy = box_cl_to_xy(boxes).clamp(0.0, 1.0) * durations[:, None, None]
    sel = torch.gather(xy, 1, event_j[..., None].expand(-1, -1, 2))
    confs = torch.gather(p, 1, event_j)
    cl_scores = torch.gather(C.transpose(1, 2), 2, event_j[..., None])[..., 0]
    return dict(boxes=sel, confs=confs, cl_scores=cl_scores)
