"""Post-processing: top-k detection outputs. Port of
gvl_tpu/eval/postprocess.py:37-60 (grounding is not ported)."""

from __future__ import annotations

from typing import Dict

import torch

from gvl_tpu_torch.utils.boxes import box_cl_to_xy


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
