"""Zero-shot temporal action localization (TAL) from the DVC outputs.

Port of gvl_tpu/eval/zeroshot_tal.py (reference
misc/evaluate_zeroshot_tal.py). `embed_class_names` encodes the action
classes' names with the text side of the model (:54-67); EvalRunner's
`enable_zeroshot_tal` keeps them, and every prediction of the DVC JSON then
carries its cosine with each class, `tal_cl_scores` from the last decoder
layer's event embedding and `aux_tal_cl_scores` from the one before.
`convert_dvc_to_zeroshot_tal` (:18-51) turns that JSON into a TAL
submission: score = proposal_score + alpha * cl_score, the best class wins,
video ids lose their `v_` prefix, and the background class (an extra last
score) is dropped unless asked for.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch


def convert_dvc_to_zeroshot_tal(dvc_json: str, class_names: List[str],
                                out_json: Optional[str] = None,
                                alpha: float = 1.0,
                                enable_bg_class: bool = False) -> str:
    """Write the TAL submission of `dvc_json` (its path + '.tal_proc.json'
    unless `out_json`) and return its path. A prediction's class scores are
    its aux_tal_cl_scores when present, else its tal_cl_scores; one without
    either is skipped."""
    out_json = out_json or dvc_json + ".tal_proc.json"
    out = {"version": "VERSION 1.3", "results": {},
           "external_data": {"used": True, "details": "zero-shot GVL-TPU"}}
    with open(dvc_json) as f:
        d = json.load(f)["results"]
    n_class = len(class_names)
    for k, v in d.items():
        items = []
        for p in v:
            cl_scores = p.get("aux_tal_cl_scores", p.get("tal_cl_scores"))
            if cl_scores is None:
                continue
            if len(cl_scores) not in (n_class, n_class + 1):
                raise ValueError(f"{k}: {len(cl_scores)} class scores for "
                                 f"{n_class} classes")
            scores = [p["proposal_score"] + alpha * c for c in cl_scores]
            if not enable_bg_class:
                scores = scores[:n_class]
            max_id = int(np.argmax(scores))
            if max_id >= n_class:
                continue
            items.append({"label": class_names[max_id],
                          "score": scores[max_id],
                          "prop_score": p["proposal_score"],
                          "cl_score": cl_scores[max_id],
                          "segment": p["timestamp"]})
        out["results"][k[2:]] = items
    with open(out_json, "w") as f:
        json.dump(out, f)
    return out_json


def embed_class_names(model, text_encoder, class_names: List[str],
                      max_len: int = 8) -> torch.Tensor:
    """The class names' contrastive embeddings (n_class, Dcl): the names
    tokenized as one video's sentences (G = n_class, max_len tokens), the
    text encoder over its f32 weights, then model.encode_text with every
    sentence slot valid and no memory (the sentence block without
    cross-modal fusion), its 'final' output."""
    dev = next(model.parameters()).device
    ids, mask = text_encoder.tokenize([class_names], len(class_names),
                                      max_len)
    ids = torch.as_tensor(ids).to(dev)
    mask = torch.as_tensor(mask).to(dev)
    B, G, L = ids.shape
    with torch.no_grad():
        word = text_encoder(ids.reshape(B * G, L).long(),
                            mask.reshape(B * G, L))
        text = model.encode_text(word.float().reshape(B, G, L, -1),
                                 mask.bool(),
                                 torch.ones(B, G, dtype=torch.bool,
                                            device=dev))
    return text["final"][0]
