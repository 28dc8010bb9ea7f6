"""Dense-captioning evaluation: runs the eval step over a batch iterable and
writes the reference's DVC result JSON, then reranks it.

Port of the DVC half of gvl_tpu/eval/evaluate.py (`_eval_step` standard-head
branch, `run`, `_assemble`, `save_dvc_json`, `reranking`), serial: one batch
is computed, copied to the host and assembled before the next. Losses,
grounding, matching scores, the TAL outputs and the plot hooks are not
ported.

DVC JSON: {"results": {vid: [{timestamp, raw_box, label, proposal_score,
sentence, sentence_score, cl_score, query_id, vid_duration,
pred_event_count}]}, "version", "external_data"} (reference
eval_utils.py:227-240).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable

import numpy as np
import torch

from gvl_tpu_torch.eval.postprocess import detection_outputs
from gvl_tpu_torch.models.transformer import pyramid_shapes


def save_dvc_json(out_json: Dict, path: str, verbose: bool = False):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if verbose:
            out_json["valid_video_num"] = len(out_json["results"])
            out_json["avg_proposal_num"] = float(np.mean(
                [len(v) for v in out_json["results"].values()])) \
                if out_json["results"] else 0.0
        json.dump(out_json, f)


def reranking(p_src: str, alpha: float, cl_score_weight: float,
              temperature: float) -> str:
    """Re-rank predictions by the joint score and truncate to the predicted
    event count (reference: eval_utils.py:143-168)."""
    with open(p_src) as f:
        d = json.load(f)
    for k, v in list(d["results"].items()):
        sent_scores = [p["sentence_score"] /
                       (float(len(p["sentence"].split())) ** temperature + 1e-5)
                       for p in v]
        joint = (alpha * np.array(sent_scores)
                 + np.array([p["proposal_score"] for p in v])
                 + cl_score_weight * np.array([p["cl_score"] for p in v]))
        for i, p in enumerate(v):
            p["joint_score"] = float(joint[i])
        v = sorted(v, key=lambda x: x["joint_score"], reverse=True)
        top_n = int(v[0]["pred_event_count"]) if v else 0
        v = v[:top_n]
        v = sorted(v, key=lambda x: x["timestamp"])
        d["results"][k] = v
    save_path = p_src + f"_rerank_alpha{alpha}_temp{temperature}.json"
    save_dvc_json(d, save_path)
    return save_path


def _check_ported(cfg: Any) -> None:
    def get(name, default):
        return getattr(cfg, name, default)

    for flag in ("eval_decode_bf16", "eval_full_bf16"):
        if get(flag, False):
            raise NotImplementedError(f"{flag} is not ported yet")
    if int(get("eval_beam_size", 1)) > 1:
        raise NotImplementedError("eval_beam_size > 1 is not ported yet")
    if get("caption_decoder_type", "standard") == "gpt2":
        raise NotImplementedError("the gpt2 caption head is not ported yet")
    if get("enable_contrastive", False):
        raise NotImplementedError("contrastive eval is not ported yet; run "
                                  "with enable_contrastive=False")
    if get("transformer_input_type", "queries") != "queries":
        raise NotImplementedError("only query-mode eval is ported")


class EvalRunner:
    """DVC eval of a GVLModel.

    cfg: any object with the JAX Config's attribute names; translator:
    anything with `.rtranslate(ids) -> str`; batches (for `run`): numpy dicts
    with `keys`, `video_feats` (B, T, D), `video_mask` (B, T) and
    `duration` (B,), as gvl_tpu.data.dataset.Batcher yields them.
    """

    def __init__(self, cfg: Any, model, translator):
        _check_ported(cfg)
        self.cfg = cfg
        self.model = model
        self.translator = translator
        self.device = next(model.parameters()).device

    def _eval_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Trunk, detection outputs and greedy captions for one batch, on the
        model's device. Port of evaluate.py:101-241 (standard head)."""
        cfg = self.cfg
        dev = self.device
        feats = torch.from_numpy(np.asarray(batch["video_feats"])).to(dev)
        mask = torch.from_numpy(np.asarray(batch["video_mask"], bool)).to(dev)
        duration = torch.from_numpy(np.asarray(batch["duration"])).to(dev)
        shapes = pyramid_shapes(feats.shape[1], cfg.num_feature_levels)
        out = self.model(feats, mask, duration)
        result = {"det": detection_outputs(out, duration)}
        if cfg.caption_loss_coef > 0 and not cfg.eval_disable_captioning \
                and cfg.caption_decoder_type != "none":
            query = out["hs"][-1]
            if self.model.arch.enable_pos_emb_for_captioner:
                query = torch.cat([query, out["query_pos"]], -1)
            seq, lps = self.model.caption_sample(
                cfg.dec_layers - 1, query, out["layer_refs"][-1],
                out["memory"], out["mask_flat"], shapes, out["valid_ratios"])
            result["seq"] = seq                                # (B, Nq, Lc)
            result["cap_scores"] = ((seq > 0) * lps.float()).sum(-1)
        return result

    @staticmethod
    def _to_host(res: Dict[str, Any]) -> Dict[str, Any]:
        host = {k: v.cpu().numpy() for k, v in res.items() if k != "det"}
        host["det"] = {k: v.cpu().numpy() for k, v in res["det"].items()}
        return host

    def run(self, batches: Iterable[Dict], dvc_json_path: str):
        """Evaluate every batch, write the DVC JSON (and, when
        count_loss_coef > 0, the reranked one). Returns (path of the final
        JSON, the un-reranked result dict)."""
        cfg = self.cfg
        out_json = {"results": {}, "version": "VERSION 1.0",
                    "external_data": {"used:": True, "details": None}}
        with torch.inference_mode():
            for batch in batches:
                res = self._to_host(self._eval_step(batch))
                self._assemble(batch, res, out_json)
        save_dvc_json(out_json, dvc_json_path, verbose=True)
        if cfg.count_loss_coef > 0:
            dvc_json_path = reranking(
                dvc_json_path, alpha=cfg.ec_alpha,
                cl_score_weight=cfg.eval_matching_score_weight,
                temperature=2.0)
        return dvc_json_path, out_json

    def _assemble(self, batch, res, out_json):
        """Per-video prediction lists. Port of evaluate.py:541-594 (DVC),
        at the reference's score threshold 0."""
        det = res["det"]
        Nq = det["scores"].shape[1]
        have_caps = "seq" in res
        for b, vid in enumerate(batch["keys"]):
            duration = float(batch["duration"][b])
            raw_boxes = det["raw_boxes"][b]
            raw_mask = raw_boxes.sum(1) != 0
            items = []
            for pid in range(Nq):
                score = float(det["scores"][b, pid])
                if score <= 0.0 or not raw_mask[pid]:
                    continue
                q = int(det["query_idx"][b, pid])
                if have_caps:
                    sent = self.translator.rtranslate(res["seq"][b, q])
                    sent_score = float(res["cap_scores"][b, q])
                else:
                    sent, sent_score = "", -1e5
                items.append({
                    "timestamp": det["boxes"][b, pid].tolist(),
                    "raw_box": raw_boxes[pid].tolist(),
                    "label": int(det["labels"][b, pid]),
                    "proposal_score": score,
                    "sentence": sent,
                    "sentence_score": sent_score,
                    "cl_score": 0.0,
                    "query_id": q,
                    "vid_duration": duration,
                    "pred_event_count": int(det["pred_count"][b]),
                })
            out_json["results"][vid] = items
