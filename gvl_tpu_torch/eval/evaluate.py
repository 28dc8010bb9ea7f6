"""Dense-captioning and grounding evaluation: runs the eval step over a batch
iterable, writes the reference's DVC result JSON, reranks it, and writes the
grounding JSONs.

Port of gvl_tpu/eval/evaluate.py (`_eval_step` for the standard caption
head, `_grounding_chunk`, `_matching_scores`, `run`, `_assemble`,
`_assemble_grounding`, `save_dvc_json`, `reranking`), serial: one batch is
computed, copied to the host and assembled before the next. With the
contrastive side on, the text encoder and `encode_text` run on the batch's
sentences (over bf16-rounded weights under eval_use_amp), the eval losses
take the text embeddings, and with eval_enable_grounding every GT sentence
gets one event, also the sentences past the G slots (in G-sized chunks
against the batch's saved trunk outputs). With eval_enable_matching_score
each ranked prediction's generated caption is encoded again and its cosine
with its query's event embedding is its `cl_score`, which the reranking
weighs by eval_matching_score_weight. As in the JAX package, the chunks past
G and the matching-score pass use the f32 weights even under eval_use_amp
(evaluate.py:283-324). Not ported: the bf16 decode options, beam search,
zero-shot TAL, the TAL JSON and the plot hooks.

DVC JSON: {"results": {vid: [{timestamp, raw_box, label, proposal_score,
sentence, sentence_score, cl_score, query_id, vid_duration,
pred_event_count}]}, "version", "external_data"} (reference
eval_utils.py:227-240). Grounding JSONs: {"results": {"<vid>-<i>":
[{timestamp, score, cl_score, sentence}]}} from the last decoder layer and,
in `_aux`, from the one before (eval_utils.py:322-330).
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

from gvl_tpu_torch.eval.postprocess import (GroundingSpec, detection_outputs,
                                            grounding_outputs)
from gvl_tpu_torch.models.text_encoder import effective_max_gt_events
from gvl_tpu_torch.models.transformer import pyramid_shapes
from gvl_tpu_torch.train.criterion import LossSpec, compute_criterion


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
    """Raise NotImplementedError naming the first eval option of `cfg`
    that the port does not run yet."""
    def get(name, default):
        return getattr(cfg, name, default)

    for flag in ("eval_decode_bf16", "eval_full_bf16"):
        if get(flag, False):
            raise NotImplementedError(f"{flag} is not ported yet")
    if int(get("eval_beam_size", 1)) > 1:
        raise NotImplementedError("eval_beam_size > 1 is not ported yet")
    if get("caption_decoder_type", "standard") == "gpt2":
        raise NotImplementedError("the gpt2 caption head is not ported yet")
    if get("transformer_input_type", "queries") != "queries":
        raise NotImplementedError("only query-mode eval is ported")


class EvalRunner:
    """DVC and grounding eval of a GVLModel.

    cfg: any object with the JAX Config's attribute names; translator:
    anything with `.rtranslate(ids) -> str`; text_encoder: the
    `TextEncoder` (required with enable_contrastive). Batches (for `run`):
    numpy dicts with `keys`, `video_feats` (B, T, D), `video_mask` (B, T)
    and `duration` (B,), as gvl_tpu.data.dataset.Batcher yields them; with
    `gt_boxes`, `gt_labels` and `gt_mask` (B, G) the eval losses are
    computed, and with the contrastive side on `gt_mask` and `captions_raw`
    (every GT sentence of each video) are required.
    """

    def __init__(self, cfg: Any, model, translator, text_encoder=None):
        _check_ported(cfg)
        if getattr(cfg, "enable_contrastive", False) and text_encoder is None:
            raise ValueError("EvalRunner: enable_contrastive needs the text "
                             "encoder (models.text_encoder.load_text_encoder)")
        self.cfg = cfg
        self.model = model
        self.translator = translator
        self.text_encoder = text_encoder
        self.device = next(model.parameters()).device
        self.spec = LossSpec.from_config(cfg)
        self.gspec = GroundingSpec.from_config(cfg)
        self.contrastive = bool(getattr(cfg, "enable_contrastive", False))
        self.grounding = self.contrastive and bool(
            getattr(cfg, "eval_enable_grounding", True))
        self.matching = self.contrastive and bool(
            getattr(cfg, "eval_enable_matching_score", False))
        self.text_bf16 = self.contrastive and bool(
            getattr(cfg, "eval_use_amp", False))
        self.G = effective_max_gt_events(cfg)
        self.max_text_len = int(getattr(cfg, "max_text_input_len", 32))

    @staticmethod
    def _to_host(res):
        """Nested dicts and tuples of device tensors -> numpy."""
        if isinstance(res, dict):
            return {k: EvalRunner._to_host(v) for k, v in res.items()}
        if isinstance(res, tuple):
            return tuple(EvalRunner._to_host(v) for v in res)
        return res.cpu().numpy()

    def enable_zeroshot_tal(self, *args, **kwargs):
        raise NotImplementedError("zero-shot TAL (enable_zeroshot_tal) is not "
                                  "ported yet")

    # ------------------------------------------------------------ device side
    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    def _text(self, ids, tmask, smask, memory, mask_flat,
              bf16_weights=False):
        """The text encoder over (B, G, Ltok) tokens, then encode_text."""
        B, G, Ltok = ids.shape
        word = self.text_encoder(ids.reshape(B * G, Ltok).long(),
                                 tmask.reshape(B * G, Ltok),
                                 bf16_weights=bf16_weights)
        return self.model.encode_text(
            word.float().reshape(B, G, Ltok, -1), tmask.bool(), smask,
            memory, mask_flat)

    def _eval_step(self, arrs: Dict[str, np.ndarray]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        """Trunk, text pass, greedy captions, eval losses, detection and
        grounding outputs for one (padded, tokenized) batch, on the model's
        device. Port of evaluate.py:101-281 (standard head). Returns
        (result, the trunk tensors the sentences past G are grounded
        against and the matching-score pass reads). The decode is enqueued
        before the losses, whose matcher waits for the device."""
        cfg = self.cfg
        feats = self._tensor(arrs["video_feats"])
        mask = self._tensor(arrs["video_mask"], torch.bool)
        duration = self._tensor(arrs["duration"])
        shapes = pyramid_shapes(feats.shape[1], cfg.num_feature_levels)
        out = self.model(feats, mask, duration)
        result: Dict[str, Any] = {}
        text_out = gt_mask = None
        if "gt_mask" in arrs:
            gt_mask = self._tensor(arrs["gt_mask"], torch.bool)
        if self.contrastive:
            text_out = self._text(self._tensor(arrs["text_ids"]),
                                  self._tensor(arrs["text_mask"]), gt_mask,
                                  out["memory"], out["mask_flat"],
                                  bf16_weights=self.text_bf16)
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
        result["det"] = detection_outputs(out, duration)
        if "gt_boxes" in arrs:
            texts = None
            if self.contrastive:
                texts = ([text_out["aux"]] * (cfg.dec_layers - 1)
                         + [text_out["final"]])
            row_valid = arrs.get("row_valid")
            result["losses"], _ = compute_criterion(
                out, self._tensor(arrs["gt_boxes"]),
                self._tensor(arrs["gt_labels"]), gt_mask, texts, self.spec,
                row_mask=None if row_valid is None
                else self._tensor(row_valid, torch.bool))
        aux = {}
        if self.grounding:
            # the final layer matches the final text embedding, the one
            # before it the aux one (evaluate.py:243-252)
            result["grounding"] = grounding_outputs(
                out, text_out["final"], duration, gt_mask, self.gspec, -1)
            result["grounding_aux"] = grounding_outputs(
                out, text_out["aux"], duration, gt_mask, self.gspec, -2)
        if self.grounding or self.matching:
            aux = {k: out[k] for k in ("pred_logits", "pred_boxes",
                                       "event_embed", "memory", "mask_flat")}
            aux["duration"] = duration
        return result, aux

    def _grounding_chunk(self, aux, ids, tmask, smask):
        """Grounding of one G-sized slice of sentences against the saved
        trunk outputs (evaluate.py:283-303)."""
        text_out = self._text(self._tensor(ids), self._tensor(tmask),
                              self._tensor(smask, torch.bool), aux["memory"],
                              aux["mask_flat"])
        smask_t = self._tensor(smask, torch.bool)
        return (grounding_outputs(aux, text_out["final"], aux["duration"],
                                  smask_t, self.gspec, -1),
                grounding_outputs(aux, text_out["aux"], aux["duration"],
                                  smask_t, self.gspec, -2))

    def _matching_scores(self, aux, ids, tmask, query_idx):
        """cl_score[b, r] = cos(text of the caption ranked r, last-layer
        event embedding of its query), ids (B, R, Ltok) the tokens of the
        ranked captions, query_idx (B, R) their queries (evaluate.py:
        305-324, reference PostProcess.forward): the text pass over f32
        weights, encode_text with every sentence slot valid."""
        ids, tmask = self._tensor(ids), self._tensor(tmask)
        B, R, _ = ids.shape
        text_out = self._text(ids, tmask,
                              torch.ones(B, R, dtype=torch.bool,
                                         device=self.device),
                              aux["memory"], aux["mask_flat"])
        t = text_out["final"]
        e = aux["event_embed"][-1]
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
        e = e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-12)
        e = torch.gather(e, 1, self._tensor(query_idx).long()[..., None]
                         .expand(-1, -1, e.shape[-1]))
        return (t * e).sum(-1)

    # -------------------------------------------------------------- host side
    def _prepare(self, batch: Dict, eval_bs: int = 0
                 ) -> Tuple[Dict, int, Dict[str, np.ndarray]]:
        """Pad a partial last batch to eval_bs by repeating its last row,
        with `row_valid` marking the real rows, and tokenize its sentences
        (evaluate.py:361-389). Returns (the batch, its keys cut to the real
        rows; the number of real rows; the numpy arrays of the step)."""
        real_b = len(batch["keys"])
        if eval_bs and real_b < eval_bs:
            reps = [min(i, real_b - 1) for i in range(eval_bs)]
            batch = {k: (v[reps] if isinstance(v, np.ndarray)
                         else [v[i] for i in reps])
                     for k, v in batch.items()}
            batch["keys"] = batch["keys"][:real_b]
        arrs = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        arrs["row_valid"] = np.arange(max(eval_bs, real_b)) < real_b
        if self.contrastive:
            ids, tmask = self.text_encoder.tokenize(
                batch["captions_raw"], self.G, self.max_text_len)
            arrs["text_ids"], arrs["text_mask"] = ids, tmask
        return batch, real_b, arrs

    def run(self, batches: Iterable[Dict], dvc_json_path: str, logger=None,
            debug: bool = False):
        """Evaluate every batch; write the DVC JSON, the reranked one (when
        count_loss_coef > 0) and the two grounding JSONs beside the final
        one. A partial last batch is padded to the iterable's `batch_size`,
        where it has one. With `debug` the run stops after the batch that
        takes the DVC JSON past 5 videos (evaluate.py:480-482); the eval
        losses go to `logger.info` when a logger is given. Returns (path of
        the final DVC JSON, the un-reranked result dict, the grounding and
        aux grounding dicts, the eval losses averaged over the real videos,
        rounded to 3 places), as the JAX package's run (evaluate.py:539)."""
        cfg = self.cfg
        out_json = {"results": {}, "version": "VERSION 1.0",
                    "external_data": {"used:": True, "details": None}}
        out_json_g: Dict = {"results": {}}
        aux_out_json_g: Dict = {"results": {}}
        loss_sum: "OrderedDict[str, float]" = OrderedDict()
        n_rows = 0
        eval_bs = int(getattr(batches, "batch_size", 0) or 0)
        with torch.inference_mode():
            for batch in batches:
                batch, real_b, arrs = self._prepare(batch, eval_bs)
                res_dev, aux = self._eval_step(arrs)
                res = self._to_host(res_dev)
                n_rows += real_b
                for k, v in res.get("losses", {}).items():
                    loss_sum[k] = loss_sum.get(k, 0.0) + float(v) * real_b
                if self.matching and "seq" in res:
                    res["det"]["cl_scores"] = self._match_pass(res, aux)
                self._assemble(batch, res, out_json)
                if "grounding" in res:
                    self._assemble_grounding(batch, res["grounding"],
                                             res["grounding_aux"], 0,
                                             out_json_g, aux_out_json_g)
                    self._ground_past_g(batch, aux, out_json_g,
                                        aux_out_json_g)
                if debug and len(out_json["results"]) > 5:
                    break
        for k in loss_sum:
            loss_sum[k] = round(loss_sum[k] / (n_rows + 1e-5), 3)
        if logger is not None:
            logger.info("eval loss: {}".format(dict(loss_sum)))
        save_dvc_json(out_json, dvc_json_path, verbose=True)
        if cfg.count_loss_coef > 0:
            dvc_json_path = reranking(
                dvc_json_path, alpha=cfg.ec_alpha,
                cl_score_weight=cfg.eval_matching_score_weight,
                temperature=2.0)
        save_dvc_json(out_json_g, dvc_json_path + ".grounding.json")
        save_dvc_json(aux_out_json_g, dvc_json_path + "_aux.grounding.json")
        return dvc_json_path, out_json, out_json_g, aux_out_json_g, loss_sum

    def _match_pass(self, res, aux) -> np.ndarray:
        """The matching-score pass of one batch (evaluate.py:415-427): the
        generated captions in rank order, tokenized with G = the ranks,
        scored on the device. Returns the (B, ranks) cl_scores."""
        qidx = res["det"]["query_idx"]
        ranked = [[self.translator.rtranslate(res["seq"][b, q])
                   for q in qidx[b]] for b in range(len(qidx))]
        ids, tmask = self.text_encoder.tokenize(ranked, qidx.shape[1],
                                                self.max_text_len)
        return self._to_host(self._matching_scores(aux, ids, tmask, qidx))

    def _ground_past_g(self, batch, aux, out_json_g, aux_out_json_g):
        """Grounding of each video's sentences past the G slots, G at a time
        (evaluate.py:434-458)."""
        G = self.G
        raws: List[List[str]] = batch["captions_raw"]
        max_sent = max((len(c) for c in raws), default=0)
        for start in range(G, max_sent, G):
            chunk = [c[start:start + G] for c in raws]
            smask = np.zeros((len(chunk), G), bool)
            for b, c in enumerate(chunk):
                smask[b, :len(c)] = True
            ids, tmask = self.text_encoder.tokenize(chunk, G,
                                                    self.max_text_len)
            g, ga = self._to_host(self._grounding_chunk(aux, ids, tmask,
                                                          smask))
            self._assemble_grounding(batch, g, ga, start, out_json_g,
                                     aux_out_json_g)

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
                    "cl_score": float(det["cl_scores"][b, pid])
                    if "cl_scores" in det else 0.0,
                    "query_id": q,
                    "vid_duration": duration,
                    "pred_event_count": int(det["pred_count"][b]),
                })
            out_json["results"][vid] = items

    def _assemble_grounding(self, batch, g, ga, offset, out_json_g,
                            aux_out_json_g):
        """Grounding keys '<vid>-<i>' for the sentences [offset, offset + G)
        (evaluate.py:601-616)."""
        G = self.G
        for b, vid in enumerate(batch["keys"]):
            n_sent = len(batch["captions_raw"][b])
            v_name = vid[2:] if len(vid) > 11 else vid
            for which, dst in ((g, out_json_g), (ga, aux_out_json_g)):
                for pid in range(min(n_sent - offset, G)):
                    dst["results"][f"{v_name}-{offset + pid}"] = [{
                        "timestamp": which["boxes"][b, pid].tolist(),
                        "score": float(which["confs"][b, pid]),
                        "cl_score": float(which["cl_scores"][b, pid]),
                        "sentence": batch["captions_raw"][b][offset + pid],
                    }]
