"""Dense-captioning, grounding and TAL evaluation: runs the eval step over a
batch iterable, writes the reference's DVC result JSON, reranks it, and
writes the grounding JSONs and, for the TAL linear probe, the TAL JSON.

Port of gvl_tpu/eval/evaluate.py (`_eval_step`, `_grounding_chunk`,
`_matching_scores`, `run`, `_assemble`,
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
(evaluate.py:283-324). Decode options (evaluate.py:199-241): eval_beam_size
(beam search, the LSTM-DSA head), eval_decode_early_exit, eval_decode_bf16
(the caption head's weights, query and memory in bf16, the chosen-token
logprobs f32) and eval_full_bf16 (the trunk too: its weights and the
features in bf16, its outputs cast back to f32 for the losses, matcher and
postprocessing, the text pass over bf16-rounded weights, then the bf16
decode; evaluate.py:107-145).

The gpt2 head (evaluate.py:164-189) decodes greedily from the last layer's
query features with its stop token (early exit as for the other heads);
under eval_use_amp, eval_decode_bf16 or eval_full_bf16 every parameter of
the model reads as bf16 and the query features are cast, as the JAX branch
casts the whole tree. Each caption is its tokens up to the stop (the
decode's mask), made a sentence by `gpt_decode` when given (the train
loop's, which drops the special ids 0-2), else "w<id>" for every id
(evaluate.py:561-570); its score is the sum of its steps' token
probabilities. Zero-shot TAL (`enable_zeroshot_tal`, evaluate.py:270-282,
627-633): every prediction carries `tal_cl_scores` and `aux_tal_cl_scores`,
the cosines of its query's event embedding (last layer, the one before)
with each class name's embedding. Under only_ft_class_head, with the
batches' dataset holding a class map (`batches.ds.name_map`), `run` also
writes the TAL JSON `<dvc>.tal.json` and sets `last_tal_json`
(evaluate.py:491-504). The plot hook (evaluate.py:506-529), after the DVC
JSON is saved: the proposal-distribution figure unless
eval_disable_plot_hook, and with eval_save_qualitative_plots the
duration-bucketed splits and per-video timelines against
gt_file_for_eval[0] (eval/plots.py); best-effort as in the JAX package,
so where a plot fails (matplotlib absent) nothing is written and the eval
goes on.

DVC JSON: {"results": {vid: [{timestamp, raw_box, label, proposal_score,
sentence, sentence_score, cl_score, query_id, vid_duration,
pred_event_count}]}, "version", "external_data"} (reference
eval_utils.py:227-240). Grounding JSONs: {"results": {"<vid>-<i>":
[{timestamp, score, cl_score, sentence}]}} from the last decoder layer and,
in `_aux`, from the one before (eval_utils.py:322-330).

Data parallelism (gvl_tpu_torch.parallel; the JAX runner's mesh,
evaluate.py:354-382): every batch is padded to the eval batch size as in a
one-process run, then rank r takes its block of rows (`shard_batch`) and
evaluates them; each rank's eval losses are its shares of the global
batch's and are summed over ranks per batch. The per-video results reach
every rank in the global row order (`all_gather_object` once, at the end),
and rank 0 alone writes the JSONs. On a world split dp x sp
(gvl_tpu_torch/parallel/sp.py; the train loop's validation) the rows go by
the dp index (evaluate.py:81-86, mesh.shape['dp']): both ranks of an sp
group evaluate the same rows under the sp context, and the dp size must
divide the eval batch.
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

from gvl_tpu_torch import parallel as dp
from gvl_tpu_torch.eval.postprocess import (GroundingSpec, detection_outputs,
                                            grounding_outputs)
from gvl_tpu_torch.models.text_encoder import effective_max_gt_events
from gvl_tpu_torch.models.transformer import pyramid_shapes
from gvl_tpu_torch.train.criterion import LossSpec, compute_criterion
from gvl_tpu_torch.utils.amp import BF16, bf16_parameters, cast_floats, to_bf16


def save_dvc_json(out_json: Dict, path: str, verbose: bool = False):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if verbose:
            out_json["valid_video_num"] = len(out_json["results"])
            out_json["avg_proposal_num"] = float(np.mean(
                [len(v) for v in out_json["results"].values()])) \
                if out_json["results"] else 0.0
        json.dump(out_json, f)


def rerank_path(p_src: str, alpha: float, temperature: float) -> str:
    """The path `reranking` writes."""
    return p_src + f"_rerank_alpha{alpha}_temp{temperature}.json"


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
    save_path = rerank_path(p_src, alpha, temperature)
    save_dvc_json(d, save_path)
    return save_path


def tal_submission(out_json: Dict, name_map) -> Dict:
    """The TAL JSON of a DVC result dict (evaluate.py:491-504, reference
    eval_utils.collect_tal_result): each prediction's class index named by
    `name_map`, its timestamp as `segment` and its proposal score; video
    ids without their `v_` prefix."""
    return {"results": {
        vid[2:]: [{"label": name_map.convert_idx2name(p["label"]),
                   "segment": p["timestamp"], "score": p["proposal_score"]}
                  for p in items]
        for vid, items in out_json["results"].items()},
        "version": "VERSION 1.3", "external_data": {}}


def plot_hook(cfg: Any, dvc_json_path: str) -> None:
    """The JAX EvalRunner's plot hook (evaluate.py:506-529): the
    proposal-distribution figure beside the DVC JSON unless
    eval_disable_plot_hook; with eval_save_qualitative_plots and a
    gt_file_for_eval, the duration-bucketed splits and the per-video
    timelines. Best-effort, like the reference (eval_utils.py:258-261): a
    plot that fails, as where matplotlib is absent, writes nothing."""
    if not getattr(cfg, "eval_disable_plot_hook", False):
        try:
            from gvl_tpu_torch.eval.plots import plot_proposal_distribution
            plot_proposal_distribution(dvc_json_path)
        except Exception:
            pass
    gt = getattr(cfg, "gt_file_for_eval", None)
    if getattr(cfg, "eval_save_qualitative_plots", False) and gt:
        try:
            from gvl_tpu_torch.eval.plots import (split_results_by_duration,
                                                  visualize_video_results)
            split_results_by_duration(dvc_json_path, gt[0])
            visualize_video_results({"model": dvc_json_path}, gt[0],
                                    out_dir=dvc_json_path + "_timelines")
        except Exception:
            pass


class EvalRunner:
    """DVC and grounding eval of a GVLModel.

    cfg: any object with the JAX Config's attribute names; translator:
    anything with `.rtranslate(ids) -> str`; text_encoder: the
    `TextEncoder` (required with enable_contrastive); gpt_decode: token ids
    -> sentence for the gpt2 head. Batches (for `run`):
    numpy dicts with `keys`, `video_feats` (B, T, D), `video_mask` (B, T)
    and `duration` (B,), as gvl_tpu.data.dataset.Batcher yields them; with
    `gt_boxes`, `gt_labels` and `gt_mask` (B, G) the eval losses are
    computed, and with the contrastive side on `gt_mask` and `captions_raw`
    (every GT sentence of each video) are required.
    """

    def __init__(self, cfg: Any, model, translator, text_encoder=None,
                 gpt_decode=None):
        if getattr(cfg, "enable_contrastive", False) and text_encoder is None:
            raise ValueError("EvalRunner: enable_contrastive needs the text "
                             "encoder (models.text_encoder.load_text_encoder)")
        self.cfg = cfg
        self.model = model
        self.translator = translator
        self.text_encoder = text_encoder
        self.gpt_decode = gpt_decode
        self.gpt = getattr(cfg, "caption_decoder_type", "standard") == "gpt2"
        self.class_embeds = None          # (n_class, Dcl), zero-shot TAL
        self.last_tal_json = None
        self.device = next(model.parameters()).device
        self.spec = LossSpec.from_config(cfg)
        self.gspec = GroundingSpec.from_config(cfg)
        self.contrastive = bool(getattr(cfg, "enable_contrastive", False))
        self.grounding = self.contrastive and bool(
            getattr(cfg, "eval_enable_grounding", True))
        self.matching = self.contrastive and bool(
            getattr(cfg, "eval_enable_matching_score", False))
        self.full_bf16 = bool(getattr(cfg, "eval_full_bf16", False))
        self.decode_bf16 = self.full_bf16 or bool(
            getattr(cfg, "eval_decode_bf16", False))
        self.beam_size = int(getattr(cfg, "eval_beam_size", 1))
        self.early_exit = bool(getattr(cfg, "eval_decode_early_exit", False))
        self.amp = bool(getattr(cfg, "eval_use_amp", False))
        self.text_bf16 = self.contrastive and (self.full_bf16 or self.amp)
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

    def enable_zeroshot_tal(self, class_names: List[str],
                            max_len: int = 8) -> None:
        """Embed the action classes' names, so that every prediction
        carries tal_cl_scores (evaluate.py:627-633)."""
        from gvl_tpu_torch.eval.zeroshot_tal import embed_class_names
        if self.text_encoder is None:
            raise ValueError("enable_zeroshot_tal needs the text encoder "
                             "(enable_contrastive)")
        self.class_embeds = embed_class_names(self.model, self.text_encoder,
                                              class_names, max_len)

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
        """Trunk, text pass, captions, eval losses, detection and grounding
        outputs for one (padded, tokenized) batch, on the model's device,
        under the decode options. Port of evaluate.py:101-281. Returns
        (result, the trunk tensors the sentences past G are grounded
        against and the matching-score pass reads). The decode is enqueued
        before the losses, whose matcher waits for the device."""
        cfg = self.cfg
        feats = self._tensor(arrs["video_feats"])
        mask = self._tensor(arrs["video_mask"], torch.bool)
        duration = self._tensor(arrs["duration"])
        shapes = pyramid_shapes(feats.shape[1], cfg.num_feature_levels)
        gt_mask = None
        if "gt_mask" in arrs:
            gt_mask = self._tensor(arrs["gt_mask"], torch.bool)
        proposals = {}
        if self.model.arch.two_stage:
            # the GT segments are the queries (evaluate.py:106-128); bf16
            # under eval_full_bf16, as the trunk
            boxes = self._tensor(arrs["gt_boxes"])
            proposals = dict(proposals=boxes.to(BF16) if self.full_bf16
                             else boxes, proposals_mask=gt_mask)
        if self.full_bf16:
            with bf16_parameters(self.model, promote=True):
                out = self.model(feats.to(BF16), mask, duration, **proposals)
            out = cast_floats(out, BF16, torch.float32)
        else:
            out = self.model(feats, mask, duration, **proposals)
        result: Dict[str, Any] = {}
        text_out = None
        if self.contrastive:
            text_out = self._text(self._tensor(arrs["text_ids"]),
                                  self._tensor(arrs["text_mask"]), gt_mask,
                                  out["memory"], out["mask_flat"],
                                  bf16_weights=self.text_bf16)
        captions = cfg.caption_loss_coef > 0 and \
            not cfg.eval_disable_captioning
        if captions and self.gpt:
            hs, bf16 = out["hs"][-1], contextlib.nullcontext()
            if self.amp or self.decode_bf16:
                bf16 = bf16_parameters(self.model)
                hs = to_bf16(hs)
            with bf16:
                toks, probs, genmask = self.model.caption_sample_gpt(
                    cfg.dec_layers - 1, hs, entry_length=cfg.max_caption_len,
                    early_exit=self.early_exit)
            # the ids past each caption's stop are the fixed loop's argmaxes
            # (or the early exit's zeros); the assembly cuts at the mask
            result["gpt_tokens"] = toks
            result["gpt_genmask"] = genmask
            result["cap_scores"] = (probs.float() * genmask).sum(-1)
        elif captions and cfg.caption_decoder_type != "none":
            query = out["hs"][-1]
            if self.model.arch.enable_pos_emb_for_captioner:
                query = torch.cat([query, out["query_pos"]], -1)
            memory = out["memory"]
            bf16 = contextlib.nullcontext()
            if self.decode_bf16:
                bf16 = self.model.caption_bf16()
                query, memory = to_bf16(query), to_bf16(memory)
            with bf16:
                seq, lps = self.model.caption_sample(
                    cfg.dec_layers - 1, query, out["layer_refs"][-1], memory,
                    out["mask_flat"], shapes, out["valid_ratios"],
                    beam_size=self.beam_size, early_exit=self.early_exit)
            result["seq"] = seq                                # (B, Nq, Lc)
            result["cap_scores"] = ((seq > 0) * lps.float()).sum(-1)
        result["det"] = detection_outputs(out, duration)
        if self.class_embeds is not None:
            result.update(self._tal_cl_scores(out, result["det"]))
        if "gt_boxes" in arrs:
            texts = None
            if self.contrastive:
                texts = ([text_out["aux"]] * (cfg.dec_layers - 1)
                         + [text_out["final"]])
            row_valid = arrs.get("row_valid")
            shares, _ = compute_criterion(
                out, self._tensor(arrs["gt_boxes"]),
                self._tensor(arrs["gt_labels"]), gt_mask, texts, self.spec,
                row_mask=None if row_valid is None
                else self._tensor(row_valid, torch.bool))
            result["losses"] = dp.sum_shares(shares)
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

    def _tal_cl_scores(self, out, det) -> Dict[str, torch.Tensor]:
        """Each ranked prediction's cosine with every class embedding, from
        the event embedding of the last decoder layer (tal_cl_scores) and
        of the one before (aux_tal_cl_scores), (B, ranks, n_class)
        (evaluate.py:270-282)."""
        def unit(x):
            return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                        + 1e-12)
        c = unit(self.class_embeds)
        res = {}
        for which, layer in (("tal_cl_scores", -1), ("aux_tal_cl_scores", -2)):
            scores = torch.einsum("bqd,kd->bqk", unit(out["event_embed"][layer]),
                                  c)
            res[which] = torch.gather(
                scores, 1, det["query_idx"][..., None].expand(
                    -1, -1, scores.shape[-1]))
        return res

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
        with `row_valid` marking the real rows (evaluate.py:361-389), take
        this rank's block of rows and tokenize their sentences. Returns (the
        batch, its keys cut to the real rows; the global batch's number of
        real rows; the numpy arrays of the step)."""
        real_b = len(batch["keys"])
        if eval_bs and real_b < eval_bs:
            reps = [min(i, real_b - 1) for i in range(eval_bs)]
            batch = {k: (v[reps] if isinstance(v, np.ndarray)
                         else [v[i] for i in reps])
                     for k, v in batch.items()}
            batch["keys"] = batch["keys"][:real_b]
        n = max(eval_bs, real_b)
        batch = dp.shard_batch(dict(batch, row_valid=np.arange(n) < real_b),
                               n_rows=n)
        arrs = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        if self.contrastive:
            ids, tmask = self.text_encoder.tokenize(
                batch["captions_raw"], self.G, self.max_text_len)
            arrs["text_ids"], arrs["text_mask"] = ids, tmask
        return batch, real_b, arrs

    def run(self, batches: Iterable[Dict], dvc_json_path: str, logger=None,
            debug: bool = False):
        """Evaluate every batch; write the DVC JSON, the reranked one (when
        count_loss_coef > 0), the two grounding JSONs beside the final one
        and, under only_ft_class_head with a class map, the TAL JSON
        (`last_tal_json`). A partial last batch is padded to the iterable's
        `batch_size`, where it has one. With `debug` the run stops after the
        batch that takes the DVC JSON past 5 videos (evaluate.py:480-482);
        the eval losses go to `logger.info` when a logger is given. Returns
        (path of the final DVC JSON, the un-reranked result dict, the
        grounding and aux grounding dicts, the eval losses averaged over the
        real videos, rounded to 3 places), as the JAX package's run
        (evaluate.py:539). Under data parallelism every rank returns the
        same, and the iterable's batch_size must divide over the ranks."""
        cfg = self.cfg
        out_json = {"results": {}, "version": "VERSION 1.0",
                    "external_data": {"used:": True, "details": None}}
        out_json_g: Dict = {"results": {}}
        aux_out_json_g: Dict = {"results": {}}
        loss_sum: "OrderedDict[str, float]" = OrderedDict()
        n_rows = 0
        eval_bs = int(getattr(batches, "batch_size", 0) or 0)
        if dp.size() > 1:
            dp.check_divides(eval_bs, dp.world().dp_size)
        parts = []          # this rank's results of each batch
        videos = set()
        with torch.inference_mode():
            for batch in batches:
                videos.update(batch["keys"])
                batch, real_b, arrs = self._prepare(batch, eval_bs)
                res_dev, aux = self._eval_step(arrs)
                res = self._to_host(res_dev)
                n_rows += real_b
                for k, v in res.get("losses", {}).items():
                    loss_sum[k] = loss_sum.get(k, 0.0) + float(v) * real_b
                if self.matching and "seq" in res:
                    res["det"]["cl_scores"] = self._match_pass(res, aux)
                part = tuple({"results": {}} for _ in range(3))
                self._assemble(batch, res, part[0])
                if "grounding" in res:
                    self._assemble_grounding(batch, res["grounding"],
                                             res["grounding_aux"], 0,
                                             part[1], part[2])
                    self._ground_past_g(batch, aux, part[1], part[2])
                parts.append(part)
                if debug and len(videos) > 5:
                    break
        # every row block's results of each batch, in the global row order
        for batch_parts in zip(*dp.all_gather_object(parts, dp_only=True)):
            for dst, part in zip((out_json, out_json_g, aux_out_json_g),
                                 zip(*batch_parts)):
                for src in part:
                    dst["results"].update(src["results"])
        for k in loss_sum:
            loss_sum[k] = round(loss_sum[k] / (n_rows + 1e-5), 3)
        if logger is not None:
            logger.info("eval loss: {}".format(dict(loss_sum)))
        name_map = getattr(getattr(batches, "ds", None), "name_map", None)
        writer = dp.is_writer()
        if getattr(cfg, "only_ft_class_head", False) and name_map is not None:
            self.last_tal_json = dvc_json_path[:-5] + ".tal.json"
            if writer:
                save_dvc_json(tal_submission(out_json, name_map),
                              self.last_tal_json)
        if writer:
            save_dvc_json(out_json, dvc_json_path, verbose=True)
            plot_hook(cfg, dvc_json_path)
        if cfg.count_loss_coef > 0:
            dvc_json_path = reranking(
                dvc_json_path, alpha=cfg.ec_alpha,
                cl_score_weight=cfg.eval_matching_score_weight,
                temperature=2.0) if writer else rerank_path(
                    dvc_json_path, cfg.ec_alpha, 2.0)
        if writer:
            save_dvc_json(out_json_g, dvc_json_path + ".grounding.json")
            save_dvc_json(aux_out_json_g,
                          dvc_json_path + "_aux.grounding.json")
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
        have_gpt = "gpt_tokens" in res
        tal = "tal_cl_scores" in res
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
                elif have_gpt:
                    n = int(res["gpt_genmask"][b, q].sum())
                    ids = res["gpt_tokens"][b, q][:n]
                    if self.gpt_decode is not None:
                        sent = self.gpt_decode(ids)
                    else:
                        # the ids before the stop: id 0 is a word here
                        sent = " ".join(f"w{int(i)}" for i in ids)
                    sent_score = float(res["cap_scores"][b, q])
                else:
                    sent, sent_score = "", -1e5
                extra = {}
                if tal:
                    extra = {k: res[k][b, pid].tolist() for k in
                             ("tal_cl_scores", "aux_tal_cl_scores")}
                items.append({
                    **extra,
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
