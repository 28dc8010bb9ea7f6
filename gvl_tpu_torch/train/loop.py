"""Training orchestration: epochs, schedules, checkpoints, validation and
best-model bookkeeping. Port of gvl_tpu/train/loop.py (reference
train.py:151-595):
- run dir, source backup, logger and metrics stream (utils/logging.py);
- resume (`start_from`): the saved opts of info.json win over the given
  ones, except the resume controls, epoch, id and save_dir; model-last (or
  `start_from_mode`) is restored with its optimizers, schedules and step,
  and the run continues from the epoch it was saved at, as the JAX loop
  does (it runs that epoch again);
- `pretrain` / `pretrain_path` (load_pretrained) before the train state;
- the contrastive weight's schedule per epoch (train.py:304-310, 363-367);
- the scheduled-sampling probability per epoch (train.py:355-358);
- two-stage queries (transformer_input_type 'gt_proposals'): every
  loss_ce / loss_bbox / loss_giou weight is 0 and the caption cost is off
  (loop.py:194-205, 255-260; reference misc/utils.decide_two_stage);
- per-epoch model-last, optional per-update snapshots, validation every
  save_checkpoint_every epochs from min_epoch_when_save, per-task best
  checkpoints (grounding = sum R@1@IoU{.1,.3,.5,.7}; dvc = METEOR + soda_c;
  pc = para_METEOR + para_CIDEr + para_Bleu_4) and model-best by
  criteria_for_best_ckpt (train.py:475-559); under only_ft_class_head (the
  TAL linear probe) validation also scores the TAL JSON against
  tal_gt_file when that file exists (loop.py:404-407);
- the gpt2 caption head (`make_gpt_tokenize`, loop.py:90-128): its spec,
  each batch's captions tokenized into gpt_tokens / gpt_mask (hashed
  offline, gpt_model's byte-level BPE otherwise) and the validation
  captions decoded (`w<id>` words offline);
- info.json with the opts, the loss and score histories and the bests
  (train.py:561-578); `debug` stops each epoch after 5 steps.

A run lives on one device, `cfg.device` ("cuda": the current card,
raising where there is none; "cpu" only when asked). Each update is seeded
from (cfg.seed, its global step) (`state.step_seed`): dropout from the
device's default generator, SCST sampling from its own generator.
`profile_steps > 0` records the first epoch's first steps with
torch.profiler into `<run>/trace`.

Data parallelism (gvl_tpu_torch.parallel; the JAX loop's mesh,
loop.py:222-253, 306): launched as `python -m torch.distributed.run
--nproc_per_node N -m gvl_tpu_torch.train_cli ...`, each rank trains on its
own card (cuda:LOCAL_RANK; gloo ranks on the CPU under `--device cpu`).
- Rows: every rank builds the same seeded Batcher; rank r takes rows
  [r B/W, (r+1) B/W) of each global batch of `batch_size` rows
  (`shard_batch`). A batch that W does not divide is refused by name.
- The step (train/state.py): each rank's losses are its shares of the
  global batch's, the gradients are summed over ranks before the clip, and
  the logged losses are the global ones; each rank folds its rank into the
  step's seed (`state.rank_seed`).
- Validation runs on every rank, each on its rows, when W divides
  eval_batch_size; otherwise rank 0 evaluates alone and the others wait at
  a barrier (loop.py:249-251). Rank 0 scores and broadcasts the scores, so
  every rank takes the same best-checkpoint decisions.
- One writer: rank 0 makes the run dir and writes the logs, opts.json,
  info.json, the checkpoints and the prediction JSONs; every rank reads a
  checkpoint on resume. At the start rank 0's weights are broadcast, and
  every rank checks that its seeded init held them already
  (`replicate_tree`). The run id and seed, which `random_seed` and
  `debug` draw at parse time, are rank 0's.

Sequence parallelism (mesh_shape 'dp,sp', loop.py:221-229, 367-386): at
W >= 4 ranks, W even, the world is split dp x sp with sp = 2
(`make_mesh_for_batch`) and, with sp_msda, the sp context is set with
sp_halo_frac for the run and cleared at its end
(gvl_tpu_torch/parallel/sp.py). Validation runs under the eval world's
context, at the default halo fraction as JAX's does, when the dp size
divides eval_batch_size; otherwise rank 0 evaluates alone without one. A
smaller or odd world is plain dp, as in JAX.

Refused by name (NotImplementedError) before any work starts
(`check_config`): every option the eval side refuses
(gvl_tpu_torch.eval_cli.check_config).
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from gvl_tpu_torch import parallel as dp
from gvl_tpu_torch.config import Config
from gvl_tpu_torch.parallel.sp import set_sp_context, sp_context

TASKS = ("dvc", "pc", "grounding")


def criteria_score(task: str, scores: Dict[str, float]) -> float:
    if task == "val_loss":
        # lower val loss is better; negate so 'higher wins' stays uniform
        # (reference train.py:475-494 val_loss criterion)
        return -scores.get("val_loss_total", 1e18)
    if task == "grounding":
        return sum(scores.get(f"grounding_R@1IOU{t}", 0.0)
                   for t in (0.1, 0.3, 0.5, 0.7))
    if task == "dvc":
        return scores.get("METEOR", 0.0) + scores.get("soda_c", 0.0)
    if task == "pc":
        return (scores.get("para_METEOR", 0.0) + scores.get("para_CIDEr", 0.0)
                + scores.get("para_Bleu_4", 0.0))
    raise ValueError(task)


def ss_prob_at_epoch(cfg: Config, epoch: int) -> float:
    """The scheduled-sampling probability of `epoch` (reference
    train.py:355-358)."""
    if epoch > cfg.scheduled_sampling_start >= 0:
        frac = (epoch - cfg.scheduled_sampling_start) \
            // cfg.scheduled_sampling_increase_every
        return min(cfg.basic_ss_prob
                   + cfg.scheduled_sampling_increase_prob * frac,
                   cfg.scheduled_sampling_max_prob)
    return 0.0


def check_config(cfg: Config) -> None:
    """Raise NotImplementedError naming the first option of `cfg` that the
    port's training does not run yet: the eval side's
    (gvl_tpu_torch.eval_cli.check_config); training itself refuses none.
    Builds nothing."""
    from gvl_tpu_torch import eval_cli
    eval_cli.check_config(cfg)


def make_gpt_tokenize(cfg: Config):
    """(spec, batch tokenizer, decoder) of the gpt2 caption head, or three
    Nones for another head (loop.py:90-128), from load_gpt2_spec
    (models/gpt_captioner.py). The tokenizer writes each batch's
    `gpt_tokens` and `gpt_mask` (B, G, max_caption_len) from its raw
    captions. Offline: the hash tokenizer over spec.vocab_size ids, and ids
    -> "w<id>" words with the special ids 0-2 dropped. Pretrained:
    gpt_model's byte-level BPE on each caption + ".", padded and truncated
    to max_caption_len (padding raises, as HF's tokenizer does, when the
    files name no pad token: GPT-2's own have none), and the decode
    `decode(ids).split(".")[0]`."""
    if cfg.caption_decoder_type != "gpt2":
        return None, None, None
    from gvl_tpu_torch.models.gpt_captioner import load_gpt2_spec
    from gvl_tpu_torch.models.text_encoder import (HashTokenizer,
                                                   _batch_tokenize,
                                                   effective_max_gt_events)
    spec, bpe = load_gpt2_spec(cfg)
    if bpe is None:
        tok_fn = HashTokenizer(spec.vocab_size)

        def decode_fn(ids):
            return " ".join(f"w{int(i)}" for i in ids if int(i) > 2)
    else:
        def tok_fn(sents, max_len):
            return bpe([s + "." for s in sents], max_len)

        def decode_fn(ids):
            return bpe.decode([int(i) for i in ids]).split(".")[0]

    def add_gpt_inputs(batch):
        ids, mask = _batch_tokenize(tok_fn, batch["captions_raw"],
                                    effective_max_gt_events(cfg),
                                    cfg.max_caption_len)
        batch["gpt_tokens"] = ids
        batch["gpt_mask"] = mask
        return batch

    return spec, add_gpt_inputs, decode_fn


def init_weights(cfg: Config, model, text_encoder, probe_batch) -> None:
    """The model's initial weights: the JAX package's initializers drawn
    from a generator seeded with cfg.seed; the text encoder keeps
    load_text_encoder's (seeded the same way). probe_batch is the first
    train batch, which the JAX loop's init reads for shapes. A test that
    starts from the JAX package's init replaces this function."""
    from gvl_tpu_torch.models.layers import init_params
    dev = next(model.parameters()).device
    init_params(model, torch.Generator(device=dev).manual_seed(cfg.seed))


def _resume_opts(cfg: Config) -> None:
    """Resume continues with the run's original hyperparameters: every
    saved opt but the resume controls (reference train.py:168-183; epoch,
    id and save_dir also stay, so that a run can be extended or moved)."""
    info_path = os.path.join(cfg.save_dir, cfg.start_from, "info.json")
    if not os.path.exists(info_path):
        return
    with open(info_path) as f:
        saved = json.load(f).get("opt", {})
    exclude = {"start_from", "start_from_mode", "pretrain", "debug",
               "epoch", "id", "save_dir"}
    for k, v in saved.items():
        if k.startswith("_"):   # internal derived scratch keys
            continue
        if k not in exclude and cfg.get(k, None) != v:
            print(f"resume opt {k}: {cfg.get(k, None)} -> {v}")
            cfg.set(k, v)
    cfg.pretrain = False


def train(cfg: Config) -> str:
    """Train as `cfg` says; returns the run directory."""
    from gvl_tpu_torch import eval_cli
    from gvl_tpu_torch.data.dataset import Batcher, DenseVideoDataset
    from gvl_tpu_torch.eval.evaluate import EvalRunner
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.train.checkpoint import (CheckpointManager,
                                                load_pretrained)
    from gvl_tpu_torch.train.criterion import (LossSpec, cl_weight_at_epoch,
                                               make_weight_dict)
    from gvl_tpu_torch.train.state import (StepStatics, add_text_inputs,
                                           create_train_state,
                                           make_train_step, step_seed)
    from gvl_tpu_torch.utils.logging import (MetricsWriter, backup_envir,
                                             build_folder, create_logger,
                                             set_seed)

    if cfg.start_from:
        _resume_opts(cfg)
    check_config(cfg)
    dp.init_distributed(cfg.device)
    world = dp.make_mesh_for_batch(cfg.batch_size, cfg.mesh_shape)
    # the draws of parse time (random_seed, debug's run id) are rank 0's
    cfg.id, cfg.seed = dp.broadcast_object((cfg.id, cfg.seed))
    assert cfg.num_queries >= cfg.effective_max_gt_events, (
        f"num_queries ({cfg.num_queries}) must be >= the padded GT width "
        f"({cfg.effective_max_gt_events}): one-to-one matching needs a "
        "query per GT slot (lower max_gt_events/gt_proposal_sample_num or "
        "raise num_queries)")
    dev = eval_cli._device(cfg.device, "train", "--device")
    if dev.type == "cuda":
        # f32 matmuls and convolutions, as the JAX package computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    set_seed(cfg.seed)
    folder = build_folder(cfg)
    logger = create_logger(folder)
    backup_envir(folder)
    writer = MetricsWriter(folder)
    if dp.is_writer():
        cfg.dump_json(os.path.join(folder, "opts.json"))
    logger.info(f"run dir: {folder}; device {dev}; {world}")
    if cfg.get("sp_msda", True):
        ctx = set_sp_context(world, halo_frac=float(cfg.sp_halo_frac))
        if ctx is not None:
            logger.info(f"sp-MSDA enabled: sp={ctx.sp} "
                        f"halo_frac={ctx.halo_frac}")

    rng_data = np.random.RandomState(cfg.seed)
    train_ds = DenseVideoDataset(cfg.train_caption_file,
                                 cfg.visual_feature_folder, cfg.dict_file,
                                 True, cfg, rng_data)
    val_ds = DenseVideoDataset(cfg.val_caption_file,
                               cfg.visual_feature_folder, cfg.dict_file,
                               False, cfg, np.random.RandomState(0))
    train_batcher = Batcher(train_ds, cfg, cfg.batch_size, shuffle=True,
                            rng=rng_data, drop_last=True)
    val_batcher = Batcher(val_ds, cfg, cfg.eval_batch_size, shuffle=False)

    text = load_text_encoder(cfg, device=dev)
    gpt_spec, add_gpt_inputs, gpt_decode = make_gpt_tokenize(cfg)
    model = build_model(cfg, text.hidden_size if text else 768, device=dev,
                        gpt_spec=gpt_spec)
    # the JAX loop reads the first batch for its init: the same draw keeps
    # the two packages' batch sequences equal
    probe = add_text_inputs(next(iter(train_batcher)), text, cfg)
    init_weights(cfg, model, text, probe)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model params: {n_params / 1e6:.2f}M")
    if text is not None and \
            cfg.get("load_pretrained_language_model_from_config"):
        logger.warning("text encoder: no pretrained weights available "
                       "(offline) — using random init")

    statics = StepStatics(
        spec=LossSpec.from_config(cfg),
        enable_contrastive=cfg.enable_contrastive,
        caption_loss=cfg.caption_loss_coef > 0 and
        cfg.caption_decoder_type != "none",
        two_stage=cfg.transformer_input_type == "gt_proposals",
        train_text_encoder=cfg.enable_contrastive and
        cfg.text_encoder_learning_strategy != "frozen",
        disable_mid_caption_heads=cfg.disable_mid_caption_heads,
        enable_pos_emb_for_captioner=bool(
            cfg.get("enable_pos_emb_for_captioner", False)),
        temporal_shapes=tuple(cfg.temporal_shapes()),
        caption_rl=cfg.caption_loss_type == "rl",
        caption_cost=cfg.set_cost_caption > 0 and
        cfg.transformer_input_type != "gt_proposals",
        caption_gpt=cfg.caption_decoder_type == "gpt2",
        text_bf16=bool(cfg.train_use_amp),
        caption_bf16=bool(cfg.get("train_caption_bf16", False)))

    if cfg.pretrain and cfg.pretrain_path:
        keys = load_pretrained(model, cfg.pretrain_path, cfg.pretrain, cfg)
        logger.info(f"loaded pretrained weights ({cfg.pretrain}, {len(keys)}"
                    f" of {len(model.state_dict())} entries) from "
                    f"{cfg.pretrain_path}")
    for module in (model, text):
        if module is not None:
            dp.replicate_tree(module)

    steps_per_epoch = max(len(train_batcher), 1)
    state = create_train_state(cfg, model, steps_per_epoch, statics, text)
    step = make_train_step(model, cfg, statics, text)

    ckpt = CheckpointManager(folder)
    start_epoch = 0
    if cfg.start_from:
        payload = ckpt.restore(f"model-{cfg.start_from_mode}", state)
        if payload is not None:
            start_epoch = int(payload["epoch"])
            logger.info(f"resumed from epoch {start_epoch} (update "
                        f"{state.step})")

    runner = EvalRunner(cfg, model, train_ds.translator, text,
                        gpt_decode=gpt_decode)
    base_weights = make_weight_dict(cfg)
    if statics.two_stage:
        # the GT segments are the queries: no class or box loss
        for k in base_weights:
            if any(q in k for q in ("loss_ce", "loss_bbox", "loss_giou")):
                base_weights[k] = 0.0
    history: Dict[str, Dict] = {"val_scores": {}, "train_loss": {}}
    best = {t: -1e18 for t in TASKS}
    best_overall = -1e18
    # val-loss checkpoint selection must compare the SAME weighting across
    # epochs: the schedule's final contrastive weight, not the ramping
    # per-epoch one
    weights_val = dict(base_weights)
    cl_final = cl_weight_at_epoch(cfg, cfg.epoch)
    for k in weights_val:
        if "contrastive_loss" in k:
            weights_val[k] = cl_final

    def save(name: str, epoch: int) -> None:
        ckpt.save(name, model, text, epoch, state=state)

    # evaluate on every rank when the dp size divides the eval batch
    # (loop.py:248-253), under the world's sp context at its default halo
    # (loop.py:376-386); else on rank 0 alone, without one
    eval_dp = cfg.eval_batch_size % world.dp_size == 0

    def validate(epoch: int) -> Dict[str, float]:
        if eval_dp:
            with sp_context(world):
                return run_validation(cfg, runner, val_batcher, folder,
                                      epoch, logger, weights=weights_val)
        scores = None
        if dp.is_writer():
            with dp.local(), sp_context(None):
                scores = run_validation(cfg, runner, val_batcher, folder,
                                        epoch, logger, weights=weights_val)
        dp.barrier()
        return dp.broadcast_object(scores)

    log_every = max(steps_per_epoch // 10, 1)
    global_step = int(start_epoch * steps_per_epoch)
    for epoch in range(start_epoch, cfg.epoch):
        cl_w = cl_weight_at_epoch(cfg, epoch)
        weights = dict(base_weights)
        for k in weights:
            if "contrastive_loss" in k:
                weights[k] = cl_w
        ss_prob = ss_prob_at_epoch(cfg, epoch)

        epoch_losses: "OrderedDict[str, float]" = OrderedDict()
        t_epoch = time.time()
        n_iter = 0
        profiler = None
        if cfg.profile_steps > 0 and epoch == start_epoch and \
                dp.is_writer():
            profiler = _start_profiler(os.path.join(folder, "trace"), dev)
        for batch in train_batcher:
            batch = add_text_inputs(dp.shard_batch(batch), text, cfg)
            if add_gpt_inputs is not None:
                batch = add_gpt_inputs(batch)
            losses = step(state, batch, weights, ss_prob,
                          seed=step_seed(cfg.seed, global_step))
            global_step += 1
            n_iter += 1
            if profiler is not None and n_iter == cfg.profile_steps:
                profiler.stop()
                profiler = None
                logger.info(f"profiler trace written to {folder}/trace")
            if n_iter % log_every == 0:
                losses_h = {k: float(v) for k, v in losses.items()}
                for k, v in losses_h.items():
                    epoch_losses[k] = epoch_losses.get(k, 0.0) + v
                logger.info(f"ep {epoch} it {n_iter}/{steps_per_epoch} "
                            f"total={losses_h['total_loss']:.4f}")
                writer.write(global_step, losses_h, prefix="train/")
            if cfg.debug and n_iter >= 5:
                break

        if profiler is not None:
            profiler.stop()
        logger.info(f"epoch {epoch} done in {time.time() - t_epoch:.1f}s "
                    f"(bad videos: {train_ds.bad_video_num})")
        history["train_loss"][str(epoch)] = {
            k: v / max(n_iter // log_every, 1)
            for k, v in epoch_losses.items()}

        save("model-last", epoch)
        if cfg.save_all_checkpoint:
            save(f"model_iter_{global_step}", epoch)

        if epoch % cfg.save_checkpoint_every == 0 and \
                epoch >= cfg.min_epoch_when_save:
            scores = validate(epoch)
            history["val_scores"][str(epoch)] = scores
            writer.write(global_step, scores, prefix="eval/")

            for task in TASKS:
                s = criteria_score(task, scores)
                if s > best[task]:
                    best[task] = s
                    save(f"model-best-{task}", epoch)
            crit = criteria_score(cfg.criteria_for_best_ckpt, scores)
            if crit > best_overall:
                best_overall = crit
                save("model-best", epoch)
                logger.info(f"new best ({cfg.criteria_for_best_ckpt}): "
                            f"{crit:.4f} @ epoch {epoch}")

        info = {"opt": cfg.to_dict(), "history": history,
                "best": best, "best_overall": best_overall, "epoch": epoch}
        if dp.is_writer():
            with open(os.path.join(folder, "info.json"), "w") as f:
                json.dump(info, f, indent=1, default=str)

    if cfg.get("sp_msda", True):
        set_sp_context(None)    # the context does not outlive the run
    logger.info("training finished")
    return folder


def _start_profiler(path: str, dev: torch.device):
    """torch.profiler over the host and, on a card, the device; its trace
    goes into `path` when stopped."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(path))
    prof.start()
    return prof


def run_validation(cfg: Config, runner, val_batcher, folder: str, epoch: int,
                   logger, weights: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """Evaluate the runner's model (in eval mode) on the val batches and
    score the result JSONs (under only_ft_class_head also the TAL JSON, by
    eval_tal against tal_gt_file, when that file exists); with `weights`,
    also the weighted total of the eval losses, 'val_loss_total'
    (loop.py:374-422). Under data parallelism every rank evaluates its
    rows, rank 0 scores the JSONs it wrote and broadcasts the scores."""
    runner.model.eval()
    if runner.text_encoder is not None:
        runner.text_encoder.eval()
    dvc_path = os.path.join(folder, f"pred_epoch{epoch}.json")
    out_path, _, _, _, loss_sum = runner.run(val_batcher, dvc_path,
                                             logger=logger, debug=cfg.debug)
    scores = None
    if dp.is_writer():
        scores = _scores(cfg, runner, out_path, loss_sum, logger, weights)
    return dp.broadcast_object(scores)


def _scores(cfg: Config, runner, out_path: str, loss_sum: Dict[str, float],
            logger, weights: Optional[Dict[str, float]]) -> Dict[str, float]:
    """The scores of the result JSONs at `out_path` and the eval losses."""
    from gvl_tpu_torch.eval.metrics import (eval_metrics,
                                            eval_metrics_grounding, eval_tal)
    scores: Dict[str, float] = {}
    skip_lang = cfg.eval_disable_captioning or \
        cfg.caption_decoder_type == "none" or cfg.caption_loss_coef == 0
    if not skip_lang:
        scores.update(eval_metrics(
            out_path, gt_filenames=cfg.gt_file_for_eval,
            para_gt_filenames=cfg.gt_file_for_para_eval,
            dvc_eval_version=cfg.eval_tool_version))
    if cfg.enable_contrastive and cfg.eval_enable_grounding:
        scores.update(eval_metrics_grounding(
            out_path + ".grounding.json", cfg.eval_gt_file_for_grounding))
        aux_scores = eval_metrics_grounding(
            out_path + "_aux.grounding.json", cfg.eval_gt_file_for_grounding)
        scores.update({"aux_" + k: v for k, v in aux_scores.items()})
    if cfg.only_ft_class_head and os.path.exists(cfg.tal_gt_file) and \
            getattr(runner, "last_tal_json", None):
        scores.update(eval_tal(cfg.tal_gt_file, runner.last_tal_json))
    scores.update({"val_" + k: v for k, v in loss_sum.items()})
    if weights is not None:
        scores["val_loss_total"] = float(sum(
            w * loss_sum[k] for k, w in weights.items() if k in loss_sum))
    summary = {k: round(float(v), 4) for k, v in scores.items()
               if isinstance(v, (int, float))}
    if scores.get("approx"):
        # the summary line flags approximate metrics (METEOR without the
        # jar's data, SPICE's chunker parser)
        summary["approx"] = scores["approx"]
    logger.info("val scores: " + json.dumps(summary))
    return scores
