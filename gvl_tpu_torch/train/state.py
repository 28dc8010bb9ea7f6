"""Optimizers, learning-rate schedules and the train step.

Port of gvl_tpu/train/state.py for the dense-captioning train step:
forward in train mode, the text branch when the contrastive side is on (the
text encoder, frozen and without gradients or trained with an optimizer and
schedule of its own, over f32 or bf16-rounded weights; then `encode_text`),
set criterion, the caption loss (teacher-forced NLL, or at ss_prob > 0 the
scheduled-sampling chain's; under caption_gpt the
ClipCap head's loss of each matched event, state.py:437-445, also when
caption_rl is set, as the JAX step's gpt2 branch comes first; otherwise
under caption_rl the SCST policy loss of a sampled rollout against a greedy
one, rewarded on the host; gvl_tpu_torch/train/rl.py), weighted loss sum,
one backward, a
global-norm gradient clip of each parameter set, optimizer and schedule
steps. The model, the text encoder, the optimizers and the batch live on the
model's device; batches arrive as numpy arrays.

Random draws: dropout comes from the default generator of the model's
device, SCST's and scheduled sampling's from generators of their own on the
device. A step given `seed` seeds them all from it (`step_seed(cfg.seed,
global_step)` in the train loop), so a resumed run draws at step n what an
unbroken run draws there; without one, all draw from the device's default
generator.

Under data parallelism (gvl_tpu_torch.parallel) each rank's losses are its
shares of the global batch's (train/criterion.py, and the caption losses
here over global counts), the backward gives the rank's share of the
gradient, and `sum_gradients` sums the model's and the trained text
encoder's gradients over ranks in one flat all_reduce before the clip, so
that the clip and the optimizers act on the global gradient as JAX's do;
the returned losses are the global sums of the shares (`sum_shares`). Each
rank folds its dp index into the step's seed (`rank_seed`), so that the row
blocks draw different masks: JAX's one key over the global batch cannot be
matched by any split. On a world split dp x sp
(gvl_tpu_torch/parallel/sp.py) each rank backpropagates 1/sp of its row
block's loss.

Under caption_bf16 (train_caption_bf16, state.py:252-265) the caption head's
weights read as bf16 inside autograd and its query and memory are cast, for
teacher forcing and both SCST rollout chains; the NLL's logsumexp and the
chosen-token logprobs stay f32 inside the heads. It is a no-op for the
gpt2 head (state.py:262).

With caption_cost (set_cost_caption > 0, the caption loss on, SCST off;
state.py:276-299) every decoder layer's caption NLL of every (query, GT)
pair joins the matcher's cost (compute_criterion's `cap_costs`). JAX reads
the caption loss from that tensor's matched entries and so keeps the graph
of all Nq x G pairs; here the pair pass runs without gradient and the
matched pairs' teacher-forced NLL is computed again with it, which gives
the same loss (the per-video mean over the matched pairs, then over the
videos, criterion.py:446-450) and the same gradient in a fraction of the
memory. Only with dropout on do the two differ: the matched pass draws
its own masks. Under two_stage
(transformer_input_type 'gt_proposals', state.py:225-231) the GT segments
are the decoder's queries and the boxes are not refined.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gvl_tpu_torch import parallel as dp
from gvl_tpu_torch.models.captioner import caption_nll, prepare_dsa_reference
from gvl_tpu_torch.models.gvl import GVLModel
from gvl_tpu_torch.models.text_encoder import (TextEncoder,
                                               effective_max_gt_events)
from gvl_tpu_torch.models.transformer import pyramid_shapes
from gvl_tpu_torch.train.criterion import LossSpec, compute_criterion
from gvl_tpu_torch.train.rl import rl_policy_loss
from gvl_tpu_torch.utils.amp import to_bf16

Schedule = Callable[[int], float]


def build_schedule(strategy: str, base_lr: float, total_steps: int,
                   steps_per_epoch: int, warm_up_ratio: float,
                   decay_start: float, decay_every: float, decay_rate: float,
                   total_epochs: int) -> Schedule:
    """Learning rate of update number `step`, counted from 0 for the first
    update. Port of build_schedule (state.py:37-62)."""
    if strategy in ("warmup_linear", "warmup_cosine"):
        warm = max(int(warm_up_ratio * total_steps), 1)
        if strategy == "warmup_linear":
            n = max(total_steps - warm, 1)

            def sched(step):
                if step < warm:
                    return base_lr * step / warm
                return base_lr * (1.0 - min(step - warm, n) / n)
            return sched
        n = total_steps - warm
        if n <= 0:
            raise ValueError("warmup_cosine needs total_steps > warm-up steps")

        def sched(step):
            if step < warm:
                return base_lr * step / warm
            return base_lr * 0.5 * (
                1.0 + math.cos(math.pi * min(step - warm, n) / n))
        return sched
    if strategy == "multi_step":
        n_miles = max(int((total_epochs - decay_start) / decay_every), 0)
        milestones = [decay_start + decay_every * i for i in range(n_miles)]

        def sched(step):
            epoch = step / max(steps_per_epoch, 1)
            return base_lr * decay_rate ** sum(epoch >= m for m in milestones)
        return sched
    raise NotImplementedError(strategy)


def _is_task_head(name: str) -> bool:
    return name.startswith("caption_head") or name.startswith("bbox_head")


def _freeze_mode(cfg: Any) -> str:
    if getattr(cfg, "only_ft_captioner", False) or getattr(
            cfg, "ft_captioner_from_scratch", False):
        return "captioner"
    if getattr(cfg, "only_ft_class_head", False):
        return "class_head"
    return ""


def build_optimizer(cfg: Any, named_params: Dict[str, torch.Tensor],
                    total_steps: int, steps_per_epoch: int,
                    for_text_encoder: bool = False
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """Adam (weight decay as L2 through the gradient) or AdamW (decoupled),
    a separate learning rate for the `caption_head*` / `bbox_head*`
    parameters under `task_heads_different_lr`, and the freeze modes: with
    `only_ft_captioner` / `only_ft_class_head` only the parameters of that
    head are handed to the optimizer; the others still receive gradients and
    count in the clipped norm, and are never updated. With for_text_encoder,
    the text encoder's optimizer: the same optimizer_type and weight_decay,
    the schedule of the text_encoder_* options, no head learning rate and no
    freeze mode. Port of build_optimizer (state.py:92-137). Returns the
    optimizer and its per-group schedule."""
    def get(name, default):
        return getattr(cfg, name, default)

    def sched(base_lr):
        return build_schedule(
            get("learning_strategy", "multi_step"), base_lr, total_steps,
            steps_per_epoch, get("warm_up_ratio", 0.1),
            get("learning_rate_decay_start", 8),
            get("learning_rate_decay_every", 3),
            get("learning_rate_decay_rate", 0.5), get("epoch", 30))

    if for_text_encoder:
        groups = [(list(named_params.values()), build_schedule(
            get("text_encoder_learning_strategy", "warmup_linear"),
            get("text_encoder_lr", 1e-5), total_steps, steps_per_epoch,
            get("text_encoder_warm_up_ratio", 0.01),
            get("text_encoder_lr_decay_start", 8),
            get("text_encoder_lr_decay_every", 3),
            get("text_encoder_lr_decay_rate", 0.5), get("epoch", 30)))]
        return _adam(cfg, groups)
    freeze = _freeze_mode(cfg)
    if freeze:
        prefix = {"captioner": "caption_head", "class_head": "class_head"}[freeze]
        named_params = {n: p for n, p in named_params.items()
                        if n.startswith(prefix)}
    groups: List[Tuple[List[torch.Tensor], Schedule]] = []
    if get("task_heads_different_lr", False):
        heads = [p for n, p in named_params.items() if _is_task_head(n)]
        rest = [p for n, p in named_params.items() if not _is_task_head(n)]
        groups = [(rest, sched(cfg.lr)), (heads, sched(cfg.task_heads_lr))]
        groups = [g for g in groups if g[0]]
    else:
        groups = [(list(named_params.values()), sched(cfg.lr))]
    return _adam(cfg, groups)


def _adam(cfg: Any, groups: List[Tuple[List[torch.Tensor], Schedule]]
          ) -> Tuple[torch.optim.Optimizer,
                     torch.optim.lr_scheduler.LambdaLR]:
    """cfg.optimizer_type's optimizer over the parameter groups, each with
    its schedule."""
    # lr 1.0 in the groups: LambdaLR multiplies it by the schedule's value
    cls = (torch.optim.AdamW if getattr(cfg, "optimizer_type", "adam")
           == "adamw" else torch.optim.Adam)
    opt = cls([dict(params=p) for p, _ in groups], lr=1.0, betas=(0.9, 0.999),
              eps=1e-8, weight_decay=getattr(cfg, "weight_decay", 0.0))
    scheduler = torch.optim.lr_scheduler.LambdaLR(opt, [s for _, s in groups])
    return opt, scheduler


def clip_global_norm(parameters, max_norm: float) -> torch.Tensor:
    """Scale the gradients of `parameters` in place by
    min(1, max_norm / (global norm + 1e-6)); returns the norm before clipping
    (state.py:555-558)."""
    return torch.nn.utils.clip_grad_norm_(parameters, max_norm)


@dataclasses.dataclass(frozen=True)
class StepStatics:
    """Static switches of the train step (state.py:149-171)."""
    spec: LossSpec
    enable_contrastive: bool
    caption_loss: bool           # caption_loss_coef > 0
    two_stage: bool              # transformer_input_type == 'gt_proposals'
    train_text_encoder: bool
    disable_mid_caption_heads: bool
    enable_pos_emb_for_captioner: bool
    temporal_shapes: Tuple[int, ...]
    caption_rl: bool = False
    caption_cost: bool = False
    caption_gpt: bool = False
    text_bf16: bool = False
    caption_bf16: bool = False


def _check_statics(statics: StepStatics, text_encoder) -> None:
    if (statics.enable_contrastive or statics.train_text_encoder) and \
            text_encoder is None:
        raise ValueError("train step: enable_contrastive needs the text "
                         "encoder (models.text_encoder.load_text_encoder)")


def add_text_inputs(batch: Dict, text_encoder: TextEncoder, cfg: Any) -> Dict:
    """Tokenize batch['captions_raw'] into batch['text_ids'] and
    batch['text_mask'] (B, G, max_text_input_len), in place; a no-op
    without a text encoder (gvl_tpu/train/loop.py:80-87)."""
    if text_encoder is not None:
        ids, mask = text_encoder.tokenize(
            batch["captions_raw"], effective_max_gt_events(cfg),
            int(getattr(cfg, "max_text_input_len", 32)))
        batch["text_ids"] = ids
        batch["text_mask"] = mask
    return batch


def step_seed(seed: int, global_step: int) -> int:
    """The seed of update number `global_step` of a run seeded `seed`: a
    pure function of the two, so a resumed run seeds step n as an unbroken
    one does (the JAX loop's PRNGKey(global_step))."""
    return fold_seed(seed, global_step)


def fold_seed(seed: int, k: int) -> int:
    """A seed derived from `seed` and `k` (jax.random.fold_in's role)."""
    return (int(seed) * 1_000_003 + int(k)) % (2 ** 63)


def rank_seed(seed: int) -> int:
    """This rank's seed of a step seeded `seed`: `seed` in a world of one,
    else `seed` folded with the rank's dp index, so that no two row blocks
    draw alike and the sp ranks of one block draw alike."""
    w = dp.world()
    return seed if w.size == 1 else fold_seed(seed, w.dp_rank)


def gather_matched(x: torch.Tensor, match_q: torch.Tensor) -> torch.Tensor:
    """x (B, Nq, ...) gathered at match_q (B, G) -> (B, G, ...)."""
    idx = match_q.reshape(match_q.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


class TrainState:
    """The model being trained, its optimizer and schedule, the number of
    updates taken, the text encoder beside the model (None with the
    contrastive side off), and the text encoder's own optimizer and schedule
    (None while it is frozen)."""

    def __init__(self, model: GVLModel, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LambdaLR, step: int = 0,
                 text_encoder: TextEncoder = None,
                 text_optimizer: torch.optim.Optimizer = None,
                 text_scheduler: torch.optim.lr_scheduler.LambdaLR = None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = step
        self.text_encoder = text_encoder
        self.text_optimizer = text_optimizer
        self.text_scheduler = text_scheduler


def create_train_state(cfg: Any, model: GVLModel, steps_per_epoch: int,
                       statics: StepStatics,
                       text_encoder: TextEncoder = None) -> TrainState:
    """Optimizer and schedule for `model`, on the model's device. The text
    encoder (required with enable_contrastive) stays frozen, or under
    train_text_encoder gets gradients and an optimizer and schedule of its
    own (`build_optimizer(..., for_text_encoder=True)`); it stays in eval
    mode either way: the JAX package runs it without dropout
    (state.py:561-576)."""
    _check_statics(statics, text_encoder)
    total_steps = int(getattr(cfg, "epoch", 30) * steps_per_epoch)
    opt, scheduler = build_optimizer(cfg, dict(model.named_parameters()),
                                     total_steps, steps_per_epoch)
    text_opt = text_scheduler = None
    if statics.train_text_encoder:
        text_encoder.requires_grad_(True).eval()
        text_opt, text_scheduler = build_optimizer(
            cfg, dict(text_encoder.named_parameters()), total_steps,
            steps_per_epoch, for_text_encoder=True)
    return TrainState(model, opt, scheduler, text_encoder=text_encoder,
                      text_optimizer=text_opt, text_scheduler=text_scheduler)


def make_train_step(model: GVLModel, cfg: Any, statics: StepStatics,
                    text_encoder: TextEncoder = None):
    """Build `step(state, batch, weights, ss_prob=0.0, seed=None) -> losses`
    (state.py:180-552). At ss_prob > 0 the LSTM-DSA head's teacher forcing
    runs the scheduled-sampling chain and caption_nll reads its logprobs
    (the fused NLL needs ss_prob == 0, state.py:269-274).

    batch: numpy arrays video_feats (B, T, D), video_mask (B, T), duration
    (B,), gt_boxes (B, G, 2), gt_labels (B, G), gt_mask (B, G), captions
    (B, G, Lc), caption_mask (B, G, Lc), with enable_contrastive
    text_ids and text_mask (B, G, Ltok) (`add_text_inputs`), and under
    caption_gpt gpt_tokens and gpt_mask (B, G, Lc) (the train loop's
    `make_gpt_tokenize`); moved to the
    model's device inside. weights: loss name -> float
    (`make_weight_dict`, the contrastive weight from `cl_weight_at_epoch`);
    the matcher's contrastive cost is on when weights['contrastive_loss'] >
    0 (state.py:514-519). The step puts the model in train mode, computes
    the losses, backpropagates their weighted sum, clips the global gradient
    norm at cfg.grad_clip, and steps the optimizer and the schedule of
    `state`. The text encoder runs in eval mode (no dropout, as the JAX
    package's apply_fn), over weights rounded to bf16 under text_bf16; it
    runs under no_grad unless train_text_encoder, and then its gradients
    come from the same backward, are clipped by a global norm of their own
    and step its optimizer and schedule. Returns the losses (detached 0-d
    tensors on the device) with 'total_loss'. `step.forward_losses(batch,
    cl_gate=1.0, seed=None, ss_prob=0.0)` computes the losses alone, in the
    model's current mode.

    Under caption_rl (SCST, state.py:199-215, 371-483) the caption loss of
    each layer is rl_policy_loss over its many-to-one matched slots
    (`match_layer_m2o`, rl_m2o_rate per GT): a sampled rollout in train
    mode, a greedy one with the head in eval mode and without gradients,
    and the reward of the two on the host (one copy of the token arrays).
    With a shared head and fuse_caption_layers, all layers' slots go
    through one sampled and one greedy chain (sampling seeded with fold
    1000); otherwise each layer has its own (fold 1000 + layer).

    `step.tick`, when set, is called with the name of each part as it ends
    ("trunk": the forward and the criterion; under SCST "sampled",
    "greedy", "reward"; then "backward", "gradient_sum" (the gradients
    summed over ranks; nothing without a process group), "optimizer"): a
    caller timing the step sets it."""
    _check_statics(statics, text_encoder)
    st = statics
    Ld = model.arch.dec_layers
    grad_clip = float(getattr(cfg, "grad_clip", 100.0))
    # the LSTM heads treat events independently, so a shared one folds the
    # layers into the event axis (state.py:314-316, 208-210)
    fuse = (bool(getattr(cfg, "fuse_caption_layers", True))
            and model.arch.share_caption_head
            and model.arch.caption_decoder_type in ("standard", "light"))
    cap_levels = model.arch.cap_num_feature_levels
    cap_points = model.arch.cap_dec_n_points
    rate = int(getattr(cfg, "rl_m2o_rate", 4)) if st.caption_rl else 0
    rl_layers = [Ld - 1] if st.disable_mid_caption_heads else list(range(Ld))
    rl_fused = fuse and len(rl_layers) > 1
    reward_fn = None
    if st.caption_rl:
        from gvl_tpu_torch.train.rl import init_scorer, rl_reward_callback
        types_ = list(getattr(cfg, "rl_scorer_types", ["Meteor"]))
        reward_fn = rl_reward_callback(
            init_scorer(types_, getattr(cfg, "cached_tokens", None)),
            dict(zip(types_, getattr(cfg, "rl_scorer_weights", [1.0]))),
            float(getattr(cfg, "cl_sent_ratio", 1.0)),
            float(getattr(cfg, "cl_para_ratio", 0.0)), m2o_rate=rate,
            n_groups=len(rl_layers) if rl_fused else 1)

    def tick(name: str) -> None:
        if step.tick is not None:
            step.tick(name)

    def to_device(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    cap_bf16 = st.caption_bf16 and not st.caption_gpt
    cap_cast = to_bf16 if cap_bf16 else (lambda x: x)

    def caption_query(out, layer, mq):
        query = gather_matched(out["hs"][layer], mq)
        if st.enable_pos_emb_for_captioner:
            query = torch.cat(
                [query, gather_matched(out["query_pos"], mq)], dim=-1)
        return cap_cast(query)

    def prepared_ref(out, layer, mq, shapes):
        return prepare_dsa_reference(
            gather_matched(out["layer_refs"][layer], mq),
            out["valid_ratios"], shapes, cap_levels, cap_points)

    def text_layers(db, out):
        """The text branch (state.py:233-250): the text encoder, over
        bf16-rounded weights under text_bf16, without gradients unless it
        trains (the JAX package's stop_gradient), then encode_text; decoder
        layers 0..Ld-2 take 'aux', the last 'final'."""
        ids, tmask = db["text_ids"], db["text_mask"]
        B, G, Ltok = ids.shape
        with torch.set_grad_enabled(st.train_text_encoder
                                    and torch.is_grad_enabled()):
            word = text_encoder(ids.reshape(B * G, Ltok).long(),
                                tmask.reshape(B * G, Ltok),
                                bf16_weights=st.text_bf16)
        text_out = model.encode_text(
            word.float().reshape(B, G, Ltok, -1), tmask.bool(), db["gt_mask"],
            out["memory"], out["mask_flat"])
        return [text_out["aux"]] * (Ld - 1) + [text_out["final"]]

    def gpt_losses(db, out, match_qs):
        """The ClipCap loss of each layer's matched events, its mean over
        the valid GT slots (state.py:437-445)."""
        layers = [Ld - 1] if st.disable_mid_caption_heads else list(range(Ld))
        gt = db["gt_mask"].float()
        denom = dp.global_sum(gt.sum()).clamp(min=1)
        losses = {}
        for l in layers:
            pair = model.caption_train_gpt(
                l, gather_matched(out["hs"][l], match_qs[l]),
                db["gpt_tokens"], db["gpt_mask"])
            suffix = "" if l == Ld - 1 else f"_{l}"
            losses["loss_caption" + suffix] = (pair * gt).sum() / denom
        return losses

    def scst_losses(db, out, shapes, rl_matches, seed):
        """The SCST caption losses (state.py:371-427 fused, :446-483 per
        layer)."""
        common = (cap_cast(out["memory"]), out["mask_flat"], shapes,
                  out["valid_ratios"])
        groups = [rl_layers] if rl_fused else [[l] for l in rl_layers]
        dev = out["memory"].device
        losses = {}
        for group in groups:
            fused = len(group) > 1
            mqs = [rl_matches[l][0] for l in group]
            query = torch.cat([caption_query(out, l, mq)
                               for l, mq in zip(group, mqs)], dim=1)
            if fused:
                ref = torch.cat([prepared_ref(out, l, mq, shapes)
                                 for l, mq in zip(group, mqs)], dim=1)
            else:
                ref = gather_matched(out["layer_refs"][group[0]], mqs[0])
            valid = torch.cat([rl_matches[l][1] for l in group], dim=1)
            head_id = group[-1]
            gen = None
            if seed is not None:
                gen = torch.Generator(device=dev).manual_seed(
                    fold_seed(seed, 1000 if fused else 1000 + group[0]))
            seq, lps = model.caption_sample(
                head_id, query, ref, *common, greedy=False, generator=gen,
                ref_prepared=fused)
            tick("sampled")
            head = model.caption_head[head_id]
            was_training = head.training
            head.eval()
            try:
                with torch.no_grad():
                    greedy_seq, _ = model.caption_sample(
                        head_id, query, ref, *common, greedy=True,
                        ref_prepared=fused)
            finally:
                head.train(was_training)
            tick("greedy")
            gt = db["captions"].repeat(1, len(group) * rate, 1)
            rewards = reward_fn(*(x.cpu().numpy()
                                  for x in (seq, greedy_seq, gt, valid)))
            rewards = torch.from_numpy(rewards).to(dev)
            tick("reward")
            GL = mqs[0].shape[1]
            for i, l in enumerate(group):
                sl = slice(i * GL, (i + 1) * GL)
                suffix = "" if l == Ld - 1 else f"_{l}"
                losses["loss_caption" + suffix] = rl_policy_loss(
                    lps[:, sl], seq[:, sl], rewards[:, sl], valid[:, sl])
        return losses

    @torch.no_grad()
    def caption_costs(db, out, shapes):
        """Each layer's fused caption NLL of every (query, GT) pair, (B, Nq,
        G), without gradient: the queries repeated G times, the captions
        tiled Nq times (state.py:276-299), the widest caption pass of the
        step."""
        B, G, _ = db["captions"].shape
        Nq = out["hs"].shape[2]
        seq = db["captions"].repeat(1, Nq, 1)
        seq_mask = db["caption_mask"].repeat(1, Nq, 1)
        costs = []
        for l in range(Ld):
            query = out["hs"][l].repeat_interleave(G, dim=1)  # (B, Nq*G, C)
            if st.enable_pos_emb_for_captioner:
                query = torch.cat(
                    [query, out["query_pos"].repeat_interleave(G, dim=1)], -1)
            nll = model.caption_train_nll(
                l, cap_cast(query),
                out["layer_refs"][l].repeat_interleave(G, dim=1),
                cap_cast(out["memory"]), out["mask_flat"], shapes,
                out["valid_ratios"], seq, seq_mask)
            costs.append(nll.reshape(B, Nq, G))
        return costs

    def forward_losses(batch, cl_gate=1.0, seed: Optional[int] = None,
                       ss_prob: float = 0.0) -> Dict[str, torch.Tensor]:
        db = to_device(batch)
        shapes = pyramid_shapes(db["video_feats"].shape[1],
                                len(st.temporal_shapes))
        proposals = dict(proposals=db["gt_boxes"],
                         proposals_mask=db["gt_mask"]) if st.two_stage else {}
        out = model(db["video_feats"], db["video_mask"], db["duration"],
                    **proposals)
        texts = text_layers(db, out) if st.enable_contrastive else None
        rl_matches = [] if st.caption_rl else None
        bf16 = model.caption_bf16 if cap_bf16 else contextlib.nullcontext
        cap_costs = None
        if st.caption_cost and st.caption_loss and not st.caption_rl:
            with bf16():
                cap_costs = caption_costs(db, out, shapes)
        losses, match_qs = compute_criterion(
            out, db["gt_boxes"], db["gt_labels"], db["gt_mask"], texts,
            st.spec, cap_costs=cap_costs, cl_gate=cl_gate, rl_m2o_rate=rate,
            rl_matches=rl_matches)
        tick("trunk")
        if not st.caption_loss:
            return losses
        with bf16():
            losses.update(caption_losses(db, out, shapes, match_qs,
                                         rl_matches, seed, ss_prob,
                                         cap_costs is not None))
        return losses

    def caption_losses(db, out, shapes, match_qs, rl_matches, seed,
                       ss_prob, caption_cost=False):
        """The caption losses: the gpt2 head's, SCST's, or the
        teacher-forced NLL of each layer (state.py:329-507). With
        caption_cost, every layer's matched pairs, teacher-forced, averaged
        as compute_criterion averages the caption cost's matched entries."""
        if caption_cost:
            layers, ss_prob = list(range(Ld)), 0.0
        elif st.caption_gpt:
            return gpt_losses(db, out, match_qs)
        elif st.caption_rl:
            return scst_losses(db, out, shapes, rl_matches, seed)
        else:
            layers = [Ld - 1] if st.disable_mid_caption_heads \
                else list(range(Ld))
        losses = {}
        validf = db["gt_mask"].float()
        has_any = db["gt_mask"].any(-1).float()
        if caption_cost:
            n_any = dp.global_sum(has_any.sum()).clamp(min=1)
        else:
            denom = dp.global_sum(validf.sum()).clamp(min=1)
        common = (cap_cast(out["memory"]), out["mask_flat"], shapes,
                  out["valid_ratios"])
        gen = None
        if ss_prob > 0 and seed is not None:
            gen = torch.Generator(device=out["memory"].device).manual_seed(
                fold_seed(seed, 77))

        def nll(layer, query, ref, seq, seq_mask, ref_prepared=False):
            """The fused teacher-forcing NLL (B, Ne), or at ss_prob > 0
            caption_nll over the scheduled-sampling chain's logprobs."""
            if ss_prob == 0:
                return model.caption_train_nll(layer, query, ref, *common,
                                               seq, seq_mask,
                                               ref_prepared=ref_prepared)
            lp = model.caption_train(layer, query, ref, *common, seq,
                                     ss_prob=ss_prob,
                                     ref_prepared=ref_prepared, generator=gen)
            B, Ne = seq.shape[:2]
            return caption_nll(lp.reshape(B * Ne, *lp.shape[2:]),
                               seq[:, :, 1:].reshape(B * Ne, -1),
                               seq_mask[:, :, 1:].reshape(B * Ne, -1)
                               ).reshape(B, Ne)

        if fuse and len(layers) > 1:
            # one teacher-forcing pass for all layers: the shared head treats
            # events independently, so the layers fold into the event axis.
            # Layer references differ in width; their prepared form does not
            Lf = len(layers)
            query = torch.cat([caption_query(out, l, match_qs[l])
                               for l in layers], dim=1)        # (B, Lf*G, C)
            ref = torch.cat([prepared_ref(out, l, match_qs[l], shapes)
                             for l in layers], dim=1)
            fused = nll(layers[-1], query, ref,
                        db["captions"].repeat(1, Lf, 1),
                        db["caption_mask"].repeat(1, Lf, 1),
                        ref_prepared=True)
            fused = fused.reshape(fused.shape[0], Lf, -1)
            per_layer = [fused[:, i] for i in range(Lf)]
        else:
            per_layer = [nll(
                l, caption_query(out, l, match_qs[l]),
                gather_matched(out["layer_refs"][l], match_qs[l]),
                db["captions"], db["caption_mask"]) for l in layers]
        for l, layer_nll in zip(layers, per_layer):
            suffix = "" if l == Ld - 1 else f"_{l}"
            if caption_cost:
                per_video = (layer_nll * validf).sum(-1) \
                    / validf.sum(-1).clamp(min=1)
                losses["loss_caption" + suffix] = \
                    (per_video * has_any).sum() / n_any
            else:
                losses["loss_caption" + suffix] = \
                    (layer_nll * validf).sum() / denom
        return losses

    def step(state: TrainState, batch: Dict[str, np.ndarray],
             weights: Dict[str, float], ss_prob: float = 0.0,
             seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("train step: the state holds another model")
        if st.train_text_encoder and state.text_optimizer is None:
            raise ValueError("train step: train_text_encoder needs the text "
                             "encoder's optimizer (create_train_state)")
        if seed is not None:
            seed = rank_seed(seed)
            torch.manual_seed(seed)           # the dropout draws
        model.train()
        # the model's, not the optimizer's: in a freeze mode the optimizer
        # holds the head only, and the clip below counts every gradient
        model.zero_grad(set_to_none=True)
        if st.train_text_encoder:
            text_encoder.zero_grad(set_to_none=True)
        # the matcher's contrastive cost follows the contrastive weight's
        # schedule (state.py:514-519)
        cl_gate = float(weights.get("contrastive_loss", 0.0) > 0) \
            if "contrastive_loss" in weights else 1.0
        losses = forward_losses(batch, cl_gate, seed, ss_prob)
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        # under sequence parallelism each sp rank holds the row block's
        # whole loss: 1/sp of it each (parallel/sp.py, the gradient rule)
        (total * dp.loss_scale()).backward()
        tick("backward")
        # the global gradient: every rank's share summed, never averaged
        dp.sum_gradients(list(model.parameters()) + (
            list(text_encoder.parameters()) if st.train_text_encoder
            else []))
        tick("gradient_sum")
        clip_global_norm(model.parameters(), grad_clip)
        state.optimizer.step()
        if st.train_text_encoder:
            # a parameter no loss reaches (the pooler) gets a zero gradient,
            # so that Adam's L2 term moves it as optax does
            for p in text_encoder.parameters():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            clip_global_norm(text_encoder.parameters(), grad_clip)
            state.text_optimizer.step()
            state.text_scheduler.step()
        state.scheduler.step()
        state.step += 1
        tick("optimizer")
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total_loss"] = total.detach()
        return dp.sum_shares(losses)

    step.forward_losses = forward_losses
    step.tick = None
    return step
