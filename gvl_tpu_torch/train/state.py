"""Optimizers, learning-rate schedules and the train step.

Port of gvl_tpu/train/state.py for the dense-captioning train step with the
contrastive text side off: forward in train mode, set criterion, teacher-forced
caption NLL, weighted loss sum, backward, global-norm gradient clip,
optimizer and schedule step. The model, its optimizer and the batch live on
the model's device; batches arrive as numpy arrays.

Dropout draws come from the default generator of the model's device: seed it
(`torch.manual_seed`) before the first step for a repeatable run.

Refused by name (NotImplementedError): `enable_contrastive`, `caption_rl`,
`caption_cost`, `caption_gpt`, `two_stage`, `caption_bf16`, `text_bf16`,
`train_text_encoder`, and scheduled sampling (`ss_prob > 0`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from gvl_tpu_torch.models.captioner import prepare_dsa_reference
from gvl_tpu_torch.models.gvl import GVLModel
from gvl_tpu_torch.models.transformer import pyramid_shapes
from gvl_tpu_torch.train.criterion import LossSpec, compute_criterion

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
                    total_steps: int, steps_per_epoch: int
                    ) -> Tuple[torch.optim.Optimizer,
                               torch.optim.lr_scheduler.LambdaLR]:
    """Adam (weight decay as L2 through the gradient) or AdamW (decoupled),
    a separate learning rate for the `caption_head*` / `bbox_head*`
    parameters under `task_heads_different_lr`, and the freeze modes: with
    `only_ft_captioner` / `only_ft_class_head` only the parameters of that
    head are handed to the optimizer; the others still receive gradients and
    count in the clipped norm, and are never updated. Port of build_optimizer
    (state.py:92-137). Returns the optimizer and its per-group schedule."""
    def get(name, default):
        return getattr(cfg, name, default)

    def sched(base_lr):
        return build_schedule(
            get("learning_strategy", "multi_step"), base_lr, total_steps,
            steps_per_epoch, get("warm_up_ratio", 0.1),
            get("learning_rate_decay_start", 8),
            get("learning_rate_decay_every", 3),
            get("learning_rate_decay_rate", 0.5), get("epoch", 30))

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
    # lr 1.0 in the groups: LambdaLR multiplies it by the schedule's value
    cls = (torch.optim.AdamW if get("optimizer_type", "adam") == "adamw"
           else torch.optim.Adam)
    opt = cls([dict(params=p) for p, _ in groups], lr=1.0, betas=(0.9, 0.999),
              eps=1e-8, weight_decay=get("weight_decay", 0.0))
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


_NOT_PORTED = ("enable_contrastive", "caption_rl", "caption_cost",
               "caption_gpt", "two_stage", "caption_bf16", "text_bf16",
               "train_text_encoder")


def _check_statics(statics: StepStatics) -> None:
    for name in _NOT_PORTED:
        if getattr(statics, name):
            raise NotImplementedError(
                f"train step: {name} is not ported yet (ROADMAP Queue 1)")


def gather_matched(x: torch.Tensor, match_q: torch.Tensor) -> torch.Tensor:
    """x (B, Nq, ...) gathered at match_q (B, G) -> (B, G, ...)."""
    idx = match_q.reshape(match_q.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))


class TrainState:
    """The model being trained, its optimizer and schedule, and the number
    of updates taken."""

    def __init__(self, model: GVLModel, optimizer: torch.optim.Optimizer,
                 scheduler: torch.optim.lr_scheduler.LambdaLR, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = step


def create_train_state(cfg: Any, model: GVLModel, steps_per_epoch: int,
                       statics: StepStatics) -> TrainState:
    """Optimizer and schedule for `model`, on the model's device
    (state.py:561-576)."""
    _check_statics(statics)
    total_steps = int(getattr(cfg, "epoch", 30) * steps_per_epoch)
    opt, scheduler = build_optimizer(cfg, dict(model.named_parameters()),
                                     total_steps, steps_per_epoch)
    return TrainState(model, opt, scheduler)


def make_train_step(model: GVLModel, cfg: Any, statics: StepStatics):
    """Build `step(state, batch, weights, ss_prob=0.0) -> losses`
    (state.py:180-552).

    batch: numpy arrays video_feats (B, T, D), video_mask (B, T), duration
    (B,), gt_boxes (B, G, 2), gt_labels (B, G), gt_mask (B, G), captions
    (B, G, Lc), caption_mask (B, G, Lc); moved to the model's device inside.
    weights: loss name -> float (`make_weight_dict`). The step puts the model
    in train mode, computes the losses, backpropagates their weighted sum,
    clips the global gradient norm at cfg.grad_clip, and steps the optimizer
    and the schedule of `state`. Returns the losses (detached 0-d tensors on
    the device) with 'total_loss'. `step.forward_losses(batch)` computes the
    losses alone, in the model's current mode."""
    _check_statics(statics)
    st = statics
    Ld = model.arch.dec_layers
    grad_clip = float(getattr(cfg, "grad_clip", 100.0))
    fuse = (bool(getattr(cfg, "fuse_caption_layers", True))
            and model.arch.share_caption_head)
    cap_levels = model.arch.cap_num_feature_levels
    cap_points = model.arch.cap_dec_n_points

    def to_device(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        dev = next(model.parameters()).device
        return {k: torch.as_tensor(v).to(dev, non_blocking=True)
                for k, v in batch.items()
                if isinstance(v, (np.ndarray, torch.Tensor))}

    def caption_query(out, layer, mq):
        query = gather_matched(out["hs"][layer], mq)
        if st.enable_pos_emb_for_captioner:
            query = torch.cat(
                [query, gather_matched(out["query_pos"], mq)], dim=-1)
        return query

    def forward_losses(batch) -> Dict[str, torch.Tensor]:
        db = to_device(batch)
        shapes = pyramid_shapes(db["video_feats"].shape[1],
                                len(st.temporal_shapes))
        out = model(db["video_feats"], db["video_mask"], db["duration"])
        losses, match_qs = compute_criterion(
            out, db["gt_boxes"], db["gt_labels"], db["gt_mask"], None, st.spec)
        if not st.caption_loss:
            return losses

        layers = [Ld - 1] if st.disable_mid_caption_heads else list(range(Ld))
        validf = db["gt_mask"].float()
        denom = validf.sum().clamp(min=1)
        common = (out["memory"], out["mask_flat"], shapes,
                  out["valid_ratios"])
        if fuse and len(layers) > 1:
            # one teacher-forcing pass for all layers: the shared head treats
            # events independently, so the layers fold into the event axis.
            # Layer references differ in width; their prepared form does not
            Lf = len(layers)
            query = torch.cat([caption_query(out, l, match_qs[l])
                               for l in layers], dim=1)        # (B, Lf*G, C)
            ref = torch.cat([prepare_dsa_reference(
                gather_matched(out["layer_refs"][l], match_qs[l]),
                out["valid_ratios"], shapes, cap_levels, cap_points)
                for l in layers], dim=1)
            nll = model.caption_train_nll(
                layers[-1], query, ref, *common,
                db["captions"].repeat(1, Lf, 1),
                db["caption_mask"].repeat(1, Lf, 1), ref_prepared=True)
            nll = nll.reshape(nll.shape[0], Lf, -1)
            per_layer = [nll[:, i] for i in range(Lf)]
        else:
            per_layer = [model.caption_train_nll(
                l, caption_query(out, l, match_qs[l]),
                gather_matched(out["layer_refs"][l], match_qs[l]), *common,
                db["captions"], db["caption_mask"]) for l in layers]
        for l, nll in zip(layers, per_layer):
            suffix = "" if l == Ld - 1 else f"_{l}"
            losses["loss_caption" + suffix] = (nll * validf).sum() / denom
        return losses

    def step(state: TrainState, batch: Dict[str, np.ndarray],
             weights: Dict[str, float], ss_prob: float = 0.0
             ) -> Dict[str, torch.Tensor]:
        if ss_prob > 0:
            raise NotImplementedError(
                "train step: scheduled sampling (ss_prob > 0) is not ported "
                "yet")
        if state.model is not model:
            raise ValueError("train step: the state holds another model")
        model.train()
        # the model's, not the optimizer's: in a freeze mode the optimizer
        # holds the head only, and the clip below counts every gradient
        model.zero_grad(set_to_none=True)
        losses = forward_losses(batch)
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        total.backward()
        clip_global_norm(model.parameters(), grad_clip)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total_loss"] = total.detach()
        return losses

    step.forward_losses = forward_losses
    return step
