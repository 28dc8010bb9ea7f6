"""Matching costs and detection losses over padded static shapes.

Port of gvl_tpu/train/criterion.py: matches are a dense (B, G) int64 array
`match_q` (the query assigned to each padded GT slot) and every loss masks
by `gt_mask`. 'loss_self_iou' and 'cardinality_error' are logged, not
weighted (they are not in `make_weight_dict`). The contrastive side is the
matcher's cosine cost (`cl_match_matrix`, gated by the contrastive weight's
schedule) and the InfoNCE `contrastive_loss`. SCST's many-to-one
assignment is `match_layer_m2o`, which `compute_criterion` runs beside the
one-to-one match with `rl_m2o_rate > 0`. The caption cost: given each
layer's caption NLL of every (query, GT) pair, `compute_criterion` adds it
to the matching cost and takes the caption loss from its matched entries.

Under data parallelism (gvl_tpu_torch.parallel) each rank holds a block of
the global batch's rows, and every loss here is the rank's exact share of
the loss JAX computes on the global batch: a sum over the rank's own rows
over a count of the global batch (`global_sum`); the contrastive loss
reads the other ranks' events and texts through `gather_rows`. The shares
of the ranks add up to the global loss, and their gradients, summed over
ranks, to its gradient. The matcher is per video and stays local. Without
a process group every helper is the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from gvl_tpu_torch.parallel import gather_rows, global_sum, row_block
from gvl_tpu_torch.train.lap import batched_lap
from gvl_tpu_torch.utils import boxes as box_ops

# Empirical ActivityNet event-count frequencies that down-weight common
# counts in the counter loss (data constant of gvl_tpu/train/criterion.py:41)
COUNTER_CLASS_RATE = (
    0.00000000e+00, 0.00000000e+00, 1.93425917e-01, 4.12129084e-01,
    1.88929963e-01, 7.81296833e-02, 5.09541413e-02, 3.12718553e-02,
    1.84833650e-02, 8.39244680e-03, 6.59406534e-03, 4.49595364e-03,
    2.19802178e-03, 1.79838146e-03, 5.99460486e-04, 4.99550405e-04,
    4.99550405e-04, 1.99820162e-04, 2.99730243e-04, 3.99640324e-04,
    2.99730243e-04, 0.00000000e+00, 1.99820162e-04, 0.00000000e+00,
    0.00000000e+00, 0.00000000e+00, 9.99100809e-05, 9.99100809e-05)


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Static loss/matcher hyperparameters (criterion.py:51-86)."""
    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    set_cost_cl: float = 0.0
    set_cost_caption: float = 0.0
    cost_alpha: float = 0.25
    cost_gamma: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    lloss_gau_mask: int = 1
    lloss_beta: float = 1.0
    temperature: float = 0.1
    enable_cross_video_cl: bool = True
    enable_e2t_cl: bool = False
    enable_bg_for_cl: bool = False
    matcher_impl: str = "jax"
    aux_loss: bool = True

    @classmethod
    def from_config(cls, cfg: Any) -> "LossSpec":
        d = cls()
        names = {"temperature": "contrastive_loss_temperature"}
        return cls(**{f.name: type(getattr(d, f.name))(
            getattr(cfg, names.get(f.name, f.name), getattr(d, f.name)))
            for f in dataclasses.fields(cls)})


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


# --------------------------------------------------------------------- cost

def cl_match_matrix(event_embed, text_embed, bg_embed=None) -> torch.Tensor:
    """Per-video cosine similarity of Nq events and G texts, (B, Nq, G), with
    a last column against the background embedding when one is given
    (criterion.py:91-105)."""
    e = _unit(event_embed)
    mat = torch.einsum("bqd,bgd->bqg", e, _unit(text_embed))
    if bg_embed is not None:
        bg_col = torch.einsum("bqd,d->bq", e, _unit(bg_embed)[0])
        mat = torch.cat([mat, bg_col[..., None]], dim=-1)
    return mat


def build_match_cost(pred_logits, pred_boxes, gt_boxes, gt_labels, gt_mask,
                     spec: LossSpec, cl_mat=None, cl_gate=1.0) -> torch.Tensor:
    """(B, Nq, G) matching cost; padded GT columns are constant 0
    (criterion.py:108-135). With cl_mat and set_cost_cl > 0 the negative
    cosine joins it, times cl_gate: the contrastive schedule's 0 or 1, so
    that the epochs with a contrastive weight of 0 match without it."""
    p = torch.sigmoid(pred_logits)                      # (B, Nq, K)
    a, g = spec.cost_alpha, spec.cost_gamma
    pos = a * ((1 - p) ** g) * (-torch.log(p + 1e-8))
    neg = (1 - a) * (p ** g) * (-torch.log(1 - p + 1e-8))
    labels = gt_labels.long().clamp(0, p.shape[-1] - 1)
    idx = labels[:, None, :].expand(-1, p.shape[1], -1)
    cost_class = torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)
    cost_bbox = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    cost_giou = -box_ops.pairwise_giou(box_ops.box_cl_to_xy(pred_boxes),
                                       box_ops.box_cl_to_xy(gt_boxes))
    C = (spec.set_cost_bbox * cost_bbox + spec.set_cost_class * cost_class
         + spec.set_cost_giou * cost_giou)
    if cl_mat is not None and spec.set_cost_cl > 0:
        G = gt_boxes.shape[1]
        C = C + (cl_gate * spec.set_cost_cl) * (-cl_mat[..., :G])
    return torch.where(gt_mask[:, None, :], C, torch.zeros_like(C))


@torch.no_grad()
def match_layer(cost: torch.Tensor, gt_mask: torch.Tensor,
                impl: str = "jax") -> torch.Tensor:
    """Solve the assignment; returns match_q (B, G) int64, 0 in padded slots
    (mask by gt_mask). Both `matcher_impl` values of the config, 'jax' and
    'scipy', give an optimal assignment and run the same solver here."""
    if impl not in ("jax", "scipy"):
        raise ValueError(f"unknown matcher_impl: {impl}")
    mq = batched_lap(cost, gt_mask)
    return torch.where(gt_mask, mq, torch.zeros_like(mq))


@torch.no_grad()
def match_layer_m2o(cost: torch.Tensor, gt_mask: torch.Tensor, rate: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Many-to-one assignment for SCST (criterion.py:154-179, reference
    matcher.py:125-128 `rl_indices`, m2o_rate 4): the GT columns are tiled
    `rate` times, so up to `rate` distinct queries match each GT. scipy's
    rectangular assignment matches min(Nq, rate*n) pairs; where rate*G >
    Nq, dummy rows that cost 1e6 on the valid columns make the real
    queries go first. Returns (match_q (B, rate*G) int64, the query of
    each slot, 0 where not valid; valid (B, rate*G) bool). Slot r*G + g is
    replica r of GT g. The replicas of one GT cost the same, so which of
    them a query lands in is a tie: compare per GT the set of its queries."""
    B, Nq, G = cost.shape
    C = rate * G
    cost_t = cost.repeat(1, 1, rate)                    # (B, Nq, rate*G)
    mask_t = gt_mask.repeat(1, rate)                    # (B, rate*G)
    if C > Nq:
        dummy = torch.where(mask_t[:, None, :], 1e6, 0.0).to(cost.dtype)
        cost_t = torch.cat([cost_t, dummy.expand(B, C - Nq, C)], dim=1)
    mq = batched_lap(cost_t, mask_t)                    # (B, C) col -> row
    valid = mask_t & (mq >= 0) & (mq < Nq)
    return torch.where(valid, mq, torch.zeros_like(mq)), valid


# -------------------------------------------------------------------- losses

def _bce_with_logits(logits, targets):
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss_sum(logits, targets, alpha, gamma, row_mask=None):
    p = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if row_mask is not None:
        loss = loss * row_mask[:, None, None]
    return loss.sum()


def labels_loss(pred_logits, gt_labels, gt_mask, match_q, num_boxes,
                spec: LossSpec, row_mask=None):
    """Focal classification loss over matched one-hots (criterion.py:195)."""
    B, Nq, K = pred_logits.shape
    labels = gt_labels.long().clamp(0, K - 1)
    # padded slots add 0 at their (arbitrary) query, real ones 1; setting
    # instead of adding would let a padded slot clear a real one
    onehot = pred_logits.new_zeros((B, Nq, K))
    b_idx = torch.arange(B, device=pred_logits.device)[:, None].expand_as(
        match_q)
    onehot.index_put_((b_idx, match_q, labels),
                      gt_mask.to(pred_logits.dtype), accumulate=True)
    return sigmoid_focal_loss_sum(pred_logits, onehot, spec.focal_alpha,
                                  spec.focal_gamma, row_mask) / num_boxes


def counter_loss(pred_count, gt_mask, spec: LossSpec, row_mask=None):
    """BCE against the one-hot event count with a Gaussian neighbourhood
    coefficient and empirical frequency weights (criterion.py:210-237)."""
    B, E1 = pred_count.shape
    target = gt_mask.sum(-1).clamp(max=E1 - 1)              # (B,)
    onehot = F.one_hot(target, E1).to(pred_count.dtype)
    weight = 1.0 - pred_count.new_tensor(COUNTER_CLASS_RATE[:E1])
    idx = torch.arange(E1, dtype=pred_count.dtype, device=pred_count.device)
    gmask = torch.exp(-(idx[None, :] - target[:, None].to(idx.dtype)) ** 2
                      / (2 * 2.0 ** 2))                     # sigma = 2
    if spec.lloss_gau_mask:
        coef = onehot + ((1 - gmask) ** spec.lloss_beta) * (1 - onehot)
    else:
        coef = torch.ones_like(onehot)
    per_row = (_bce_with_logits(pred_count, onehot) * weight[None, :]
               * coef).mean(1)
    if row_mask is not None:
        return (per_row * row_mask).sum() \
            / global_sum(row_mask.sum()).clamp(min=1)
    return per_row.sum() / global_sum(B)


def boxes_losses(pred_boxes, gt_boxes, gt_mask, match_q, num_boxes):
    """L1 + gIoU on matched pairs and the self-IoU overlap penalty
    (criterion.py:240-265)."""
    src = torch.gather(pred_boxes, 1, match_q[..., None].expand(-1, -1, 2))
    m = gt_mask.to(pred_boxes.dtype)
    l1 = ((src - gt_boxes).abs() * m[..., None]).sum() / num_boxes

    src_xy = box_ops.box_cl_to_xy(src)
    giou = box_ops.elementwise_giou(src_xy, box_ops.box_cl_to_xy(gt_boxes))
    loss_giou = ((1 - giou) * m).sum() / num_boxes

    # overlap among a video's matched predictions, normalised per video by
    # n*(n-1)/2 and summed over the batch (a rank's sum is its share)
    iou_pair, _ = box_ops.pairwise_iou(src_xy, src_xy)       # (B, G, G)
    G = gt_boxes.shape[1]
    upper = torch.triu(iou_pair.new_ones((G, G)), diagonal=1)[None]
    pair_mask = (m[:, :, None] * m[:, None, :]) * upper
    n = m.sum(-1)
    denom = (0.5 * n * (n - 1)).clamp(min=1e-6)
    self_iou = (iou_pair * pair_mask).sum((1, 2)) / denom
    self_iou = torch.where(n > 1, self_iou, torch.zeros_like(self_iou)).sum()
    return l1, loss_giou, self_iou


@torch.no_grad()
def cardinality_error(pred_logits, gt_mask, row_mask=None):
    """|#non-background-argmax - #gt|, a diagnostic without gradient."""
    card = (pred_logits.argmax(-1) != pred_logits.shape[-1] - 1).sum(-1)
    err = (card.float() - gt_mask.sum(-1).float()).abs()
    if row_mask is not None:
        return (err * row_mask).sum() / global_sum(row_mask.sum()).clamp(
            min=1)
    return err.sum() / global_sum(err.shape[0])


def _softmax_ce(logits, labels):
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, 1, labels[:, None])[:, 0])


def contrastive_loss(text_embed, event_embed, match_q, gt_mask,
                     spec: LossSpec, bg_embed=None, row_mask=None):
    """InfoNCE between matched (text, event) pairs (criterion.py:279-364).

    text_embed (B, G, D) padded; event_embed (B, Nq, D); match_q (B, G).
    Text to event: with enable_cross_video_cl every event of the batch is a
    negative and the mean runs over all valid sentences; without it only the
    video's own events are, and each video's mean weighs the same. With
    enable_e2t_cl the event-to-text direction is averaged in: each event
    against every valid text and the background embedding, an unmatched
    event labelled background; enable_bg_for_cl averages it over all events,
    otherwise over the matched ones. row_mask (B,) drops padded videos: their
    events leave the negative pool (matched columns stay) and the per-video
    means divide by the real rows.

    Under data parallelism the batch is the global one: this rank's texts
    against every rank's events, and this rank's events against every
    rank's texts (`gather_rows`, rank order), each direction summed over
    this rank's rows and divided by the global count: the rank's share."""
    B, G, D = text_embed.shape
    Nq = event_embed.shape[1]
    dev = text_embed.device
    ev_all = gather_rows(event_embed)                    # (Bg, Nq, D)
    Bg = ev_all.shape[0]
    off = row_block(Bg).start                            # this rank's first row
    tf = _unit(text_embed).reshape(B * G, D)
    logits = (tf @ _unit(ev_all).reshape(Bg * Nq, D).T) \
        / spec.temperature                               # (BG, BgNq)

    valid = gt_mask.reshape(B * G)
    labels = ((off + torch.arange(B, device=dev))[:, None] * Nq
              + match_q).reshape(-1)                     # global event index
    cols = torch.arange(Bg * Nq, device=dev)
    n_rows = float(global_sum(B))
    if row_mask is not None:
        row_mask = row_mask.float()
        n_rows = global_sum(row_mask.sum()).clamp(min=1.0)
        ev_row = gather_rows(row_mask).bool().repeat_interleave(Nq)
        keep = ev_row[None, :] | (cols[None, :] == labels[:, None])
        logits = torch.where(keep, logits, -1e9)
    if not spec.enable_cross_video_cl:
        rows = torch.arange(B * G, device=dev)
        own = (cols[None, :] // Nq) == (off + rows[:, None] // G)
        logits = torch.where(own, logits, -1e9)

    t2e_all = _softmax_ce(logits, labels)
    validf = valid.float()
    if spec.enable_cross_video_cl:
        t2e = (t2e_all * validf).sum() / global_sum(validf.sum()).clamp(min=1)
    else:
        m = gt_mask.float()
        per_video = ((t2e_all.reshape(B, G) * m).sum(-1)
                     / m.sum(-1).clamp(min=1))
        t2e = per_video.sum() / n_rows
    if not spec.enable_e2t_cl:
        return t2e

    # this rank's events against every valid text of the global batch
    ef = _unit(event_embed).reshape(B * Nq, D)
    valid_all = gather_rows(gt_mask).reshape(Bg * G)
    labels_all = gather_rows(labels)
    logits = (_unit(gather_rows(text_embed)).reshape(Bg * G, D) @ ef.T) \
        / spec.temperature                               # (BgG, BNq)
    own_cols = off * Nq + torch.arange(B * Nq, device=dev)
    if row_mask is not None:
        keep = row_mask.bool().repeat_interleave(Nq)[None, :] | (
            own_cols[None, :] == labels_all[:, None])
        logits = torch.where(keep, logits, -1e9)
    if not spec.enable_cross_video_cl:
        rows = torch.arange(Bg * G, device=dev)
        own = (own_cols[None, :] // Nq) == (rows[:, None] // G)
        logits = torch.where(own, logits, -1e9)
    bg_logits = (ef @ _unit(bg_embed)[0]) / spec.temperature     # (BNq,)
    col = torch.where(valid_all[:, None], logits, -1e9)
    e2t_logits = torch.cat([col, bg_logits[None, :]], dim=0)     # (BgG+1, BNq)
    e_labels = torch.full((B * Nq,), Bg * G, dtype=torch.long, device=dev)
    mine = valid_all & (labels_all >= off * Nq) & (labels_all < (off + B) * Nq)
    e_labels[labels_all[mine] - off * Nq] = torch.arange(Bg * G,
                                                         device=dev)[mine]
    matched = (e_labels != Bg * G).float()
    e2t_all = _softmax_ce(e2t_logits.T, e_labels)
    if spec.enable_bg_for_cl:
        if row_mask is not None:
            ev_rowf = row_mask.repeat_interleave(Nq)
            e2t = (e2t_all * ev_rowf).sum() \
                / global_sum(ev_rowf.sum()).clamp(min=1)
        else:
            e2t = e2t_all.sum() / global_sum(B * Nq)
    elif spec.enable_cross_video_cl:
        e2t = (e2t_all * matched).sum() / global_sum(matched.sum()).clamp(min=1)
    else:
        m = matched.reshape(B, Nq)
        per_v = (e2t_all.reshape(B, Nq) * m).sum(-1) / (1e-5 + m.sum(-1))
        e2t = per_v.sum() / n_rows
    return 0.5 * (t2e + e2t)


# ----------------------------------------------------------------- criterion

def compute_criterion(outputs: Dict, gt_boxes, gt_labels, gt_mask,
                      text_embeds_per_layer, spec: LossSpec,
                      cap_costs=None, row_mask: Optional[torch.Tensor] = None,
                      cl_gate=1.0, rl_m2o_rate: int = 0,
                      rl_matches: Optional[list] = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Match, then the detection losses of every decoder layer and, with
    text_embeds_per_layer (a (B, G, Dcl) text embedding per decoder layer),
    its contrastive cost and loss (criterion.py:367-477). All layers' costs
    are stacked into one matcher call, so a step pays one device-to-host
    copy. Returns (losses, match_qs (Ld, B, G)); the last layer's keys are
    unsuffixed, the others end in '_<i>'. row_mask (B,) bool drops whole
    videos from every term; cl_gate scales the contrastive cost
    (`build_match_cost`). With rl_m2o_rate > 0 the same stacked costs also
    go through `match_layer_m2o`, and one (match_q, valid) pair per layer
    is appended to the list rl_matches (criterion.py:428-438).

    cap_costs: one (B, Nq, G) caption NLL of every (query, GT) pair per
    layer, or None. It joins the matching cost, weighted by
    spec.set_cost_caption, at the valid GT slots and without gradient, and
    its matched entries become 'loss_caption': the mean over each video's
    valid GTs, then over the videos that have one (criterion.py:419-450)."""
    contrastive = text_embeds_per_layer is not None
    if contrastive and "event_embed" not in outputs:
        raise ValueError("compute_criterion: text embeddings given, but the "
                         "outputs have no event_embed (enable_contrastive "
                         "is off)")
    Ld, B = outputs["pred_logits"].shape[:2]
    row_maskf = None
    if row_mask is not None:
        row_maskf = row_mask.float()
        gt_mask = gt_mask & row_mask[:, None]
    num_boxes = global_sum(gt_mask.sum().float()).clamp(min=1.0)

    with torch.no_grad():
        costs = [build_match_cost(outputs["pred_logits"][l],
                                  outputs["pred_boxes"][l], gt_boxes,
                                  gt_labels, gt_mask, spec,
                                  cl_match_matrix(outputs["event_embed"][l],
                                                  text_embeds_per_layer[l])
                                  if contrastive else None, cl_gate)
                 for l in range(Ld)]
        if cap_costs is not None and spec.set_cost_caption > 0:
            costs = [c + spec.set_cost_caption * torch.where(
                gt_mask[:, None, :], cap, torch.zeros_like(cap))
                for c, cap in zip(costs, cap_costs)]
        cost_all = torch.cat(costs)
        mask_all = gt_mask.repeat(Ld, 1)
        match_qs = match_layer(cost_all, mask_all,
                               spec.matcher_impl).reshape(Ld, B, -1)
        if rl_m2o_rate > 0 and rl_matches is not None:
            mq_rl, valid_rl = match_layer_m2o(cost_all, mask_all, rl_m2o_rate)
            rl_matches.extend((mq_rl[l * B:(l + 1) * B],
                               valid_rl[l * B:(l + 1) * B])
                              for l in range(Ld))

    losses: Dict[str, torch.Tensor] = {}
    gtf = gt_mask.float()
    has_any = gt_mask.any(-1).float()
    for l in range(Ld):
        logits = outputs["pred_logits"][l]
        suffix = "" if l == Ld - 1 else f"_{l}"
        if cap_costs is not None:
            matched = torch.gather(cap_costs[l], 1,
                                   match_qs[l][:, None, :])[:, 0]   # (B, G)
            per_video = (matched * gtf).sum(-1) / gtf.sum(-1).clamp(min=1)
            losses["loss_caption" + suffix] = (per_video * has_any).sum() \
                / global_sum(has_any.sum()).clamp(min=1)
        losses["loss_ce" + suffix] = labels_loss(
            logits, gt_labels, gt_mask, match_qs[l], num_boxes, spec,
            row_maskf)
        losses["loss_counter" + suffix] = counter_loss(
            outputs["pred_count"][l], gt_mask, spec, row_maskf)
        l1, giou, self_iou = boxes_losses(outputs["pred_boxes"][l], gt_boxes,
                                          gt_mask, match_qs[l], num_boxes)
        losses["loss_bbox" + suffix] = l1
        losses["loss_giou" + suffix] = giou
        losses["loss_self_iou" + suffix] = self_iou
        losses["cardinality_error" + suffix] = cardinality_error(
            logits, gt_mask, row_maskf)
        if contrastive:
            losses["contrastive_loss" + suffix] = contrastive_loss(
                text_embeds_per_layer[l], outputs["event_embed"][l],
                match_qs[l], gt_mask, spec, outputs.get("background_embed"),
                row_maskf)
    return losses, match_qs


def make_weight_dict(cfg: Any) -> Dict[str, float]:
    """Loss name -> weight, with a copy per auxiliary layer
    (criterion.py:480-493)."""
    base = {"loss_ce": cfg.cls_loss_coef,
            "loss_bbox": cfg.bbox_loss_coef,
            "loss_giou": cfg.giou_loss_coef,
            "loss_counter": cfg.count_loss_coef,
            "loss_caption": cfg.caption_loss_coef,
            "contrastive_loss": getattr(cfg, "contrastive_loss_start_coef",
                                        0.0)}
    out = dict(base)
    if getattr(cfg, "aux_loss", True):
        for i in range(cfg.dec_layers - 1):
            out.update({f"{k}_{i}": v for k, v in base.items()})
    return out


def cl_weight_at_epoch(cfg: Any, epoch: int) -> float:
    """The contrastive weight's piecewise-constant schedule: the value of the
    last scheduled epoch <= epoch, 0 before the first (criterion.py:
    494-505)."""
    w = 0.0
    for t, v in zip(list(cfg.cl_schedule_time), list(cfg.cl_schedule_val)):
        if epoch >= t:
            w = v
    return w
