"""Matching costs and detection losses over padded static shapes.

Port of gvl_tpu/train/criterion.py without the contrastive (text) side:
matches are a dense (B, G) int64 array `match_q` (the query assigned to each
padded GT slot) and every loss masks by `gt_mask`. 'loss_self_iou' and
'cardinality_error' are logged, not weighted (they are not in
`make_weight_dict`). Not ported yet, raising NotImplementedError by name:
`cl_match_matrix` / `contrastive_loss` (text side), the caption cost
(`set_cost_caption > 0`), `match_layer_m2o` (SCST).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    matcher_impl: str = "jax"
    aux_loss: bool = True

    @classmethod
    def from_config(cls, cfg: Any) -> "LossSpec":
        d = cls()
        return cls(**{f.name: type(getattr(d, f.name))(
            getattr(cfg, f.name, getattr(d, f.name)))
            for f in dataclasses.fields(cls)})


def _not_ported(name: str, what: str):
    raise NotImplementedError(f"{name}: {what} is not ported yet "
                              "(ROADMAP Queue 1)")


def cl_match_matrix(*args, **kwargs):
    _not_ported("cl_match_matrix", "the contrastive text side")


def contrastive_loss(*args, **kwargs):
    _not_ported("contrastive_loss", "the contrastive text side")


def match_layer_m2o(*args, **kwargs):
    _not_ported("match_layer_m2o", "the many-to-one SCST assignment")


# --------------------------------------------------------------------- cost

def build_match_cost(pred_logits, pred_boxes, gt_boxes, gt_labels, gt_mask,
                     spec: LossSpec) -> torch.Tensor:
    """(B, Nq, G) matching cost; padded GT columns are constant 0
    (criterion.py:108-135, without the contrastive term)."""
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
        return (per_row * row_mask).sum() / row_mask.sum().clamp(min=1)
    return per_row.mean()


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
    # n*(n-1)/2 and summed over the batch
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
        return (err * row_mask).sum() / row_mask.sum().clamp(min=1)
    return err.mean()


# ----------------------------------------------------------------- criterion

def compute_criterion(outputs: Dict, gt_boxes, gt_labels, gt_mask,
                      text_embeds_per_layer, spec: LossSpec,
                      cap_costs=None, row_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Match, then the detection losses of every decoder layer
    (criterion.py:374-477). All layers' costs are stacked into one matcher
    call, so a step pays one device-to-host copy. Returns (losses,
    match_qs (Ld, B, G)); the last layer's keys are unsuffixed, the others
    end in '_<i>'. row_mask (B,) bool drops whole videos from every term."""
    if text_embeds_per_layer is not None:
        _not_ported("compute_criterion", "the contrastive text side")
    if cap_costs is not None or spec.set_cost_caption > 0:
        _not_ported("compute_criterion",
                    "the caption cost (cap_costs, set_cost_caption > 0)")
    Ld, B = outputs["pred_logits"].shape[:2]
    row_maskf = None
    if row_mask is not None:
        row_maskf = row_mask.float()
        gt_mask = gt_mask & row_mask[:, None]
    num_boxes = gt_mask.sum().float().clamp(min=1.0)

    with torch.no_grad():
        cost_all = torch.cat([
            build_match_cost(outputs["pred_logits"][l],
                             outputs["pred_boxes"][l], gt_boxes, gt_labels,
                             gt_mask, spec) for l in range(Ld)])
        match_qs = match_layer(cost_all, gt_mask.repeat(Ld, 1),
                               spec.matcher_impl).reshape(Ld, B, -1)

    losses: Dict[str, torch.Tensor] = {}
    for l in range(Ld):
        logits = outputs["pred_logits"][l]
        suffix = "" if l == Ld - 1 else f"_{l}"
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
