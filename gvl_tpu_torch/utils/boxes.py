"""1-D temporal box utilities. Port of gvl_tpu/utils/boxes.py; boxes are
(center, length), the model's format, or (start, end), the IoU math's."""

from __future__ import annotations

import torch


def box_cl_to_xy(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) center/length -> start/end."""
    c, l = x[..., 0], x[..., 1]
    return torch.stack([c - 0.5 * l, c + 0.5 * l], dim=-1)


def box_xy_to_cl(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) start/end -> center/length."""
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([(x0 + x1) / 2, x1 - x0], dim=-1)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """IoU between all pairs: boxes1 (..., N, 2), boxes2 (..., M, 2),
    start/end. Returns (iou, union), each (..., N, M)."""
    area1 = boxes1[..., 1] - boxes1[..., 0]
    area2 = boxes2[..., 1] - boxes2[..., 0]
    lt = torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    rb = torch.minimum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    inter = (rb - lt).clamp(min=0.0)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + 1e-5), union


def pairwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU between all pairs, start/end, (..., N, M)."""
    iou, union = pairwise_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    rb = torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    area = (rb - lt).clamp(min=0.0)
    return iou - (area - union) / (area + 1e-5)


def elementwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between aligned boxes, start/end, shape (...,)."""
    lt = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    rb = torch.minimum(boxes1[..., 1], boxes2[..., 1])
    inter = (rb - lt).clamp(min=0.0)
    union = ((boxes1[..., 1] - boxes1[..., 0])
             + (boxes2[..., 1] - boxes2[..., 0]) - inter)
    return inter / (union + 1e-5)


def elementwise_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU between aligned boxes, start/end, shape (...,)."""
    lt = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    rb = torch.minimum(boxes1[..., 1], boxes2[..., 1])
    inter = (rb - lt).clamp(min=0.0)
    union = ((boxes1[..., 1] - boxes1[..., 0])
             + (boxes2[..., 1] - boxes2[..., 0]) - inter)
    iou = inter / (union + 1e-5)
    area = (torch.maximum(boxes1[..., 1], boxes2[..., 1])
            - torch.minimum(boxes1[..., 0], boxes2[..., 0])).clamp(min=0.0)
    return iou - (area - union) / (area + 1e-5)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
