"""1-D temporal box utilities. Port of the eval-side half of
gvl_tpu/utils/boxes.py; boxes are (center, length) or (start, end)."""

from __future__ import annotations

import torch


def box_cl_to_xy(x: torch.Tensor) -> torch.Tensor:
    """(..., 2) center/length -> start/end."""
    c, l = x[..., 0], x[..., 1]
    return torch.stack([c - 0.5 * l, c + 0.5 * l], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Numerically clamped logit."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))
