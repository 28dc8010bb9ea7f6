"""Temporal multi-scale pyramid + positional encoding.

Port of gvl_tpu/models/base_encoder.py. Public functions keep the JAX
package's (B, T, C) layout; the convolutions run in torch's (B, C, T).
Parameter names follow the reference pdvc/base_encoder.py and
pdvc/position_encoding.py.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
from torch import nn


class SineDurationPositionEncoding(nn.Module):
    """pos = [sine(cum-position, num_pos_feats) ; Linear(binary duration<=i)].
    Port of base_encoder.py:22-54."""

    def __init__(self, num_pos_feats: int, duration_feats: int,
                 temperature: float = 10000.0, max_duration: int = 256,
                 device=None):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.max_duration = max_duration
        self.duration_embed_layer = nn.Linear(max_duration, duration_feats,
                                              device=device)

    def forward(self, valid_mask: torch.Tensor, duration: torch.Tensor):
        # valid_mask (B, T) bool; duration (B,) float seconds
        B, T = valid_mask.shape
        x_embed = torch.cumsum(valid_mask.float(), dim=1)
        x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + 1e-6) * (2 * math.pi)

        i = torch.arange(self.num_pos_feats, dtype=torch.float32,
                         device=valid_mask.device)
        dim_t = self.temperature ** (2 * torch.floor(i / 2) / self.num_pos_feats)
        pos = x_embed[:, :, None] / dim_t                           # (B, T, F)
        pos = torch.stack([torch.sin(pos[:, :, 0::2]),
                           torch.cos(pos[:, :, 1::2])], dim=3).reshape(B, T, -1)

        steps = torch.arange(self.max_duration, device=duration.device)
        dur_onehot = (steps[None, :] < duration.to(torch.int32)[:, None]).float()
        dur = self.duration_embed_layer(dur_onehot)
        dur = dur[:, None, :].expand(B, T, dur.shape[-1])
        return torch.cat([pos, dur], dim=2)                         # (B, T, C)


def nearest_downsample_mask(mask: torch.Tensor, new_len: int) -> torch.Tensor:
    """(B, T) bool -> (B, new_len) with F.interpolate(mode='nearest')'s index
    rule src = floor(dst * T / new_len). Port of base_encoder.py:57-62."""
    T = mask.shape[1]
    idx = torch.floor(torch.arange(new_len, device=mask.device)
                      * (T / new_len)).long()
    return mask[:, idx]


class BasePyramidEncoder(nn.Module):
    """Raw features -> L-level temporal pyramid of (features, mask, pos).

    Level 0: pointwise Conv + GroupNorm(32). Level l >= 1: k=3 s=2 Conv
    (+ GroupNorm) of the raw features (l=1) or of the previous level (l>=2).
    Port of base_encoder.py:65-100.
    """

    def __init__(self, num_feature_levels: int, hidden_dim: int,
                 feature_dim: int, device=None):
        super().__init__()
        self.num_feature_levels = num_feature_levels
        self.pos_embed = SineDurationPositionEncoding(
            hidden_dim // 2, hidden_dim - hidden_dim // 2, device=device)

        def proj(in_dim, kernel, stride):
            return nn.Sequential(
                nn.Conv1d(in_dim, hidden_dim, kernel, stride, kernel // 2,
                          device=device),
                nn.GroupNorm(32, hidden_dim, eps=1e-5, device=device))

        self.input_proj = nn.ModuleList(
            [proj(feature_dim, 1, 1)]
            + [proj(feature_dim if l == 1 else hidden_dim, 3, 2)
               for l in range(1, num_feature_levels)])

    def flax_init_(self, generator: torch.Generator) -> None:
        for seq in self.input_proj:
            nn.init.xavier_uniform_(seq[0].weight, generator=generator)
            seq[0].bias.zero_()

    def forward(self, feats: torch.Tensor, valid_mask: torch.Tensor,
                duration: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           List[torch.Tensor]]:
        # feats (B, T, D); valid_mask (B, T) bool; duration (B,)
        x = feats.transpose(1, 2)                                   # (B, D, T)
        srcs_ct = [self.input_proj[0](x)]
        masks = [valid_mask]
        poses = [self.pos_embed(valid_mask, duration)]
        for l in range(1, self.num_feature_levels):
            src = self.input_proj[l](x if l == 1 else srcs_ct[-1])
            m = nearest_downsample_mask(valid_mask, src.shape[2])
            srcs_ct.append(src)
            masks.append(m)
            poses.append(self.pos_embed(m, duration))
        return [s.transpose(1, 2) for s in srcs_ct], masks, poses
