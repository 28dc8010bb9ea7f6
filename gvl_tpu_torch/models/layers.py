"""Shared building blocks: MLP heads, the flax initializers the JAX package
uses, and the deformable-attention module wrapping gvl_tpu_torch.ops.

Port of gvl_tpu/models/layers.py. Parameter names follow the reference PDVC
state_dict (pdvc/ops/modules/ms_deform_attn.py, pdvc/pdvc.py:1166-1178).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.ops import (ms_deform_attn_1d, ms_deform_attn_1d_banded,
                               ms_deform_attn_1d_banded_ref,
                               ms_deform_attn_1d_ref)
from gvl_tpu_torch.ops.ms_deform_attn import level_tensor

# ---------------------------------------------------------------------------
# flax's initializers, drawn from an explicit generator
# ---------------------------------------------------------------------------


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default Dense kernel init (variance_scaling(1, fan_in,
    truncated_normal)) for a torch (out, in, ...) weight."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def flax_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Every Linear gets flax's Dense defaults (lecun-normal kernel, zero
    bias), every LayerNorm/GroupNorm unit scale and zero bias. Modules with
    other inits override them in their `flax_init_`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise `module` with the JAX package's distributions: the flax
    defaults, then each submodule's own `flax_init_`."""
    flax_default_init_(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "flax_init_"):
                m.flax_init_(generator)


def xavier_uniform_linear_(lin: nn.Linear, generator: torch.Generator) -> None:
    nn.init.xavier_uniform_(lin.weight, generator=generator)
    if lin.bias is not None:
        lin.bias.zero_()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """ReLU MLP with `num_layers` Linear layers, the last one un-activated.
    Port of layers.py:20-38; the final-layer init is set by the owner."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, device=None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o, device=device) for i, o in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def _directional_offset_bias(n_heads: int, n_levels: int, n_points: int,
                             device=None) -> torch.Tensor:
    """Initial sampling-offset biases: heads alternate +-1 direction, points
    step outward x(p+1). Port of layers.py:41-52."""
    thetas = torch.arange(n_heads, dtype=torch.float32,
                          device=device) * (2.0 * math.pi / n_heads)
    grid = torch.stack([torch.cos(thetas), torch.sin(thetas)], -1)
    grid = grid / grid.abs().max(dim=-1, keepdim=True).values
    dirs = grid[:, 0]                                             # (H,)
    bias = dirs[:, None, None].expand(n_heads, n_levels, n_points)
    bias = bias * (torch.arange(n_points, dtype=torch.float32,
                                device=device) + 1.0)
    return bias.reshape(-1)


class MSDeformAttn1D(nn.Module):
    """Multi-scale deformable attention over a flattened temporal pyramid.
    Port of layers.py:55-165 without the sequence-parallel route.

    query            (B, Lq, C)
    reference_points (B, Lq, L, 1) or (B, Lq, L, 2) (center [, length])
    memory           (B, S, C) flattened levels
    memory_mask      (B, S) bool, True = valid
    Returns (B, Lq, C).

    Long-sequence self-attention (one query per memory token, S >= 512,
    band_margin > 0) runs `ms_deform_attn_1d_banded`, whose taps beyond the
    margin clamp to the band's edge; everything else `ms_deform_attn_1d`.
    Either is the CUDA kernel on a CUDA tensor and its plain version on a CPU
    tensor. Only `set_msda_impl`, which compares the two on the card, points
    the module at the plain versions.
    """

    impl = "kernel"

    def __init__(self, d_model: int, n_levels: int = 4, n_heads: int = 8,
                 n_points: int = 4, band_margin: int = 32, device=None):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.band_margin = band_margin
        hlp = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, hlp, device=device)
        self.attention_weights = nn.Linear(d_model, hlp, device=device)
        self.value_proj = nn.Linear(d_model, d_model, device=device)
        self.output_proj = nn.Linear(d_model, d_model, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(_directional_offset_bias(
            self.n_heads, self.n_levels, self.n_points))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()
        xavier_uniform_linear_(self.value_proj, generator)
        xavier_uniform_linear_(self.output_proj, generator)

    def forward(self, query, reference_points, memory, memory_mask,
                temporal_shapes: Sequence[int]):
        B, Lq, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        Dh = self.d_model // H
        shapes = tuple(int(t) for t in temporal_shapes)
        S = sum(shapes)
        value = self.value_proj(memory)
        if memory_mask is not None:
            value = value.masked_fill(~memory_mask[..., None], 0.0)
        value = value.reshape(B, -1, H, Dh)

        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P)
        attn = self.attention_weights(query).reshape(B, Lq, H, L * P)
        attn = torch.softmax(attn, dim=-1).reshape(B, Lq, H, L, P)

        if reference_points.shape[-1] == 1:
            t = level_tensor(shapes, offsets)
            loc = (reference_points[:, :, None, :, None, 0]
                   + offsets / t[None, None, None, :, None])
        elif reference_points.shape[-1] == 2:
            loc = (reference_points[:, :, None, :, None, 0]
                   + offsets / P * reference_points[:, :, None, :, None, 1] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 1 or 2")

        loc, attn = loc.contiguous(), attn.contiguous()
        kernel = self.impl == "kernel"
        if Lq == S and S >= 512 and self.band_margin > 0:
            op = ms_deform_attn_1d_banded if kernel else ms_deform_attn_1d_banded_ref
            out = op(value, shapes, loc, attn, margin=self.band_margin)
        else:
            op = ms_deform_attn_1d if kernel else ms_deform_attn_1d_ref
            out = op(value, shapes, loc, attn)
        return self.output_proj(out)


def set_msda_impl(module: nn.Module, impl: str) -> None:
    """Point every MSDeformAttn1D under `module` at 'kernel' or at 'ref',
    the plain version; for comparing the two paths on the card."""
    if impl not in ("kernel", "ref"):
        raise ValueError(f"unknown msda impl: {impl}")
    for m in module.modules():
        if isinstance(m, MSDeformAttn1D):
            m.impl = impl
