"""Deformable transformer encoder/decoder over the temporal pyramid.

Port of gvl_tpu/models/transformer.py, with the two-stage proposal
embedding (`proposal_pos_embed`; `pos_trans` / `pos_trans_norm` on the
DeformableTransformer of a two-stage model). Dropout sits where the JAX
modules have it and is live under `.train()` only. With `remat` (the config's remat_trunk,
transformer.py:128-139, gvl.py:209-214) each encoder and decoder layer runs
under `torch.utils.checkpoint` (`run_layer`): its activations are recomputed
in the backward instead of stored, with the random state of the forward, so
dropout draws the same masks. As in the JAX package, the decoder loop
and box refinement live in the top-level model (gvl.py); here the decoder is
only the container of its layers, so that parameter names follow the
reference pdvc/deformable_transformer.py state_dict
(`transformer.encoder.layers.{i}.*`, `transformer.decoder.layers.{i}.*`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gvl_tpu_torch.models.layers import MSDeformAttn1D, lecun_normal_


def run_layer(layer: nn.Module, remat: bool, *args):
    """layer(*args); with `remat` and autograd recording, under a
    checkpoint that recomputes the layer in the backward (nn.remat's role)
    and restores the forward's random state for its dropout draws."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def pyramid_shapes(T: int, num_levels: int):
    """Static per-level lengths of the stride-2 pyramid for frame count T."""
    shapes = [int(T)]
    for _ in range(1, num_levels):
        shapes.append((shapes[-1] + 1) // 2)
    return tuple(shapes)


def flatten_levels(srcs, masks, poses, level_embed):
    """Concatenate pyramid levels into one (B, S, C) sequence. Returns
    (src_flat, mask_flat, pos_flat, temporal_shapes, valid_ratios)."""
    temporal_shapes = tuple(int(s.shape[1]) for s in srcs)
    src_flat = torch.cat(srcs, dim=1)
    mask_flat = torch.cat(masks, dim=1)
    pos_flat = torch.cat(
        [p + level_embed[l][None, None, :] for l, p in enumerate(poses)], dim=1)
    valid_ratios = torch.stack(
        [m.float().sum(1) / m.shape[1] for m in masks], dim=1)
    return src_flat, mask_flat, pos_flat, temporal_shapes, valid_ratios


def encoder_reference_points(temporal_shapes: Sequence[int],
                             valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-position normalized reference coordinate, per level: (B, S, L, 1)."""
    refs = []
    for lvl, T in enumerate(temporal_shapes):
        r = (torch.arange(T, dtype=torch.float32,
                          device=valid_ratios.device) + 0.5)[None, :]
        refs.append(r / (valid_ratios[:, None, lvl] * T))          # (B, T)
    ref = torch.cat(refs, dim=1)                                   # (B, S)
    ref = ref[:, :, None] * valid_ratios[:, None, :]               # (B, S, L)
    return ref[:, :, :, None]


def expand_reference_for_levels(reference_points: torch.Tensor,
                                valid_ratios: torch.Tensor) -> torch.Tensor:
    """(B, Nq, 1|2) -> (B, Nq, L, 1|2) scaled by per-level valid ratios."""
    if reference_points.shape[-1] == 2:
        vr = torch.stack([valid_ratios, valid_ratios], -1)         # (B, L, 2)
        return reference_points[:, :, None, :] * vr[:, None, :, :]
    return reference_points[:, :, None, :] * valid_ratios[:, None, :, None]


def proposal_pos_embed(boxes_logit: torch.Tensor, num_pos_feats: int = 256,
                       temperature: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of (center, length) proposals given before the
    sigmoid (transformer.py:65-78): (B, N, 2) -> (B, N, 2 * num_pos_feats)."""
    i = torch.arange(num_pos_feats, dtype=torch.float32,
                     device=boxes_logit.device)
    dim_t = temperature ** (2 * torch.floor(i / 2) / num_pos_feats)
    pos = (torch.sigmoid(boxes_logit) * (2 * math.pi))[..., None] / dim_t
    pos = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      dim=-1)
    return pos.reshape(pos.shape[0], pos.shape[1], -1)


class FFN(nn.Module):
    """linear1 -> ReLU -> linear2, residual, LayerNorm (`forward_ffn`).

    A base class, not a submodule, so that its parameters sit directly on the
    layer as in the reference state_dict; the norm is `norm2` in encoder
    layers and `norm3` in decoder layers."""

    def __init__(self, d_model: int, d_ffn: int, norm_name: str,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn, device=device)
        self.linear2 = nn.Linear(d_ffn, d_model, device=device)
        self._ffn_norm = norm_name
        setattr(self, norm_name, nn.LayerNorm(d_model, eps=1e-5, device=device))
        self.dropout = nn.Dropout(dropout)

    def forward_ffn(self, x):
        h = self.dropout(F.relu(self.linear1(x)))
        h = self.dropout(self.linear2(h))
        return getattr(self, self._ffn_norm)(x + h)


class DeformableEncoderLayer(FFN):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, band_margin: int = 32, dropout: float = 0.1,
                 device=None):
        super().__init__(d_model, d_ffn, "norm2", dropout, device=device)
        self.self_attn = MSDeformAttn1D(d_model, n_levels, n_heads, n_points,
                                        band_margin=band_margin, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, src, pos, reference_points, mask_flat, temporal_shapes):
        h = self.self_attn(src + pos, reference_points, src, mask_flat,
                           temporal_shapes)
        return self.forward_ffn(self.norm1(src + self.dropout(h)))


class DeformableEncoder(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, num_layers: int,
                 n_levels: int, n_heads: int, n_points: int,
                 band_margin: int = 32, dropout: float = 0.1,
                 remat: bool = False, device=None):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            DeformableEncoderLayer(d_model, d_ffn, n_levels, n_heads, n_points,
                                   band_margin, dropout, device=device)
            for _ in range(num_layers))

    def forward(self, src, pos, mask_flat, temporal_shapes, valid_ratios):
        ref = encoder_reference_points(temporal_shapes, valid_ratios)
        out = src
        for layer in self.layers:
            out = run_layer(layer, self.remat, out, pos, ref, mask_flat,
                            temporal_shapes)
        return out


class MultiheadSelfAttention(nn.Module):
    """Multi-head dot-product attention with nn.MultiheadAttention's
    parameter names (in_proj_weight (3C, C), in_proj_bias, out_proj) and
    flax MultiHeadDotProductAttention's math: q scaled by 1/sqrt(Dh), masked
    keys set to the dtype's minimum before the softmax, dropout on the
    attention weights."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.attn_dropout = nn.Dropout(dropout)
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * d_model, d_model, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d_model, device=device))
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.in_proj_weight, generator)
        self.in_proj_bias.zero_()

    def forward(self, q_in, k_in, v_in, key_mask: Optional[torch.Tensor] = None):
        B, Nq, C = q_in.shape
        H = self.n_heads
        Dh = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q_in, wq, bq).reshape(B, Nq, H, Dh) / math.sqrt(Dh)
        k = F.linear(k_in, wk, bk).reshape(B, -1, H, Dh)
        v = F.linear(v_in, wv, bv).reshape(B, -1, H, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        w = self.attn_dropout(torch.softmax(logits, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Nq, C)
        return self.out_proj(out)


class DeformableDecoderLayer(FFN):
    def __init__(self, d_model: int, d_ffn: int, n_levels: int, n_heads: int,
                 n_points: int, dropout: float = 0.1, device=None):
        super().__init__(d_model, d_ffn, "norm3", dropout, device=device)
        self.self_attn = MultiheadSelfAttention(d_model, n_heads, dropout,
                                                device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5, device=device)
        self.cross_attn = MSDeformAttn1D(d_model, n_levels, n_heads, n_points,
                                         device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, tgt, query_pos, reference_points_input, memory,
                mask_flat, temporal_shapes, query_mask):
        q = tgt + query_pos
        h = self.self_attn(q, q, tgt, query_mask)
        tgt = self.norm2(tgt + self.dropout(h))
        h = self.cross_attn(tgt + query_pos, reference_points_input, memory,
                            mask_flat, temporal_shapes)
        return self.forward_ffn(self.norm1(tgt + self.dropout(h)))


class DeformableDecoder(nn.Module):
    """The decoder layers; GVLModel runs the loop with box refinement."""

    def __init__(self, layers: Sequence[DeformableDecoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    """Parameter container with the reference's `transformer.*` names:
    level_embed, encoder, decoder, and the query-mode reference-point head
    or, with two_stage (gt_proposals queries), the proposal embedding's
    `pos_trans` and `pos_trans_norm` instead: the JAX package creates each
    only in the mode that calls it (gvl.py:228-231, loop.py:73-74)."""

    def __init__(self, d_model: int, d_ffn: int, enc_layers: int,
                 dec_layers: int, n_levels: int, n_heads: int,
                 enc_n_points: int, dec_n_points: int,
                 band_margin: int = 32, dropout: float = 0.1,
                 remat: bool = False, two_stage: bool = False, device=None):
        super().__init__()
        self.level_embed = nn.Parameter(
            torch.empty(n_levels, d_model, device=device))
        self.encoder = DeformableEncoder(d_model, d_ffn, enc_layers, n_levels,
                                         n_heads, enc_n_points, band_margin,
                                         dropout, remat, device=device)
        self.decoder = DeformableDecoder(
            [DeformableDecoderLayer(d_model, d_ffn, n_levels, n_heads,
                                    dec_n_points, dropout, device=device)
             for _ in range(dec_layers)])
        if two_stage:
            # the input is proposal_pos_embed's 512 features, whatever d_model
            self.pos_trans = nn.Linear(512, 2 * d_model, device=device)
            self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5,
                                               device=device)
        else:
            self.reference_points = nn.Linear(d_model, 1, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.level_embed, 0.0, 1.0, generator=generator)
        if hasattr(self, "reference_points"):
            nn.init.xavier_uniform_(self.reference_points.weight,
                                    generator=generator)
            self.reference_points.bias.zero_()
