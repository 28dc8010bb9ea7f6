"""The 'standard' caption head, LSTM-DSA: an LSTM whose per-step visual context
is deformable soft attention around the event's reference point.

Port of gvl_tpu/models/captioner.py, greedy fixed-length decode only
(teacher forcing, scheduled sampling, sampling with temperature, early exit
and beam search are not ported). Parameter names follow the reference
pdvc/CaptioningHead/LSTM_DSA.py state_dict: `embed`, `logit`, `core.rnn`,
`core.deformable_att.{sampling_offsets,value_proj}`, `core.{ctx2att,h2att,
alpha_net}`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.layers import (_directional_offset_bias,
                                         lecun_normal_, xavier_uniform_linear_)
from gvl_tpu_torch.ops import ms_deform_attn_1d_sampled_values
from gvl_tpu_torch.ops.ms_deform_attn import level_tensor


class LSTMCellNoBias(nn.Module):
    """Single-layer LSTM cell, torch gate order (i, f, g, o), no bias.
    Weights are named as nn.LSTM's (weight_ih_l0 (4R, in), weight_hh_l0
    (4R, R)). Port of captioner.py:35-59."""

    def __init__(self, input_size: int, features: int, device=None):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(
            torch.empty(4 * features, input_size, device=device))
        self.weight_hh_l0 = nn.Parameter(
            torch.empty(4 * features, features, device=device))

    def flax_init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight_ih_l0, generator)
        lecun_normal_(self.weight_hh_l0, generator)

    def forward(self, carry, x):
        h, c = carry
        z = F.linear(x, self.weight_ih_l0) + F.linear(h, self.weight_hh_l0)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


def prepare_dsa_reference(reference, valid_ratios, temporal_shapes,
                          n_levels: int, n_points: int):
    """(B, Ne, 1|2) event reference -> prepared [center, offset_scale]
    (B, Ne, L, 2). Port of captioner.py:105-129."""
    vr = valid_ratios[:, :n_levels]                               # (B, L)
    c = reference[:, :, None, 0] * vr[:, None, :]                 # (B, Ne, L)
    if reference.shape[-1] == 2:
        s = (reference[:, :, None, 1] * vr[:, None, :]) / n_points * 0.5
    else:
        shapes = level_tensor(temporal_shapes[:n_levels], c)
        s = (1.0 / shapes)[None, None, :].expand_as(c)
    return torch.stack([c, s], dim=-1)


class _DSASampler(nn.Module):
    """The two live projections of the reference's MSDeformAttnCap (its
    attention_weights and output_proj are never applied on the raw-samples
    path, so they are not kept)."""

    def __init__(self, d_model: int, query_dim: int, n_offsets: int,
                 device=None):
        super().__init__()
        self.sampling_offsets = nn.Linear(query_dim, n_offsets, device=device)
        self.value_proj = nn.Linear(d_model, d_model, device=device)


class DeformableSoftAttention(nn.Module):
    """Sample n_heads*n_levels*n_points taps around each event's reference
    point, then pool them with additive attention conditioned on the LSTM
    state. Port of captioner.py:132-214 (sampling by plain gather)."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, att_hid_size: int, rnn_size: int,
                 query_dim: int, device=None):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.deformable_att = _DSASampler(
            d_model, query_dim, n_heads * n_levels * n_points, device=device)
        self.ctx2att = nn.Linear(d_model // n_heads, att_hid_size,
                                 device=device)
        self.h2att = nn.Linear(rnn_size, att_hid_size, device=device)
        self.alpha_net = nn.Linear(att_hid_size, 1, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        H, L, P = self.n_heads, self.n_levels, self.n_points
        bias = _directional_offset_bias(H, L, P).reshape(H, L, P)
        bias = (bias - bias.mean(dim=2, keepdim=True)).reshape(-1)
        so = self.deformable_att.sampling_offsets
        so.weight.zero_()
        so.bias.copy_(bias)
        xavier_uniform_linear_(self.deformable_att.value_proj, generator)

    def project_value(self, memory, memory_mask):
        """Pre-projected value memory (B, S, H, Dh), hoisted out of the token
        loop."""
        v = self.deformable_att.value_proj(memory)
        if memory_mask is not None:
            v = v.masked_fill(~memory_mask[..., None], 0.0)
        B, S = v.shape[:2]
        return v.reshape(B, S, self.n_heads, self.d_model // self.n_heads)

    def forward(self, joint_query, h_state, reference_points, value,
                temporal_shapes: Sequence[int]):
        """joint_query (B, Ne, Q); h_state (B, Ne, R); reference_points the
        prepared (B, Ne, L, 2); value from project_value. Returns
        (B, Ne, H*Dh)."""
        B, Ne, _ = joint_query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.deformable_att.sampling_offsets(joint_query).reshape(
            B, Ne, H, L, P)
        loc = (reference_points[:, :, None, :, None, 0]
               + offsets * reference_points[:, :, None, :, None, 1])
        taps = ms_deform_attn_1d_sampled_values(
            value, tuple(int(t) for t in temporal_shapes), loc)  # (B,Ne,H,K,Dh)
        att = self.ctx2att(taps)
        att_h = self.h2att(h_state)[:, :, None, None, :]
        alpha = self.alpha_net(torch.tanh(att + att_h))[..., 0]  # (B,Ne,H,K)
        alpha = torch.softmax(alpha, dim=-1)
        att_res = torch.einsum("bnhk,bnhkd->bnhd", alpha, taps)
        return att_res.reshape(B, Ne, -1)


class LSTMDSACore(DeformableSoftAttention):
    """The reference's ShowAttendTellCore: the deformable soft attention plus
    the LSTM cell `rnn`."""

    def __init__(self, input_encoding_size: int, rnn_size: int, d_model: int,
                 query_dim: int, n_levels: int, n_heads: int, n_points: int,
                 att_hid_size: int, device=None):
        super().__init__(d_model, n_levels, n_heads, n_points, att_hid_size,
                         rnn_size, rnn_size + query_dim, device=device)
        self.rnn = LSTMCellNoBias(input_encoding_size + d_model + query_dim,
                                  rnn_size, device=device)


class LSTMDSACaptioner(nn.Module):
    """'standard' caption head, greedy decode."""

    def __init__(self, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, att_hid_size: int, max_caption_len: int,
                 with_query_pos: bool = False, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.rnn_size = rnn_size
        self.n_levels, self.n_points = n_levels, n_points
        self.max_caption_len = max_caption_len
        query_dim = d_model * (2 if with_query_pos else 1)
        self.embed = nn.Embedding(vocab_size + 1, input_encoding_size,
                                  device=device)
        self.logit = nn.Linear(rnn_size, vocab_size + 1, device=device)
        self.core = LSTMDSACore(input_encoding_size, rnn_size, d_model,
                                query_dim, n_levels, n_heads, n_points,
                                att_hid_size, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        # flax initializers.uniform(0.1) draws from [0, 0.1)
        nn.init.uniform_(self.embed.weight, 0.0, 0.1, generator=generator)
        nn.init.uniform_(self.logit.weight, 0.0, 0.1, generator=generator)
        self.logit.bias.zero_()

    def _prepare(self, reference, valid_ratios, temporal_shapes, memory,
                 memory_mask):
        """Expand references to the captioner's levels and pre-project the
        memory values. Port of captioner.py:252-270."""
        shapes = tuple(int(t) for t in temporal_shapes[:self.n_levels])
        total = sum(shapes)
        memory = memory[:, :total]
        memory_mask = memory_mask[:, :total] if memory_mask is not None else None
        ref = prepare_dsa_reference(reference, valid_ratios, temporal_shapes,
                                    self.n_levels, self.n_points)
        return ref, self.core.project_value(memory, memory_mask), shapes

    def _step_core(self, it, carry, query, ref, value, shapes):
        """One recurrence step without the vocab projection."""
        h, c = carry
        xt = self.embed(it)                                       # (B,Ne,E)
        att_res = self.core(torch.cat([h, query], dim=-1), h, ref, value,
                            shapes)
        inp = torch.cat([xt, att_res, query], dim=-1)
        return self.core.rnn((h, c), inp)

    def _step(self, it, carry, query, ref, value, shapes):
        """One token step; returns raw logits (B, Ne, V+1)."""
        carry, out = self._step_core(it, carry, query, ref, value, shapes)
        return carry, self.logit(out)

    def sample(self, query, reference, memory, memory_mask, temporal_shapes,
               valid_ratios):
        """Greedy decode of all (B, Ne) events at once, max_caption_len
        steps with `unfinished` masking (captioner.py:534-566). Returns
        token ids (B, Ne, Lc), 0 after EOS, and the chosen-token logprobs."""
        B, Ne = query.shape[:2]
        ref, value, shapes = self._prepare(reference, valid_ratios,
                                           temporal_shapes, memory,
                                           memory_mask)
        zeros = query.new_zeros((B, Ne, self.rnn_size))
        carry = (zeros, zeros)
        it = torch.zeros((B, Ne), dtype=torch.long, device=query.device)
        unfinished = torch.ones((B, Ne), dtype=torch.bool, device=query.device)
        toks, lps = [], []
        for t in range(self.max_caption_len):
            carry, z = self._step(it, carry, query, ref, value, shapes)
            z = z.float()
            lse = torch.logsumexp(z, dim=-1)
            zmax = z.amax(dim=-1)
            it = z.argmax(dim=-1)
            unfinished = (it > 0) if t == 0 else (unfinished & (it > 0))
            it = it * unfinished
            toks.append(it)
            lps.append(zmax - lse)
        return torch.stack(toks, dim=2), torch.stack(lps, dim=2)
