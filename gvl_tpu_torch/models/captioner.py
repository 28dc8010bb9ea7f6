"""The caption heads: 'standard' (LSTM-DSA: an LSTM whose per-step visual
context is deformable soft attention around the event's reference point),
'light' (an LSTM over [word embedding ; event feature]), 'transformer' (a
causal transformer whose cross-attention is deformable attention around the
event's reference point) and 'none' (zeros).

Port of gvl_tpu/models/captioner.py. Every head decodes greedily with a
fixed step count and `unfinished` masking; with early_exit the loop stops
once every caption has emitted EOS (`decode_loop`); the LSTM-DSA and light
heads also sample with a temperature (the SCST rollouts), and the LSTM-DSA
head runs beam search (`sample_beam`). Teacher forcing: logprobs (`forward`)
and, for the LSTM heads, the fused per-event NLL (`teacher_forced_nll`).
Under the bf16 options the caller casts the head's parameters and its query
and memory (gvl_tpu_torch/utils/amp.py); the logsumexp and the chosen-token
logprobs stay f32 here. Scheduled sampling (the LSTM-DSA head's `forward`
at ss_prob > 0 in train mode) runs the serial chain, its draws by
`ss_draws`.

Parameter names: the LSTM-DSA head follows the reference
pdvc/CaptioningHead/LSTM_DSA.py state_dict (`embed`, `logit`, `core.rnn`,
`core.deformable_att.{sampling_offsets,value_proj}`, `core.{ctx2att,h2att,
alpha_net}`); the light and transformer heads, whose reference names no
record of this repository keeps, mirror the Flax paths (gvl_tpu_torch/
convert.py lists the map).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.gpt_captioner import CachedSelfAttention
from gvl_tpu_torch.models.layers import (MSDeformAttn1D,
                                         _directional_offset_bias,
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
        return self.gates(carry, F.linear(x, self.weight_ih_l0))

    def gates(self, carry, z_ih):
        """The recurrent half and the nonlinearity, given the input-side
        pre-activation z_ih = x @ W_ih^T computed by the caller."""
        h, c = carry
        z = z_ih + F.linear(h, self.weight_hh_l0)
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h


def caption_nll(logprobs: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Per-sequence masked NLL: mean over valid steps of -logprob[target].
    logprobs (N, Tsteps, V); targets, mask (N, Tcap), read up to Tsteps.
    Port of captioner.py:79-91."""
    Tsteps = logprobs.shape[1]
    tgt = targets[:, :Tsteps].long()
    m = mask[:, :Tsteps].to(logprobs.dtype)
    picked = torch.gather(logprobs, 2, tgt[..., None])[..., 0]
    return -(picked * m).sum(-1) / (m.sum(-1) + 1e-6)


def draw_tokens(z: torch.Tensor, temperature: float,
                generator: torch.Generator = None) -> torch.Tensor:
    """One token per event from softmax(z / temperature) (z (B, Ne, V+1)
    raw logits), drawn with `generator` (the device's default one when
    None). Returns (B, Ne) int64."""
    probs = torch.softmax(z.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        z.shape[:-1])


def ss_draws(prev_lp: torch.Tensor, generator: torch.Generator = None):
    """The draws of one scheduled-sampling step (captioner.py:438-443): a
    token per event from the previous step's distribution exp(prev_lp)
    (B, Ne, V+1), and a number per event uniform in [0, 1); the token
    replaces the teacher's where the number is below ss_prob. Drawn with
    `generator` (the device's default one when None). Returns (tokens
    int64, numbers f32), each (B, Ne)."""
    flat = prev_lp.detach().float().exp().reshape(-1, prev_lp.shape[-1])
    tokens = torch.multinomial(flat, 1, generator=generator).reshape(
        prev_lp.shape[:-1])
    numbers = torch.rand(prev_lp.shape[:-1], generator=generator,
                         device=prev_lp.device)
    return tokens, numbers


# Early exit reads whether any caption is unfinished every this many steps
# (one host synchronisation each); the logprobs of the steps run past the
# stop are zeroed afterwards, so any cadence gives JAX's while_loop output.
EXIT_CHECK_EVERY = 1


def decode_loop(step: Callable, shape, max_len: int, device,
                greedy: bool = True, temperature: float = 1.0,
                generator: torch.Generator = None, normalized: bool = False,
                early_exit: bool = False):
    """The token loop every head decodes with (captioner.py:553-598).
    `step(it, t)` returns the logits (raw, or log-softmaxed when
    `normalized`) of the tokens `it` (`shape`, int64) at position t. Greedy:
    the argmax; otherwise a draw from softmax(z / temperature). Returns the
    tokens (shape + (max_len,)), 0 from each caption's first EOS on, and the
    chosen tokens' logprobs in f32 (differentiable when the step is).

    With early_exit (greedy only, as in JAX) the loop stops once every
    caption has emitted EOS (captioner.py:499-532): the tokens are the fixed
    loop's, and the steps JAX's while_loop does not run have logprob 0. On
    the card the test costs a host synchronisation; it is made every
    EXIT_CHECK_EVERY steps, and the logprobs of the steps run past the stop
    are zeroed, so the output does not depend on the cadence."""
    early_exit = early_exit and greedy
    it = torch.zeros(shape, dtype=torch.long, device=device)   # BOS = 0
    unfinished = torch.ones(shape, dtype=torch.bool, device=device)
    toks, lps, alive = [], [], []
    for t in range(max_len):
        z = step(it, t).float()
        lse = None if normalized else torch.logsumexp(z, dim=-1)
        if greedy:
            lp, it = z.amax(dim=-1), z.argmax(dim=-1)
        else:
            it = draw_tokens(z, temperature, generator)
            lp = torch.gather(z, -1, it[..., None])[..., 0]
        unfinished = (it > 0) if t == 0 else (unfinished & (it > 0))
        it = it * unfinished
        toks.append(it)
        lps.append(lp if normalized else lp - lse)
        if early_exit:
            alive.append(unfinished.any())
            if (t + 1) % EXIT_CHECK_EVERY == 0 and not bool(alive[-1]):
                break
    toks, lps = torch.stack(toks, dim=-1), torch.stack(lps, dim=-1)
    if early_exit:
        # step s ran in JAX's loop iff some caption was unfinished after s-1
        a = torch.stack(alive).long()
        ran = torch.cat([a.new_ones(1), a[:-1]]).cumprod(0).bool()
        lps = torch.where(ran, lps, torch.zeros_like(lps))
        pad = max_len - toks.shape[-1]
        if pad:
            toks = F.pad(toks, (0, pad))
            lps = F.pad(lps, (0, pad))
    return toks, lps


def log_softmax_f32(z: torch.Tensor) -> torch.Tensor:
    """log_softmax in f32 whatever z's type (captioner.py:62-69)."""
    return torch.log_softmax(z.float(), dim=-1)


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
    """'standard' caption head: greedy or sampled decode (`sample`) and
    teacher forcing (`forward`, `teacher_forced_nll`). The cell output's
    dropout is live under `.train()` only."""

    def __init__(self, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, att_hid_size: int, max_caption_len: int,
                 with_query_pos: bool = False, drop_prob: float = 0.5,
                 device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.input_encoding_size = input_encoding_size
        self.rnn_size = rnn_size
        self.d_model = d_model
        self.dropout = nn.Dropout(drop_prob)
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
                 memory_mask, ref_prepared: bool = False):
        """Expand references to the captioner's levels and pre-project the
        memory values. With ref_prepared, `reference` already is the
        (B, Ne, L, 2) result of prepare_dsa_reference. Port of
        captioner.py:252-270."""
        shapes = tuple(int(t) for t in temporal_shapes[:self.n_levels])
        total = sum(shapes)
        memory = memory[:, :total]
        memory_mask = memory_mask[:, :total] if memory_mask is not None else None
        ref = reference if ref_prepared else prepare_dsa_reference(
            reference, valid_ratios, temporal_shapes, self.n_levels,
            self.n_points)
        return ref, self.core.project_value(memory, memory_mask), shapes

    def _step_core(self, it, carry, query, ref, value, shapes):
        """One recurrence step without the vocab projection; the cell output
        goes through the dropout, the carry does not."""
        h, c = carry
        xt = self.embed(it)                                       # (B,Ne,E)
        att_res = self.core(torch.cat([h, query], dim=-1), h, ref, value,
                            shapes)
        inp = torch.cat([xt, att_res, query], dim=-1)
        carry, out = self.core.rnn((h, c), inp)
        return carry, self.dropout(out)

    def _step(self, it, carry, query, ref, value, shapes):
        """One token step; returns raw logits (B, Ne, V+1)."""
        carry, out = self._step_core(it, carry, query, ref, value, shapes)
        return carry, self.logit(out)

    def _tf_hidden_states(self, seq, query, ref, value, shapes):
        """Teacher-forced recurrence over all Lc-1 steps -> the dropped-out
        cell outputs (B, Ne, T, R). The LSTM input z = [xt; att_res; query]
        @ W_ih splits by linearity into xt @ W_x (all steps in one matmul:
        the tokens are known ahead), query @ W_q (once), and only
        att_res @ W_a stays on the serial chain: equal to `_step_core` per
        step up to f32 summation order. Port of captioner.py:301-370."""
        B, Ne, Lc = seq.shape
        T = Lc - 1
        seq = seq.long()
        zeros = query.new_zeros((B, Ne, self.rnn_size))
        carry = (zeros, zeros)
        hs = []
        E, C = self.input_encoding_size, self.d_model
        w_ih = self.core.rnn.weight_ih_l0                         # (4R, E+C+Q)
        z_x = F.linear(self.embed(seq[:, :, :T]), w_ih[:, :E])    # (B,Ne,T,4R)
        z_q = F.linear(query, w_ih[:, E + C:])
        w_att = w_ih[:, E:E + C]
        for t in range(T):
            h = carry[0]
            att_res = self.core(torch.cat([h, query], dim=-1), h, ref, value,
                                shapes)
            z_ih = z_x[:, :, t] + F.linear(att_res, w_att) + z_q
            carry, out = self.core.rnn.gates(carry, z_ih)
            hs.append(self.dropout(out))
        return torch.stack(hs, dim=2)

    def teacher_forced_nll(self, query, reference, memory, memory_mask,
                           temporal_shapes, valid_ratios, seq, seq_mask,
                           ref_prepared: bool = False):
        """Per-event masked NLL (B, Ne) of teacher forcing: caption_nll over
        `forward`'s logprobs, but as picked logit minus logsumexp, so the
        normalised (B, Ne, T, V) tensor is never built. No scheduled
        sampling. Port of captioner.py:372-393."""
        ref, value, shapes = self._prepare(reference, valid_ratios,
                                           temporal_shapes, memory,
                                           memory_mask, ref_prepared)
        hs = self._tf_hidden_states(seq, query, ref, value, shapes)
        z = self.logit(hs).float()                               # (B,Ne,T,V)
        lse = torch.logsumexp(z, dim=-1)
        picked = torch.gather(z, 3, seq[:, :, 1:].long()[..., None])[..., 0]
        m = seq_mask[:, :, 1:].float()
        return -((picked - lse) * m).sum(-1) / (m.sum(-1) + 1e-6)

    def forward(self, query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq, ss_prob: float = 0.0,
                ref_prepared: bool = False,
                generator: torch.Generator = None):
        """Teacher-forced logprobs (B, Ne, Lc-1, V+1) for seq (B, Ne, Lc).
        All Lc-1 steps are computed and the loss masks them. Port of
        captioner.py:395-450. Scheduled sampling (ss_prob > 0 in train
        mode) runs the serial chain: from step 1 on, each event's input
        token is drawn from the previous step's logprobs with probability
        ss_prob (`ss_draws`, with `generator`), else the teacher's."""
        ref, value, shapes = self._prepare(reference, valid_ratios,
                                           temporal_shapes, memory,
                                           memory_mask, ref_prepared)
        if not (self.training and ss_prob > 0):
            hs = self._tf_hidden_states(seq, query, ref, value, shapes)
            return torch.log_softmax(self.logit(hs).float(), dim=-1)
        zeros = query.new_zeros(seq.shape[:2] + (self.rnn_size,))
        carry, prev, outs = (zeros, zeros), None, []
        for t in range(seq.shape[-1] - 1):
            it = seq[:, :, t].long()
            if prev is not None:
                tokens, numbers = ss_draws(prev, generator)
                it = torch.where(numbers < ss_prob, tokens, it)
            carry, z = self._step(it, carry, query, ref, value, shapes)
            prev = log_softmax_f32(z)
            outs.append(prev)
        return torch.stack(outs, dim=2)

    def sample(self, query, reference, memory, memory_mask, temporal_shapes,
               valid_ratios, greedy: bool = True, temperature: float = 1.0,
               generator: torch.Generator = None,
               ref_prepared: bool = False, early_exit: bool = False):
        """Decode all (B, Ne) events at once, max_caption_len steps with
        `unfinished` masking (captioner.py:474-598), by `decode_loop`:
        greedy, or drawn from softmax(z / temperature) with `generator`;
        with early_exit (greedy) the loop stops once every caption has
        ended. Returns token ids (B, Ne, Lc), 0 after EOS, and the chosen
        tokens' logprobs z[it] - logsumexp(z) in f32 (of the drawn token,
        before the masking), differentiable when gradients are on: a rollout
        `s` has the teacher-forced logprobs of [0 | s] picked at `s`, up to
        its first 0."""
        B, Ne = query.shape[:2]
        ref, value, shapes = self._prepare(reference, valid_ratios,
                                           temporal_shapes, memory,
                                           memory_mask, ref_prepared)
        zeros = query.new_zeros((B, Ne, self.rnn_size))
        carry = [(zeros, zeros)]

        def step(it, t):
            carry[0], z = self._step(it, carry[0], query, ref, value, shapes)
            return z

        return decode_loop(step, (B, Ne), self.max_caption_len, query.device,
                           greedy, temperature, generator,
                           early_exit=early_exit)

    def sample_beam(self, query, reference, memory, memory_mask,
                    temporal_shapes, valid_ratios, beam_size: int = 3):
        """Beam search (captioner.py:600-670). Finished beams (token 0) are
        frozen: they continue only with token 0 at no added score. Each step
        takes the top `beam_size` of the W*V candidates of an event, and
        the state, tokens and logprobs follow their parent beams. Returns the
        best beam's tokens (B, Ne, Lc), cut after its first EOS, and its
        per-step chosen logprobs (f32)."""
        W = beam_size
        B, Ne = query.shape[:2]
        ref, value, shapes = self._prepare(reference, valid_ratios,
                                           temporal_shapes, memory,
                                           memory_mask)
        q_t = query.repeat_interleave(W, dim=1)                  # (B, Ne*W, C)
        ref_t = ref.repeat_interleave(W, dim=1)
        V = self.vocab_size + 1
        Lc = self.max_caption_len
        dev = query.device
        h = query.new_zeros((B, Ne * W, self.rnn_size))
        c = h
        it = torch.zeros((B, Ne * W), dtype=torch.long, device=dev)
        scores = torch.full((B, Ne, W), -1e9, device=dev)
        scores[:, :, 0] = 0.0
        finished = torch.zeros((B, Ne, W), dtype=torch.bool, device=dev)
        toks = torch.zeros((B, Ne, W, Lc), dtype=torch.long, device=dev)
        lps = torch.zeros((B, Ne, W, Lc), device=dev)
        frozen = torch.full((V,), -1e9, device=dev)
        frozen[0] = 0.0
        for t in range(Lc):
            (h, c), z = self._step(it, (h, c), q_t, ref_t, value, shapes)
            lp = log_softmax_f32(z).reshape(B, Ne, W, V)
            lp = torch.where(finished[..., None], frozen, lp)
            cand = (scores[..., None] + lp).reshape(B, Ne, W * V)
            scores, top = torch.topk(cand, W, dim=-1)
            parent = torch.div(top, V, rounding_mode="floor")
            token = top % V
            step_lp = torch.gather(lp.reshape(B, Ne, W * V), 2, top)

            def regather(x):
                idx = parent.reshape(parent.shape + (1,) * (x.dim() - 3))
                return torch.gather(x, 2, idx.expand_as(x))

            toks, lps = regather(toks), regather(lps)
            toks[:, :, :, t] = token
            lps[:, :, :, t] = step_lp
            finished = torch.gather(finished, 2, parent) | (token == 0)
            h = regather(h.reshape(B, Ne, W, -1)).reshape(B, Ne * W, -1)
            c = regather(c.reshape(B, Ne, W, -1)).reshape(B, Ne * W, -1)
            it = token.reshape(B, Ne * W)
        best = scores.argmax(dim=-1)[..., None, None].expand(-1, -1, 1, Lc)
        best_toks = torch.gather(toks, 2, best)[:, :, 0]
        best_lps = torch.gather(lps, 2, best)[:, :, 0]
        # zero everything after the first EOS (token 0), as greedy does
        eos = (best_toks == 0).long()
        alive = (eos.cumsum(-1) - eos) == 0
        return best_toks * alive, best_lps


class LightCaptioner(nn.Module):
    """'light' head: an LSTM over [word embedding ; event feature], the event
    query itself the visual context (captioner.py:673-803; reference
    CaptioningHead/LSTM.py). Events flatten into one (B*Ne) batch."""

    def __init__(self, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, max_caption_len: int, query_dim: int,
                 drop_prob: float = 0.5, device=None):
        super().__init__()
        self.vocab_size = vocab_size
        self.input_encoding_size = input_encoding_size
        self.rnn_size = rnn_size
        self.max_caption_len = max_caption_len
        self.dropout = nn.Dropout(drop_prob)
        self.embed = nn.Embedding(vocab_size + 1, input_encoding_size,
                                  device=device)
        self.logit = nn.Linear(rnn_size, vocab_size + 1, device=device)
        self.cell = LSTMCellNoBias(input_encoding_size + query_dim, rnn_size,
                                   device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        nn.init.uniform_(self.embed.weight, 0.0, 0.1, generator=generator)
        nn.init.uniform_(self.logit.weight, 0.0, 0.1, generator=generator)
        self.logit.bias.zero_()

    def _step(self, it, carry, ctx):
        """One token step over (B*Ne) events: the f32 logprobs."""
        carry, out = self.cell(carry, torch.cat([self.embed(it), ctx], -1))
        return carry, log_softmax_f32(self.logit(self.dropout(out)))

    def _tf_hidden_states(self, seq, ctx):
        """Teacher-forced recurrence -> (B, Ne, T, R): the input side hoisted
        as in the LSTM-DSA head (xt @ W_x over all steps, ctx @ W_c once),
        only the recurrent matmul on the serial chain (captioner.py:
        703-723)."""
        B, Ne, Lc = seq.shape
        T, E = Lc - 1, self.input_encoding_size
        w_ih = self.cell.weight_ih_l0
        z_x = F.linear(self.embed(seq[:, :, :T].long()).reshape(B * Ne, T, E),
                       w_ih[:, :E])
        z_c = F.linear(ctx, w_ih[:, E:])
        h = ctx.new_zeros((B * Ne, self.rnn_size))
        carry, hs = (h, h), []
        for t in range(T):
            carry, out = self.cell.gates(carry, z_x[:, t] + z_c)
            hs.append(self.dropout(out).reshape(B, Ne, -1))
        return torch.stack(hs, dim=2)

    def forward(self, query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq):
        """Teacher-forced logprobs (B, Ne, Lc-1, V+1); `reference` and the
        memory are not read (captioner.py:725-733)."""
        B, Ne = seq.shape[:2]
        hs = self._tf_hidden_states(seq, query.reshape(B * Ne, -1))
        return log_softmax_f32(self.logit(hs))

    def teacher_forced_nll(self, query, reference, memory, memory_mask,
                           temporal_shapes, valid_ratios, seq, seq_mask):
        """Fused per-event NLL (B, Ne), picked logit minus logsumexp
        (captioner.py:735-745)."""
        B, Ne = seq.shape[:2]
        hs = self._tf_hidden_states(seq, query.reshape(B * Ne, -1))
        z = self.logit(hs).float()
        lse = torch.logsumexp(z, dim=-1)
        picked = torch.gather(z, 3, seq[:, :, 1:].long()[..., None])[..., 0]
        m = seq_mask[:, :, 1:].float()
        return -((picked - lse) * m).sum(-1) / (m.sum(-1) + 1e-6)

    def sample(self, query, reference, memory, memory_mask, temporal_shapes,
               valid_ratios, greedy: bool = True, temperature: float = 1.0,
               generator: torch.Generator = None, early_exit: bool = False):
        """Greedy or sampled decode (captioner.py:747-803) by `decode_loop`
        over the f32 logprobs of each step."""
        B, Ne = query.shape[:2]
        ctx = query.reshape(B * Ne, -1)
        h = ctx.new_zeros((B * Ne, self.rnn_size))
        carry = [(h, h)]

        def step(it, t):
            carry[0], lp = self._step(it.reshape(-1), carry[0], ctx)
            return lp.reshape(B, Ne, -1)

        return decode_loop(step, (B, Ne), self.max_caption_len, query.device,
                           greedy, temperature, generator, normalized=True,
                           early_exit=early_exit)


def sine_table(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Sinusoidal position table (max_len, dim) (captioner.py:806-813)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * -(math.log(10000.0) / dim))
    tab = torch.zeros((max_len, dim), device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


class TransformerDSACaptioner(nn.Module):
    """'transformer' head: a causal transformer over the caption tokens whose
    cross-attention is deformable attention around the event's reference
    point (captioner.py:816-1025; reference CaptioningHead/Transformer_DSA.py).

    The cross-attention is `MSDeformAttn1D` with band margin 0, the dense op
    (JAX impl 'ref', captioner.py:858-861): on the card kernel 1 forward and
    kernel 2 backward, over the (B, Ne*L) tokens of all events in teacher
    forcing and the (B, Ne) current tokens in a cached decode step. The
    self-attention is causal within an event and never crosses events: JAX
    masks one (Ne*L)^2 attention block-diagonally (:880-908); here each event
    attends over its own L tokens, which is that softmax without its masked
    terms (each exactly 0 there). Requires input_encoding_size == d_model
    (config.py:452-461)."""

    def __init__(self, vocab_size: int, input_encoding_size: int,
                 d_model: int, num_layers: int, n_levels: int, n_heads: int,
                 n_points: int, max_caption_len: int, query_dim: int,
                 drop_prob: float = 0.5, device=None):
        super().__init__()
        if input_encoding_size != d_model:
            raise ValueError("the transformer caption head needs "
                             "input_encoding_size == d_model")
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_levels = n_levels
        self.max_caption_len = max_caption_len
        self.embed = nn.Embedding(vocab_size + 1, d_model, device=device)
        self.logits = nn.Linear(d_model, vocab_size + 1, device=device)
        self.lm_dropout = nn.Dropout(drop_prob)
        self.res_dropout = nn.Dropout(drop_prob)

        def each(make):
            return nn.ModuleList(make() for _ in range(num_layers))

        self.self_attn = each(lambda: CachedSelfAttention(
            d_model, n_heads, d_model, drop_prob, device=device))
        self.dim_project = each(lambda: nn.Linear(d_model + query_dim,
                                                  d_model, device=device))
        self.cross_attn = each(lambda: MSDeformAttn1D(
            d_model, n_levels, n_heads, n_points, band_margin=0,
            device=device))
        self.norm1, self.norm2, self.norm3 = (
            each(lambda: nn.LayerNorm(d_model, eps=1e-6, device=device))
            for _ in range(3))
        self.ffn1 = each(lambda: nn.Linear(d_model, 4 * d_model,
                                           device=device))
        self.ffn2 = each(lambda: nn.Linear(4 * d_model, d_model,
                                           device=device))

    def flax_init_(self, generator: torch.Generator) -> None:
        # flax's default Embed init: variance scaling over the rows
        std = math.sqrt(1.0 / self.embed.weight.shape[0]) / 0.87962566103423978
        nn.init.trunc_normal_(self.embed.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    def _prepare_ref(self, reference, valid_ratios, temporal_shapes, memory,
                     memory_mask):
        """References scaled per level (B, Ne, L, 1|2), the memory cut to the
        head's levels (captioner.py:866-878)."""
        shapes = tuple(int(t) for t in temporal_shapes[:self.n_levels])
        total = sum(shapes)
        memory = memory[:, :total]
        memory_mask = memory_mask[:, :total] if memory_mask is not None \
            else None
        vr = valid_ratios[:, :self.n_levels]
        if reference.shape[-1] == 2:
            ref = reference[:, :, None, :] * torch.stack([vr, vr], -1)[:, None]
        else:
            ref = reference[:, :, None, :] * vr[:, None, :, None]
        return ref, memory, memory_mask, shapes

    def _layers(self, x, attend, query, ref, memory, memory_mask, shapes):
        """The decoder layers over x (B, Lq, E): `attend(i, x)` is layer i's
        self-attention; the cross-attention's queries are x beside `query`
        (B, Lq, Q), at `ref` (B, Lq, L, 1|2)."""
        for i in range(len(self.self_attn)):
            x = self.norm1[i](x + self.res_dropout(attend(i, x)))
            joint = self.dim_project[i](torch.cat([x, query], -1))
            h = self.cross_attn[i](joint, ref, memory, memory_mask, shapes)
            x = self.norm2[i](x + self.res_dropout(h))
            x = self.norm3[i](x + self.ffn2[i](F.relu(self.ffn1[i](x))))
        return log_softmax_f32(self.logits(self.lm_dropout(x)))

    def _forward_logprobs(self, query, ref, memory, memory_mask, shapes, seq):
        """seq (B, Ne, L) -> logprobs (B, Ne, L, V+1), position t predicting
        t+1 (captioner.py:880-908)."""
        B, Ne, L = seq.shape
        tab = sine_table(self.max_caption_len + 2, self.d_model,
                         seq.device)[:L]
        x = (self.embed(seq.long()) + tab).reshape(B, Ne * L, -1)
        causal = torch.ones((L, L), dtype=torch.bool,
                            device=seq.device).tril()

        def attend(i, x):
            h = self.self_attn[i](x.reshape(B * Ne, L, -1), causal)
            return h.reshape(B, Ne * L, -1)

        lp = self._layers(x, attend, query.repeat_interleave(L, dim=1), ref
                          .repeat_interleave(L, dim=1), memory, memory_mask,
                          shapes)
        return lp.reshape(B, Ne, L, -1)

    def forward(self, query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq):
        """Teacher-forced logprobs (B, Ne, Lc-1, V+1) (captioner.py:
        910-916)."""
        ref, memory, memory_mask, shapes = self._prepare_ref(
            reference, valid_ratios, temporal_shapes, memory, memory_mask)
        return self._forward_logprobs(query, ref, memory, memory_mask, shapes,
                                      seq)[:, :, :-1]

    def sample(self, query, reference, memory, memory_mask, temporal_shapes,
               valid_ratios, greedy: bool = True, temperature: float = 1.0,
               generator: torch.Generator = None, use_cache: bool = True,
               early_exit: bool = False):
        """Greedy decode, whatever `greedy` says, as in JAX (captioner.py:
        946-1025). use_cache (default): one token a step against each
        layer's cached keys and values; otherwise the reference's loop, the
        whole prefix run again each step, kept as the oracle. early_exit:
        `decode_loop`'s."""
        B, Ne = query.shape[:2]
        ref, memory, memory_mask, shapes = self._prepare_ref(
            reference, valid_ratios, temporal_shapes, memory, memory_mask)
        tab = sine_table(self.max_caption_len + 2, self.d_model, query.device)
        if use_cache:
            caches = [[] for _ in self.self_attn]

            def attend(i, x):
                return self.self_attn[i].step(
                    x.reshape(B * Ne, 1, -1), caches[i]).reshape(B, Ne, -1)

            def step(it, t):
                return self._layers(self.embed(it) + tab[t], attend, query,
                                    ref, memory, memory_mask, shapes)
        else:
            prefix = []

            def step(it, t):
                prefix.append(it)
                lp = self._forward_logprobs(query, ref, memory, memory_mask,
                                            shapes, torch.stack(prefix, -1))
                return lp[:, :, t]

        return decode_loop(step, (B, Ne), self.max_caption_len, query.device,
                           normalized=True, early_exit=early_exit)


class PuppetCaptioner(nn.Module):
    """'none': zeros of the right shapes, for localization-only configs
    (captioner.py:1028-1044; reference Puppet.py). No parameters."""

    def __init__(self, vocab_size: int, max_caption_len: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_caption_len = max_caption_len

    def forward(self, query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq):
        B, Ne, Lc = seq.shape
        return query.new_zeros((B, Ne, Lc - 1, self.vocab_size + 1),
                               dtype=torch.float32)

    def sample(self, query, reference, memory, memory_mask, temporal_shapes,
               valid_ratios, **options):
        """Zeros, whatever the decode options."""
        B, Ne = query.shape[:2]
        z = query.new_zeros((B, Ne, self.max_caption_len),
                            dtype=torch.float32)
        return z.long(), z
