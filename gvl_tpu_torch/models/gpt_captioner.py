"""Self-attention with a key/value cache for single-token decode: the part of
gvl_tpu/models/gpt_captioner.py that the transformer caption head is built
on (`CachedSelfAttention`, gpt_captioner.py:71-119). The GPT-2 head itself
is not ported yet (ROADMAP Queue 1 item 7).

Parameter names mirror the Flax paths: `query`, `key`, `value` (Flax
DenseGeneral kernels (E, H, Dh) -> Linear weights (H*Dh, E)) and `out`
((H, Dh, E') -> (E', H*Dh)).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class CachedSelfAttention(nn.Module):
    """Multi-head dot-product self-attention, Flax's
    nn.MultiHeadDotProductAttention with its parameter layout: queries scaled
    by 1/sqrt(Dh), masked logits at the type's most negative value, softmax
    in the logits' type, dropout on the attention weights in train mode.

    `forward` runs a whole sequence under a boolean mask (True = attend);
    `step` one token against the keys and values of the tokens before it. The
    JAX step writes them into a fixed (N, Lmax) cache and masks the positions
    not reached; here the cache is the list of the earlier steps' keys and
    values, concatenated, which is the same softmax without the masked terms
    (each exactly 0 there)."""

    def __init__(self, in_features: int, num_heads: int, qkv_features: int,
                 dropout_rate: float = 0.0, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = qkv_features // num_heads
        self.dropout_rate = dropout_rate
        self.query = nn.Linear(in_features, qkv_features, device=device)
        self.key = nn.Linear(in_features, qkv_features, device=device)
        self.value = nn.Linear(in_features, qkv_features, device=device)
        self.out = nn.Linear(qkv_features, qkv_features, device=device)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[:-1] + (self.num_heads, self.head_dim))

    def _attend(self, q, k, v, mask: Optional[torch.Tensor],
                dropout: bool):
        """q (N, Lq, H, Dh), k and v (N, Lk, H, Dh), mask broadcastable to
        (N, H, Lq, Lk) -> (N, Lq, H*Dh) before the output projection."""
        q = q / math.sqrt(self.head_dim)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        if dropout and self.training and self.dropout_rate > 0:
            w = F.dropout(w, self.dropout_rate)
        ctx = torch.einsum("nhqk,nkhd->nqhd", w, v)
        return ctx.reshape(ctx.shape[:2] + (-1,))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (N, L, E) -> (N, L, E')."""
        q, k, v = (self._heads(f(x)) for f in (self.query, self.key,
                                               self.value))
        return self.out(self._attend(q, k, v, mask, True))

    def step(self, x_t: torch.Tensor,
             cache: List[Tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
        """One decode step: x_t (N, 1, E) at the position len(cache). Appends
        its key and value to `cache` and attends over every cached position,
        its own included, without dropout, as the JAX step. Returns
        (N, 1, E')."""
        q = self._heads(self.query(x_t))
        cache.append((self._heads(self.key(x_t)),
                      self._heads(self.value(x_t))))
        k = torch.cat([kv[0] for kv in cache], dim=1)
        v = torch.cat([kv[1] for kv in cache], dim=1)
        return self.out(self._attend(q, k, v, None, False))
