"""Text-side modeling: word pooling and the sentence context block.

Port of gvl_tpu/models/text.py. Sentences are padded per video to (B, G,
...), as in the JAX package. Parameter names follow the reference PDVC
state_dict as gvl_tpu/train/checkpoint.py:289-321 reads it:
`word_context_model.w1/w2`, `sentence_context_model.transformer_block.
layer.{i}.attention` / `.crossattention` / `.intermediate` / `.output`,
`sentence_context_model.memory_projection` and, for the learned position
table, `sentence_context_model.pos_table.weight` (the cosine table is
recomputed, not stored).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class WordAttentionPool(nn.Module):
    """alpha = softmax(w2(gelu(w1(x)))) over tokens, padded tokens at -1e4;
    feature = sum alpha * x (text.py:26-40; exact GELU)."""

    def __init__(self, hidden_size: int, device=None):
        super().__init__()
        self.w1 = nn.Linear(hidden_size, hidden_size, device=device)
        self.w2 = nn.Linear(hidden_size, 1, device=device)

    def forward(self, x: torch.Tensor, token_mask: torch.Tensor):
        # x (..., Ltok, D); token_mask (..., Ltok) bool
        alpha = self.w2(F.gelu(self.w1(x)))[..., 0]
        alpha = torch.softmax(torch.where(token_mask, alpha, -1e4), dim=-1)
        return torch.einsum("...t,...td->...d", alpha, x)


def _max_pool(x, m):
    return torch.where(m[..., None], x, -1e9).amax(dim=-2)


def _mean_pool(x, m):
    return (x * m[..., None]).sum(-2) / (1e-5 + m.sum(-1, keepdim=True))


def pool_words(kind: str, hidden_size: int, device=None):
    """The word pooling of `word_context_modeling_type` (text.py:42-50): a
    module for 'attention_pool', a function for the other two."""
    if kind == "attention_pool":
        return WordAttentionPool(hidden_size, device=device)
    if kind == "max_pool":
        return _max_pool
    if kind == "mean_pool":
        return _mean_pool
    raise ValueError(kind)


def bert_head_count(width: int) -> int:
    """BertConfig's 12 heads, or the largest of 8, 6, 4, 3, 2, 1 that divides
    a test width (text.py:53-60)."""
    if width % 12 == 0:
        return 12
    return next(h for h in (8, 6, 4, 3, 2, 1) if width % h == 0)


def _cosine_pos_table(max_len: int, dim: int, device=None) -> torch.Tensor:
    """sin on even channels, cos on odd ones (text.py:63-70)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    tab = torch.zeros(max_len, dim, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


class BertSelfAttention(nn.Module):
    """flax MultiHeadDotProductAttention with qkv_features = width: queries
    scaled before the product, masked logits replaced by finfo(float32).min,
    dropout on the probabilities with one mask shared by the batch and the
    heads (flax's broadcast_dropout)."""

    def __init__(self, width: int, n_heads: int, dropout: float, device=None):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.query = nn.Linear(width, width, device=device)
        self.key = nn.Linear(width, width, device=device)
        self.value = nn.Linear(width, width, device=device)

    def forward(self, x, kv, mask: Optional[torch.Tensor]):
        B, Lq, C = x.shape
        h = self.n_heads

        def heads(t):
            return t.reshape(t.shape[0], t.shape[1], h, C // h).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(C // h)
        logits = q @ heads(self.key(kv)).transpose(-1, -2)     # (B,h,Lq,Lk)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits, dim=-1)
        if self.training and self.dropout > 0:
            keep = torch.rand((1, 1) + probs.shape[-2:],
                              device=probs.device) >= self.dropout
            probs = probs * keep / (1.0 - self.dropout)
        out = probs @ heads(self.value(kv))
        return out.transpose(1, 2).reshape(B, Lq, C)


class BertSelfOutput(nn.Module):
    def __init__(self, d_in: int, width: int, eps: float, device=None):
        super().__init__()
        self.dense = nn.Linear(d_in, width, device=device)
        self.LayerNorm = nn.LayerNorm(width, eps=eps, device=device)


class BertAttention(nn.Module):
    def __init__(self, width, n_heads, dropout, eps, device=None):
        super().__init__()
        self.self = BertSelfAttention(width, n_heads, dropout, device=device)
        self.output = BertSelfOutput(width, width, eps, device=device)

    def forward(self, x, kv, mask):
        return self.output.LayerNorm(
            x + self.output.dense(self.self(x, kv, mask)))


class BertIntermediate(nn.Module):
    def __init__(self, width: int, ffn_dim: int, device=None):
        super().__init__()
        self.dense = nn.Linear(width, ffn_dim, device=device)


class BertLayer(nn.Module):
    def __init__(self, width, n_heads, dropout, ffn_dim, eps, cross: bool,
                 device=None):
        super().__init__()
        self.attention = BertAttention(width, n_heads, dropout, eps,
                                       device=device)
        if cross:
            self.crossattention = BertAttention(width, n_heads, dropout, eps,
                                                device=device)
        self.intermediate = BertIntermediate(width, ffn_dim, device=device)
        self.output = BertSelfOutput(ffn_dim, width, eps, device=device)


class BertEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class SentenceContextBlock(nn.Module):
    """BERT-style post-LN layers over each video's sentence features
    (text.py:73-130): heads `n_heads`, FFN 3072 whatever the width (the
    reference only overrides BertConfig's hidden_size), LayerNorm eps 1e-12,
    exact GELU, dropout on the attention probabilities only. With
    cross_fusion, each layer also attends from the sentences into the
    projected video memory; with pos_embedding, a cosine or a learned
    (normal 0.02) position table is added first."""

    def __init__(self, hidden_dim: int, num_layers: int = 1,
                 enable_pos_embedding: bool = False,
                 pos_embedding_type: str = "cosine", max_pos_num: int = 500,
                 cross_fusion: bool = False, memory_dim: int = 512,
                 n_heads: int = 12, dropout: float = 0.1,
                 ffn_dim: int = 3072, ln_eps: float = 1e-12, device=None):
        super().__init__()
        self.hidden_dim, self.max_pos_num = hidden_dim, max_pos_num
        self.pos = pos_embedding_type if enable_pos_embedding else None
        if self.pos not in (None, "cosine"):
            self.pos_table = nn.Embedding(max_pos_num, hidden_dim,
                                          device=device)
        self.cross_fusion = cross_fusion
        if cross_fusion:
            if num_layers != 1:
                # the JAX block names one memory_projection inside its layer
                # loop, which flax allows once
                raise ValueError("cross fusion needs sentence_modeling_layer"
                                 "_num = 1")
            self.memory_projection = nn.Linear(memory_dim, hidden_dim,
                                               device=device)
        self.transformer_block = BertEncoder(
            BertLayer(hidden_dim, n_heads, dropout, ffn_dim, ln_eps,
                      cross_fusion, device=device)
            for _ in range(num_layers))

    def flax_init_(self, generator: torch.Generator) -> None:
        if self.pos not in (None, "cosine"):
            nn.init.normal_(self.pos_table.weight, 0.0, 0.02,
                            generator=generator)

    def forward(self, sent_feat, sent_mask, memory=None, memory_mask=None):
        """sent_feat (B, G, D), sent_mask (B, G) bool -> (B, G, D)."""
        x = sent_feat
        G = x.shape[1]
        if self.pos == "cosine":
            x = x + _cosine_pos_table(self.max_pos_num, self.hidden_dim,
                                      x.device)[None, :G]
        elif self.pos is not None:
            x = x + self.pos_table.weight[None, :G]
        attn_mask = sent_mask[:, None, None, :]
        mem = cmask = None
        if self.cross_fusion and memory is not None:
            mem = self.memory_projection(memory)
            cmask = (memory_mask[:, None, None, :]
                     if memory_mask is not None else None)
        for layer in self.transformer_block.layer:
            x = layer.attention(x, x, attn_mask)
            if mem is not None:
                x = layer.crossattention(x, mem, cmask)
            h = layer.output.dense(F.gelu(layer.intermediate.dense(x)))
            x = layer.output.LayerNorm(x + h)
        return x
