"""The text encoder of the contrastive side: a RoBERTa encoder in plain
torch, the hash tokenizer and the loader.

Port of gvl_tpu/models/text_encoder.py, offline route only: the JAX package
builds `FlaxRobertaModel(RobertaConfig(...))` with random weights and
tokenizes with `HashTokenizer` when `load_pretrained_language_model_from_
config` is set (text_encoder.py:91-110). Pretrained `roberta-base` weights
and its tokenizer are not available to the port, and `load_text_encoder`
refuses to run without that flag instead of falling back silently.

What the encoder computes, as HF Flax RoBERTa does:
- position ids start at pad id + 1 = 2 and count non-pad tokens only;
- one token type (id 0);
- LayerNorm eps 1e-12 (`RobertaConfig()`'s, not roberta-base's 1e-5);
- exact (erf) GELU (HF Flax `"gelu"`);
- attention logits of masked keys get `finfo(float32).min` added, never
  -inf, so an all-padding row attends uniformly and stays finite;
- no dropout: the JAX package's `apply_fn` never passes `train=True`, so
  the encoder runs deterministic in the train step too.
The pooler is built, so that the state_dict is an HF `RobertaModel`'s, and
never run (the JAX package reads `last_hidden_state` only).

Parameter names follow HF `RobertaModel` under the prefix `text_encoder.`
(`text_encoder.embeddings.word_embeddings.weight`,
`text_encoder.encoder.layer.{i}.attention.self.query.weight`, ...), the
prefix gvl_tpu/train/checkpoint.py:323 skips when it imports a GVL state_dict.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class HashTokenizer:
    """Deterministic whitespace + hash tokenizer (text_encoder.py:31-48).
    RoBERTa-style special ids: bos=0, pad=1, eos=2; words hash into
    [3, vocab)."""

    def __init__(self, vocab_size: int = 5000):
        self.vocab_size = vocab_size

    def __call__(self, sents: List[str], max_len: int):
        ids = np.ones((len(sents), max_len), np.int32)          # pad=1
        mask = np.zeros((len(sents), max_len), np.int32)
        for i, s in enumerate(sents):
            toks = [0] + [3 + (zlib.crc32(w.encode()) % (self.vocab_size - 3))
                          for w in s.lower().split()][: max_len - 2] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return ids, mask


def _batch_tokenize(tok_fn, raw_per_video: List[List[str]], G: int,
                    max_len: int):
    """Tokenize per-video sentence lists into padded (B, G, L) arrays; a
    video with fewer than G sentences is padded with "" (text_encoder.py:
    51-60)."""
    B = len(raw_per_video)
    flat = []
    for sents in raw_per_video:
        sents = list(sents[:G]) + [""] * (G - len(sents[:G]))
        flat.extend(sents)
    ids, mask = tok_fn(flat, max_len)
    return ids.reshape(B, G, -1), mask.reshape(B, G, -1)


def effective_max_gt_events(cfg: Any) -> int:
    """G, the sentence slots of a video: max_gt_events when set, else
    gt_proposal_sample_num capped at 64 (gvl_tpu/config.py:389-396)."""
    n = int(getattr(cfg, "max_gt_events", 0))
    if n > 0:
        return n
    return min(int(getattr(cfg, "gt_proposal_sample_num", 10)), 64)


@dataclasses.dataclass(frozen=True)
class RobertaSpec:
    """The `RobertaConfig` fields the encoder reads."""
    vocab_size: int = 5000
    hidden_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    intermediate_size: int = 1024
    max_positions: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    @classmethod
    def offline(cls, cfg: Any) -> "RobertaSpec":
        """The JAX package's offline RoBERTa (text_encoder.py:93-100)."""
        hidden = int(getattr(cfg, "offline_text_encoder_hidden", 256))
        return cls(hidden_size=hidden,
                   num_layers=int(getattr(cfg, "offline_text_encoder_layers",
                                          2)),
                   num_heads=max(hidden // 64, 1),
                   intermediate_size=hidden * 4)


class RobertaEmbeddings(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.pad_token_id = s.pad_token_id
        self.word_embeddings = nn.Embedding(s.vocab_size, s.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(s.max_positions, s.hidden_size,
                                                device=device)
        self.token_type_embeddings = nn.Embedding(s.type_vocab_size,
                                                  s.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(s.hidden_size, eps=s.layer_norm_eps,
                                      device=device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        not_pad = (ids != self.pad_token_id).long()
        positions = torch.cumsum(not_pad, dim=1) * not_pad + self.pad_token_id
        x = (self.word_embeddings(ids) + self.position_embeddings(positions)
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class RobertaSelfAttention(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.num_heads = s.num_heads
        self.query = nn.Linear(s.hidden_size, s.hidden_size, device=device)
        self.key = nn.Linear(s.hidden_size, s.hidden_size, device=device)
        self.value = nn.Linear(s.hidden_size, s.hidden_size, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        N, L, C = x.shape
        h = self.num_heads
        q, k, v = (lin(x).reshape(N, L, h, C // h).transpose(1, 2)
                   for lin in (self.query, self.key, self.value))
        q = q / math.sqrt(C // h)
        probs = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        return (probs @ v).transpose(1, 2).reshape(N, L, C)


class RobertaSelfOutput(nn.Module):
    """The dense layer after an attention or the FFN, then post-LN."""

    def __init__(self, d_in: int, s: RobertaSpec, device=None):
        super().__init__()
        self.dense = nn.Linear(d_in, s.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(s.hidden_size, eps=s.layer_norm_eps,
                                      device=device)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(h) + residual)


class RobertaAttention(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.self = RobertaSelfAttention(s, device=device)
        self.output = RobertaSelfOutput(s.hidden_size, s, device=device)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class RobertaIntermediate(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.dense = nn.Linear(s.hidden_size, s.intermediate_size,
                               device=device)

    def forward(self, x):
        return F.gelu(self.dense(x))


class RobertaLayer(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.attention = RobertaAttention(s, device=device)
        self.intermediate = RobertaIntermediate(s, device=device)
        self.output = RobertaSelfOutput(s.intermediate_size, s, device=device)

    def forward(self, x, bias):
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class RobertaEncoder(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.layer = nn.ModuleList(RobertaLayer(s, device=device)
                                   for _ in range(s.num_layers))


class RobertaPooler(nn.Module):
    """In the state_dict only: the JAX package never reads the pooled
    output."""

    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.dense = nn.Linear(s.hidden_size, s.hidden_size, device=device)


class RobertaModel(nn.Module):
    def __init__(self, s: RobertaSpec, device=None):
        super().__init__()
        self.spec = s
        self.embeddings = RobertaEmbeddings(s, device=device)
        self.encoder = RobertaEncoder(s, device=device)
        self.pooler = RobertaPooler(s, device=device)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """ids, mask (N, L) -> last hidden state (N, L, hidden)."""
        x = self.embeddings(ids)
        neg = torch.finfo(x.dtype).min
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, neg).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x

    def flax_init_(self, generator: torch.Generator) -> None:
        """HF Flax RoBERTa's initializers: every Dense kernel and embedding
        normal(0, initializer_range), biases zero, LayerNorms unit."""
        std = self.spec.initializer_range
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Embedding)):
                    nn.init.normal_(m.weight, 0.0, std, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()


class TextEncoder(nn.Module):
    """The RoBERTa encoder under the name `text_encoder` and its tokenizer:
    what the JAX package's TextEncoderBundle holds (text_encoder.py:22-28).
    `forward(ids, mask)` is its `apply_fn`; `tokenize(raw_per_video, G,
    max_len)` its `tokenize`, numpy out."""

    def __init__(self, spec: RobertaSpec, device=None):
        super().__init__()
        self.text_encoder = RobertaModel(spec, device=device)
        self.hidden_size = spec.hidden_size
        self._tok = HashTokenizer(spec.vocab_size)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                bf16_weights: bool = False) -> torch.Tensor:
        """Last hidden state (N, L, hidden). With bf16_weights, the pass
        the JAX package makes over `bf16_cast_tree(text_params)`
        (gvl_tpu/utils/amp.py:11-18; train_use_amp, eval_use_amp): every
        weight rounded to bfloat16 inside autograd, the arithmetic f32, as
        Flax's f32 layers promote the bf16 weights back; the weights'
        gradients come out rounded to bfloat16, as the cast's transpose
        rounds them. Not autocast, which would run the products in bf16."""
        if not bf16_weights:
            return self.text_encoder(ids, mask)
        rounded = {n: p.to(torch.bfloat16).to(p.dtype)
                   for n, p in self.text_encoder.named_parameters()}
        return torch.func.functional_call(self.text_encoder, rounded,
                                          (ids, mask))

    def tokenize(self, raw_per_video: List[List[str]], G: int, max_len: int):
        return _batch_tokenize(self._tok, raw_per_video, G, max_len)


def load_text_encoder(cfg: Any, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> Optional[TextEncoder]:
    """The offline RoBERTa for `cfg` (None when enable_contrastive is off),
    frozen and in eval mode, on `device`: the current CUDA device when none
    is given (raising where there is none). Its weights are drawn with HF
    Flax's initializers from `generator`, by default one seeded with
    cfg.seed; load others with `load_state_dict` (gvl_tpu_torch.convert
    .flax_roberta_to_state_dict). Raises NotImplementedError unless
    cfg.load_pretrained_language_model_from_config is set: the pretrained
    weights are not available to the port."""
    if not getattr(cfg, "enable_contrastive", False):
        return None
    if not getattr(cfg, "load_pretrained_language_model_from_config", None):
        name = getattr(cfg, "pretrained_language_model", "roberta-base")
        raise NotImplementedError(
            f"load_text_encoder: the pretrained text weights "
            f"(pretrained_language_model={name!r}) are not available to the "
            "port; set load_pretrained_language_model_from_config to build "
            "the offline RoBERTa from offline_text_encoder_hidden / "
            "offline_text_encoder_layers")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_text_encoder: no CUDA device is available; pass "
                "device='cpu' to build the text encoder on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    spec = RobertaSpec.offline(cfg)
    with torch.device("meta"):
        enc = TextEncoder(spec, device="meta")
    enc = enc.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(getattr(cfg, "seed", 777)))
    enc.text_encoder.flax_init_(generator)
    return enc.requires_grad_(False).eval()
