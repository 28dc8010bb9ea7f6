"""The text encoder of the contrastive side: a RoBERTa encoder in plain
torch, its tokenizers and the loader.

Port of gvl_tpu/models/text_encoder.py. Two routes, as the JAX package's:
- pretrained (load_pretrained_language_model_from_config unset, every
  published yml): `pretrained_language_model` (a directory, or a hub name
  under huggingface_cache_dir) read from local files through
  gvl_tpu_torch.utils.hf_files: `RobertaSpec` from its config.json, the
  weights by HF's rules for the base model (`roberta_base_state_dict`), the
  byte-level BPE of gvl_tpu_torch.models.bpe as its tokenizer, where the
  JAX package calls HF's `from_pretrained` (text_encoder.py:70-87). Files
  that are not there, or a `model_type` other than roberta, are refused by
  name; the JAX package falls back silently to the offline model instead.
- offline (the flag set): `FlaxRobertaModel(RobertaConfig(...))` with
  random weights and `HashTokenizer` (text_encoder.py:91-110).

What the encoder computes, as HF Flax RoBERTa does:
- position ids start at pad id + 1 = 2 and count non-pad tokens only;
- one token type (id 0);
- LayerNorm eps from the config: 1e-12 offline (`RobertaConfig()`'s),
  1e-5 for roberta-base;
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
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.config import Config
from gvl_tpu_torch.models.bpe import ByteLevelBPE
from gvl_tpu_torch.utils import hf_files


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
    """G, the sentence slots of a video: the port's
    `Config.effective_max_gt_events`, read on any config object that has
    max_gt_events and gt_proposal_sample_num."""
    return Config.effective_max_gt_events.fget(cfg)


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

    @classmethod
    def from_hf_config(cls, c: dict, where: str = "") -> "RobertaSpec":
        """The spec of an HF RoBERTa config.json; any other model_type, and
        a RoBERTa the encoder does not compute (another activation or
        position embedding), is refused by name."""
        if c.get("model_type") != "roberta":
            raise NotImplementedError(
                f"load_text_encoder: model_type {c.get('model_type')!r} "
                f"({where}) is not ported: the port's text encoder is "
                "RoBERTa (ROADMAP Queue 1, other text encoders)")
        for key, want in (("hidden_act", "gelu"),
                          ("position_embedding_type", "absolute")):
            if c.get(key, want) != want:
                raise NotImplementedError(
                    f"load_text_encoder: {key}={c[key]!r} ({where}) is not "
                    f"ported (the port's RoBERTa computes {want!r})")
        return cls(vocab_size=int(c["vocab_size"]),
                   hidden_size=int(c["hidden_size"]),
                   num_layers=int(c["num_hidden_layers"]),
                   num_heads=int(c["num_attention_heads"]),
                   intermediate_size=int(c["intermediate_size"]),
                   max_positions=int(c["max_position_embeddings"]),
                   type_vocab_size=int(c.get("type_vocab_size", 1)),
                   pad_token_id=int(c.get("pad_token_id", 1)),
                   layer_norm_eps=float(c.get("layer_norm_eps", 1e-12)),
                   initializer_range=float(c.get("initializer_range", 0.02)))


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

    def __init__(self, spec: RobertaSpec, device=None, tokenizer=None):
        super().__init__()
        self.text_encoder = RobertaModel(spec, device=device)
        self.hidden_size = spec.hidden_size
        self._tok = tokenizer or HashTokenizer(spec.vocab_size)

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


def _pretrained(cfg: Any) -> Optional[Tuple[str, RobertaSpec]]:
    """(directory, spec from its config.json) of `cfg`'s pretrained text
    encoder, or None for the offline one
    (load_pretrained_language_model_from_config set). Raises
    FileNotFoundError naming every path searched when the files are not
    there, NotImplementedError for a model the port does not run."""
    if getattr(cfg, "load_pretrained_language_model_from_config", None):
        return None
    name = getattr(cfg, "pretrained_language_model", "roberta-base")
    try:
        folder = hf_files.resolve(name, getattr(cfg, "huggingface_cache_dir",
                                                None))
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"load_text_encoder: pretrained_language_model={name!r}: {e}; "
            "set load_pretrained_language_model_from_config for the "
            "offline RoBERTa") from None
    return folder, RobertaSpec.from_hf_config(
        hf_files.read_json(folder, "config.json"), folder)


def _check_ported(cfg: Any) -> None:
    """Raise what `load_text_encoder(cfg)` would refuse, reading only the
    config.json of the pretrained route."""
    _pretrained(cfg)


def roberta_base_state_dict(sd: dict) -> Tuple[dict, List[str]]:
    """HF's rules for loading a checkpoint into the base `RobertaModel`: the
    `roberta.` prefix stripped (a `RobertaForMaskedLM` save), `gamma` /
    `beta` renamed `weight` / `bias`, and the keys a base model has no
    place for (`lm_head.*`, the `position_ids` buffer, any other head)
    dropped. Returns (state_dict, dropped keys)."""
    out, dropped = {}, []
    prefixed = any(k.startswith("roberta.") for k in sd)
    for key, v in sd.items():
        k = key
        if prefixed:
            if not k.startswith("roberta."):
                dropped.append(key)
                continue
            k = k[len("roberta."):]
        k = k.replace("LayerNorm.gamma", "LayerNorm.weight").replace(
            "LayerNorm.beta", "LayerNorm.bias")
        if k.endswith("position_ids") or k.split(".")[0] not in (
                "embeddings", "encoder", "pooler"):
            dropped.append(key)
            continue
        out[k] = v
    return out, dropped


def load_text_encoder(cfg: Any, device=None,
                      generator: Optional[torch.Generator] = None
                      ) -> Optional[TextEncoder]:
    """The text encoder for `cfg` (None when enable_contrastive is off),
    frozen and in eval mode, on `device`: the current CUDA device when none
    is given (raising where there is none).

    Every weight is first drawn with HF's initializers (normal(0,
    initializer_range), biases zero, LayerNorms unit) from `generator`, by
    default one seeded with cfg.seed. On the pretrained route the
    checkpoint's weights then replace them; a pooler the checkpoint lacks
    (an MLM checkpoint has none) keeps its draw, as HF draws it, and any
    other missing weight is refused. Offline, load others with
    `load_state_dict` (gvl_tpu_torch.convert.flax_roberta_to_state_dict)."""
    if not getattr(cfg, "enable_contrastive", False):
        return None
    found = _pretrained(cfg)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "load_text_encoder: no CUDA device is available; pass "
                "device='cpu' to build the text encoder on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    if found is None:
        folder, spec, tok = None, RobertaSpec.offline(cfg), None
    else:
        folder, spec = found
        tok = ByteLevelBPE.from_dir(folder)
    with torch.device("meta"):
        enc = TextEncoder(spec, device="meta", tokenizer=tok)
    enc = enc.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(
            int(getattr(cfg, "seed", 777)))
    enc.text_encoder.flax_init_(generator)
    if folder is not None:
        sd, _ = roberta_base_state_dict(hf_files.read_weights(folder))
        own = enc.text_encoder.state_dict()
        missing = [k for k in own if k not in sd and
                   not k.startswith("pooler.")]
        extra = [k for k in sd if k not in own]
        if missing or extra:
            raise ValueError(f"load_text_encoder: the weights in {folder} "
                             f"lack {missing} and have no place for {extra}")
        enc.text_encoder.load_state_dict(
            {k: v.float() for k, v in sd.items()}, strict=False)
    return enc.requires_grad_(False).eval()
