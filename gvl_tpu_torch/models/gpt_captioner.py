"""The GPT-2 (ClipCap) caption head, and the cached self-attention the
transformer caption head is built on.

Port of gvl_tpu/models/gpt_captioner.py:
- `GPT2Spec` (:24-36), the head's widths;
- `PrefixMapper` (:38-69): the event feature (prefix_size wide) to
  prefix_length GPT-2 token embeddings, through a tanh MLP (`mlp`, hidden
  P*E//2) or `prefix_num_mapping_layer` post-LN self-attention blocks over
  [projected feature ; learned constants] (`transformer`: 8 heads, LayerNorm
  eps 1e-6, a ReLU FFN of 2E), whose last P positions are the prefix;
- `MiniGPT2` (:121-196): pre-LN blocks with LayerNorm eps 1e-5, learned
  positions, a fused query/key/value projection, tanh-approximate GELU and
  the LM head tied to the token embedding; `prime` runs the prefix and
  keeps each layer's keys and values, `step` one token against them;
- `GPT2Captioner` (:198-312): the per-caption loss of the positions P-1 ..
  P+Lg-2 (the prefix excluded by slicing), the mean NLL over the token mask
  with a floor of 1; greedy `sample` with the stop token: the cached loop of
  entry_length steps, its early-exit form (the stop read on the host after
  every step, the steps JAX's while_loop does not run left at token 0,
  prob 0 and mask False) and the re-forward oracle (use_cache=False);
- `load_gpt2_spec` (:315-326), the offline spec only: pretrained GPT-2
  files are not available to the port, and it refuses by name what the JAX
  package would fetch (or replace silently by the offline spec when the
  fetch fails, :338-345).
The attention is a plain matmul-softmax (the JAX head's
nn.dot_product_attention): queries scaled by 1/sqrt(Dh), masked logits at
the type's most negative value, softmax in the logits' type.

Parameter names are the reference ClipCap head's state_dict
(pdvc/CaptioningHead/GPT.py): `gpt.transformer.{wte,wpe}.weight`,
`gpt.transformer.h.{i}.{ln_1,attn.c_attn,attn.c_proj,ln_2,mlp.c_fc,
mlp.c_proj}.*`, `gpt.transformer.ln_f.*`, with HF's Conv1D orientation
(weight (in, out)), so that an HF GPT-2 state_dict loads as it is; the MLP
mapper's `clip_project.model.{0,2}.*` (torch Linear orientation). The
transformer mapper has no reference layout and keeps the Flax paths
(`clip_project.Dense_0`, `clip_project.prefix_const`,
`clip_project.attn_{i}.{query,key,value,out}`, `clip_project.ln1_{i}`,
`ffn1_{i}`, `ffn2_{i}`, `ln2_{i}`).

`CachedSelfAttention` (:71-119) keeps the layout of Flax's
nn.MultiHeadDotProductAttention: `query`, `key`, `value` (DenseGeneral
kernels (E, H, Dh) -> Linear weights (H*Dh, E)) and `out` ((H, Dh, E') ->
(E', H*Dh)).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.layers import lecun_normal_

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], dropout: float = 0.0
           ) -> torch.Tensor:
    """Flax's nn.dot_product_attention: q (N, Lq, H, Dh), k and v (N, Lk, H,
    Dh), mask broadcastable to (N, H, Lq, Lk) (True = attend), dropout on
    the weights when > 0 -> (N, Lq, H*Dh)."""
    q = q / math.sqrt(q.shape[-1])
    logits = torch.einsum("nqhd,nkhd->nhqk", q, k)
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    w = torch.softmax(logits, dim=-1)
    if dropout > 0:
        w = F.dropout(w, dropout)
    ctx = torch.einsum("nhqk,nkhd->nqhd", w, v)
    return ctx.reshape(ctx.shape[:2] + (-1,))


class CachedSelfAttention(nn.Module):
    """Multi-head dot-product self-attention, Flax's
    nn.MultiHeadDotProductAttention with its parameter layout (`attend`),
    dropout on the attention weights in train mode.

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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x (N, L, E) -> (N, L, E')."""
        q, k, v = (self._heads(f(x)) for f in (self.query, self.key,
                                               self.value))
        p = self.dropout_rate if self.training else 0.0
        return self.out(attend(q, k, v, mask, p))

    def step(self, x_t: torch.Tensor, cache: Cache) -> torch.Tensor:
        """One decode step: x_t (N, 1, E) at the position len(cache). Appends
        its key and value to `cache` and attends over every cached position,
        its own included, without dropout, as the JAX step. Returns
        (N, 1, E')."""
        q = self._heads(self.query(x_t))
        cache.append((self._heads(self.key(x_t)),
                      self._heads(self.value(x_t))))
        k = torch.cat([kv[0] for kv in cache], dim=1)
        v = torch.cat([kv[1] for kv in cache], dim=1)
        return self.out(attend(q, k, v, None))


# ---------------------------------------------------------------------------
# the GPT-2 head
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GPT2Spec:
    """The head's widths (gpt_captioner.py:24-36); the defaults are GPT-2
    small's published ones."""
    vocab_size: int = 50257
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    prefix_length: int = 10
    prefix_size: int = 512
    mapping_type: str = "mlp"           # 'mlp' | 'transformer'
    prefix_num_mapping_layer: int = 8
    stop_token_id: int = 13             # '.' for the real gpt2 tokenizer
    n_positions: int = 1024


def load_gpt2_spec(cfg: Any) -> GPT2Spec:
    """The spec the JAX package builds offline (gpt_captioner.py:320-326):
    vocab 1000, 128 wide, 2 layers of 4 heads, 2 mapping layers, stop token
    13, with the config's prefix_length and prefix_size. Raises
    NotImplementedError unless load_pretrained_language_model_from_config
    is 'offline': the pretrained gpt_model's files are not available to the
    port (ROADMAP Queue 1 item 12)."""
    if str(getattr(cfg, "load_pretrained_language_model_from_config", "")
           ) != "offline":
        raise NotImplementedError(
            f"load_gpt2_spec: the pretrained GPT-2 (gpt_model="
            f"{getattr(cfg, 'gpt_model', 'gpt2')!r}) is not available to the "
            "port (ROADMAP Queue 1 item 12); set "
            "load_pretrained_language_model_from_config to 'offline' for the "
            "offline GPT-2 spec")
    return GPT2Spec(vocab_size=1000, n_embd=128, n_layer=2, n_head=4,
                    prefix_length=int(cfg.prefix_length),
                    prefix_size=int(cfg.prefix_size),
                    prefix_num_mapping_layer=2, stop_token_id=13)


def _embed_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default nn.Embed init: normal with variance 1 / features."""
    nn.init.normal_(w, 0.0, 1.0 / math.sqrt(w.shape[1]), generator=generator)


class Conv1D(nn.Module):
    """HF GPT-2's Conv1D: y = x @ weight + bias with weight (in, out), the
    Flax Dense kernel's orientation."""

    def __init__(self, n_in: int, n_out: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.empty(n_out, device=device))

    def flax_init_(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight.T, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.T, self.bias)


class GPT2Attention(nn.Module):
    """Causal self-attention with the fused query/key/value projection
    (`c_attn`, split in that order) and the output projection `c_proj`."""

    def __init__(self, n_embd: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.c_attn = Conv1D(n_embd, 3 * n_embd, device=device)
        self.c_proj = Conv1D(n_embd, n_embd, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                cache: Optional[Cache] = None) -> torch.Tensor:
        """x (N, L, E). With `cache` (a list, the layer's keys and values so
        far) this call's keys and values are appended and the queries attend
        over all of them."""
        N, L, E = x.shape
        q, k, v = (t.reshape(N, L, self.n_head, E // self.n_head)
                   for t in self.c_attn(x).split(E, dim=-1))
        if cache is not None:
            cache.append((k, v))
            k = torch.cat([kv[0] for kv in cache], dim=1)
            v = torch.cat([kv[1] for kv in cache], dim=1)
        return self.c_proj(attend(q, k, v, mask))


class GPT2MLP(nn.Module):
    def __init__(self, n_embd: int, device=None):
        super().__init__()
        self.c_fc = Conv1D(n_embd, 4 * n_embd, device=device)
        self.c_proj = Conv1D(4 * n_embd, n_embd, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's nn.gelu is the tanh approximation by default
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, n_embd: int, n_head: int, device=None):
        super().__init__()
        self.ln_1 = nn.LayerNorm(n_embd, eps=1e-5, device=device)
        self.attn = GPT2Attention(n_embd, n_head, device=device)
        self.ln_2 = nn.LayerNorm(n_embd, eps=1e-5, device=device)
        self.mlp = GPT2MLP(n_embd, device=device)

    def forward(self, x, mask, cache: Optional[Cache] = None):
        x = x + self.attn(self.ln_1(x), mask, cache)
        return x + self.mlp(self.ln_2(x))


class GPT2Body(nn.Module):
    """Token and position embeddings, the blocks and the final LayerNorm:
    HF GPT2Model's `transformer.*` names."""

    def __init__(self, spec: GPT2Spec, device=None):
        super().__init__()
        s = spec
        self.wte = nn.Embedding(s.vocab_size, s.n_embd, device=device)
        self.wpe = nn.Embedding(s.n_positions, s.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(s.n_embd, s.n_head, device=device)
                               for _ in range(s.n_layer))
        self.ln_f = nn.LayerNorm(s.n_embd, eps=1e-5, device=device)

    def flax_init_(self, generator: torch.Generator) -> None:
        _embed_init_(self.wte.weight, generator)
        _embed_init_(self.wpe.weight, generator)


class MiniGPT2(nn.Module):
    """GPT-2 over input embeddings (gpt_captioner.py:121-196); `transformer`
    holds the parameters, the LM head is the token embedding's transpose."""

    def __init__(self, spec: GPT2Spec, device=None):
        super().__init__()
        self.transformer = GPT2Body(spec, device=device)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer.wte(tokens.long())

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        """The tied LM head over final hidden states h (..., E)."""
        return F.linear(h, self.transformer.wte.weight)

    def hidden(self, inputs_embeds: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               caches: Optional[List[Cache]] = None, start: int = 0
               ) -> torch.Tensor:
        """Final hidden states (N, L, E) of inputs at positions start ..
        start+L-1. attention_mask (N, L): the keys to attend, under the
        causal mask. With `caches` (one list per layer) each layer's keys
        and values are appended there and the inputs attend over every
        cached position too (no mask: a cached step sees all of them)."""
        tr = self.transformer
        N, L, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        x = inputs_embeds + tr.wpe(torch.arange(start, start + L,
                                                device=dev))[None]
        mask = None
        if caches is None or L > 1:
            mask = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
            mask = mask[None, None]
            if attention_mask is not None:
                mask = mask & attention_mask.bool()[:, None, None, :]
        for i, block in enumerate(tr.h):
            x = block(x, mask, None if caches is None else caches[i])
        return tr.ln_f(x)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """Logits (N, L, V) of every position (gpt_captioner.py:147-159)."""
        return self.lm_logits(self.hidden(inputs_embeds, attention_mask))

    def prime(self, inputs_embeds: torch.Tensor
              ) -> Tuple[torch.Tensor, List[Cache]]:
        """The prefix forward (gpt_captioner.py:161-178): the last
        position's logits (N, V) and each layer's cache of the prefix's
        keys and values."""
        caches: List[Cache] = [[] for _ in self.transformer.h]
        h = self.hidden(inputs_embeds, caches=caches)
        return self.lm_logits(h[:, -1]), caches

    def step(self, x_t: torch.Tensor, pos: int, caches: List[Cache]
             ) -> torch.Tensor:
        """One cached decode step (gpt_captioner.py:180-195): x_t (N, 1, E),
        the token embedding at position `pos` (the number of tokens
        cached). Appends to `caches`; returns the logits (N, V)."""
        h = self.hidden(x_t, caches=caches, start=pos)
        return self.lm_logits(h[:, 0])


class PrefixMapper(nn.Module):
    """The event feature (N, prefix_size) -> (N, P, E) prefix embeddings
    (gpt_captioner.py:38-69)."""

    def __init__(self, spec: GPT2Spec, device=None):
        super().__init__()
        s = self.spec = spec
        P, E = s.prefix_length, s.n_embd
        if s.mapping_type == "mlp":
            # (prefix_size, P*E//2, P*E) with tanh, the reference ClipCap MLP
            self.model = nn.Sequential(
                nn.Linear(s.prefix_size, P * E // 2, device=device), nn.Tanh(),
                nn.Linear(P * E // 2, P * E, device=device))
            return
        self.Dense_0 = nn.Linear(s.prefix_size, P * E, device=device)
        self.prefix_const = nn.Parameter(torch.empty(P, E, device=device))
        for i in range(s.prefix_num_mapping_layer):
            setattr(self, f"attn_{i}", CachedSelfAttention(E, 8, E,
                                                           device=device))
            setattr(self, f"ln1_{i}", nn.LayerNorm(E, eps=1e-6,
                                                   device=device))
            setattr(self, f"ffn1_{i}", nn.Linear(E, 2 * E, device=device))
            setattr(self, f"ffn2_{i}", nn.Linear(2 * E, E, device=device))
            setattr(self, f"ln2_{i}", nn.LayerNorm(E, eps=1e-6,
                                                   device=device))

    def flax_init_(self, generator: torch.Generator) -> None:
        if self.spec.mapping_type != "mlp":
            nn.init.normal_(self.prefix_const, 0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.spec
        P, E = s.prefix_length, s.n_embd
        if s.mapping_type == "mlp":
            return self.model(x).reshape(x.shape[0], P, E)
        h = self.Dense_0(x).reshape(x.shape[0], P, E)
        z = torch.cat([h, self.prefix_const[None].expand_as(h)], dim=1)
        for i in range(s.prefix_num_mapping_layer):
            z = getattr(self, f"ln1_{i}")(z + getattr(self, f"attn_{i}")(z))
            f = getattr(self, f"ffn2_{i}")(
                F.relu(getattr(self, f"ffn1_{i}")(z)))
            z = getattr(self, f"ln2_{i}")(z + f)
        return z[:, P:]


class GPT2Captioner(nn.Module):
    """Prefix + GPT-2 LM (gpt_captioner.py:198-312). It has no dropout, so
    its train and eval modes compute alike."""

    def __init__(self, spec: GPT2Spec, device=None):
        super().__init__()
        self.spec = spec
        self.gpt = MiniGPT2(spec, device=device)
        self.clip_project = PrefixMapper(spec, device=device)

    def forward(self, prefix: torch.Tensor, tokens: torch.Tensor,
                token_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """prefix (N, prefix_size); tokens and token_mask (N, Lg). Returns
        (the loss of each caption (N,), the logits of the positions that
        predict tokens 0 .. Lg-1 (N, Lg, V))."""
        P = self.spec.prefix_length
        N = tokens.shape[0]
        x = torch.cat([self.clip_project(prefix), self.gpt.embed(tokens)],
                      dim=1)
        full_mask = torch.cat([token_mask.new_ones(N, P), token_mask], dim=1)
        # positions P-1 .. P+Lg-2 predict the tokens; the LM head reads only
        # those (the prefix is labeled -100 in the reference)
        pred = self.gpt.lm_logits(self.gpt.hidden(x, full_mask)[:, P - 1:-1])
        lp = torch.log_softmax(pred, dim=-1)
        picked = torch.gather(lp, -1, tokens.long()[..., None])[..., 0]
        m = token_mask.to(lp.dtype)
        loss = -(picked * m).sum(-1) / m.sum(-1).clamp(min=1.0)
        return loss, pred

    def sample(self, prefix: torch.Tensor, entry_length: int = 30,
               use_cache: bool = True, early_exit: bool = False):
        """Greedy decode (gpt_captioner.py:231-312). Returns (tokens (N, L)
        int64, the probability of each chosen token (N, L) f32, the mask
        (N, L) of the steps before each caption's stop token). The fixed
        loop keeps decoding past the stop; with early_exit the loop stops
        once every caption has emitted it, read on the host after each step,
        and the steps not run keep token 0, prob 0 and mask False, as JAX's
        while_loop leaves them. use_cache=False re-runs the whole sequence
        for every token (the JAX package's numerical oracle)."""
        s = self.spec
        P = s.prefix_length
        N = prefix.shape[0]
        prefix_emb = self.clip_project(prefix)
        toks, probs, masks = [], [], []
        alive = None
        if use_cache:
            logits, caches = self.gpt.prime(prefix_emb)
        else:
            x = prefix_emb
            logits = self.gpt.lm_logits(self.gpt.hidden(x)[:, -1])
        for t in range(entry_length):
            nt = logits.argmax(dim=-1)
            p = torch.softmax(logits, dim=-1).amax(dim=-1)
            stop = nt == s.stop_token_id
            alive = ~stop if t == 0 else alive & ~stop
            toks.append(nt)
            probs.append(p.float())
            masks.append(alive)
            if early_exit and use_cache and not bool(alive.any()):
                break
            if t == entry_length - 1:
                break
            emb = self.gpt.embed(nt[:, None])
            if use_cache:
                logits = self.gpt.step(emb, P + t, caches)
            else:
                x = torch.cat([x, emb], dim=1)
                logits = self.gpt.lm_logits(self.gpt.hidden(x)[:, -1])
        toks, probs = torch.stack(toks, 1), torch.stack(probs, 1)
        masks = torch.stack(masks, 1)
        pad = entry_length - toks.shape[1]
        if pad:
            toks, probs = F.pad(toks, (0, pad)), F.pad(probs, (0, pad))
            masks = F.pad(masks, (0, pad))
        return toks, probs, masks
