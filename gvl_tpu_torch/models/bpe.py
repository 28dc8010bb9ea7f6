"""The byte-level BPE tokenizer that RoBERTa and GPT-2 share, in the
standard library only.

It reads what `AutoTokenizer.from_pretrained` reads for these models:
`vocab.json`, `merges.txt`, and `tokenizer_config.json` and
`special_tokens_map.json` where they exist (the model's `config.json`
`model_type` picks the flavour when tokenizer_config.json does not name
it). The added tokens and their flags come from tokenizer_config.json's
`added_tokens_decoder`, else from `tokenizer.json`'s `added_tokens`, else
from the HF class's defaults (RoBERTa's `<mask>` takes the spaces on its
left); every other setting the files leave out takes the HF class's
default, as on the hub's roberta-base (no tokenizer_config.json) and gpt2
(only model_max_length). HF's fast tokenizer on the same files is the
reference (the JAX package tokenizes with it,
gvl_tpu/models/text_encoder.py:105-110, gvl_tpu/train/loop.py:88-127):
- special and added tokens in the text are split off first (an lstrip
  token, as RoBERTa's `<mask>`, takes the spaces on its left);
- pre-tokenization by GPT-2's pattern `'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
  ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`, scanned by hand with
  `unicodedata` categories (stdlib `re` has no \\p{..}; its \\w and \\d
  would take other categories for letters and numbers) and Unicode's
  White_Space for \\s;
- each piece's UTF-8 bytes through GPT-2's byte-to-unicode table, then the
  merges by rank, cached per piece;
- RoBERTa wraps a sequence in `<s> ... </s>`; GPT-2 adds nothing;
- `__call__(texts, max_len)` pads to max_len and truncates
  (`padding="max_length", truncation=True`): ids and attention mask, int32;
- `decode` joins the tokens, maps them back to bytes (UTF-8, invalid
  sequences replaced) and applies `clean_up_tokenization_spaces` when the
  saved config sets it.
A tokenizer with no pad token (GPT-2's) raises on padding, as HF does.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gvl_tpu_torch.utils import hf_files

# Unicode's White_Space property, which the GPT-2 pattern's \s matches
_WHITE_SPACE = frozenset(chr(c) for c in (
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
    *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000))
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# defaults of the HF tokenizer classes when no tokenizer_config says
_FLAVOURS = {
    "roberta": dict(bos_token="<s>", eos_token="</s>", sep_token="</s>",
                    cls_token="<s>", unk_token="<unk>", pad_token="<pad>",
                    mask_token="<mask>", wrap=True,
                    lstrip=("mask_token",)),
    "gpt2": dict(bos_token="<|endoftext|>", eos_token="<|endoftext|>",
                 unk_token="<|endoftext|>", pad_token=None, wrap=False,
                 lstrip=()),
}
_CLASSES = {"RobertaTokenizer": "roberta", "RobertaTokenizerFast": "roberta",
            "GPT2Tokenizer": "gpt2", "GPT2TokenizerFast": "gpt2"}
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


def _is_space(c: str) -> bool:
    return c in _WHITE_SPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _run(text: str, i: int, pred) -> int:
    """The end of the run of characters from i that satisfy `pred`."""
    n = len(text)
    while i < n and pred(text[i]):
        i += 1
    return i


def _other(c: str) -> bool:
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def pre_tokenize(text: str) -> List[str]:
    """GPT-2's split of `text` (the pattern of the module docstring, its
    alternatives tried in order at each position, as a backtracking regex
    engine tries them)."""
    out, i, n = [], 0, len(text)
    while i < n:
        for c in _CONTRACTIONS:
            if text.startswith(c, i):
                out.append(c)
                i += len(c)
                break
        else:
            j = i + 1 if text[i] == " " and i + 1 < n else i
            end = None
            for pred in (_is_letter, _is_number, _other):
                if pred(text[j]):
                    end = _run(text, j, pred)
                    break
            if end is None:
                # \s+(?!\S), else \s+
                end = _run(text, i, _is_space)
                if end < n and end - i > 1:
                    end -= 1
            out.append(text[i:end])
            i = end
    return out


@lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: the printable bytes map to themselves, the others to
    the code points from 256 up, in order."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def clean_up_tokenization(s: str) -> str:
    """transformers' `clean_up_tokenization`."""
    return (s.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _content(tok) -> Optional[str]:
    """A special token's string, given as a string or an AddedToken dict."""
    if isinstance(tok, dict):
        return tok.get("content")
    return tok


class ByteLevelBPE:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 flavour: str = "roberta", add_prefix_space: bool = False,
                 clean_up_tokenization_spaces: bool = False,
                 special: Optional[Dict[str, Optional[str]]] = None,
                 added: Optional[Dict[int, dict]] = None):
        if flavour not in _FLAVOURS:
            raise NotImplementedError(
                f"ByteLevelBPE: tokenizer flavour {flavour!r} is not ported "
                f"(ported: {', '.join(_FLAVOURS)})")
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.flavour = flavour
        self.add_prefix_space = bool(add_prefix_space)
        self.clean_up_tokenization_spaces = bool(clean_up_tokenization_spaces)
        defaults = _FLAVOURS[flavour]
        self.special = {k: defaults.get(k) for k in _SPECIAL_KEYS}
        self.special.update(special or {})
        # tokens split off the text before pre-tokenization: the added
        # tokens of tokenizer_config.json and every special token
        self.added: Dict[str, dict] = {}
        for i, info in sorted((added or {}).items()):
            self.added[info["content"]] = dict(info, id=int(i))
            self.ids_to_tokens.setdefault(int(i), info["content"])
        for key, tok in self.special.items():
            if tok is not None and tok not in self.added:
                self.added[tok] = dict(content=tok,
                                       lstrip=key in defaults["lstrip"],
                                       rstrip=False, id=self.token_id(tok))
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: Dict[str, List[int]] = {}

    # ---------------------------------------------------------------- files
    @classmethod
    def from_dir(cls, folder: str) -> "ByteLevelBPE":
        """The tokenizer of an HF model directory (see the module
        docstring)."""
        need = [os.path.join(folder, n) for n in ("vocab.json", "merges.txt")]
        missing = [p for p in need if not os.path.isfile(p)]
        if missing:
            raise FileNotFoundError(
                f"byte-level BPE files not found: {', '.join(missing)}")
        with open(need[0], encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(need[1], encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("#version") or not line.strip():
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        tcfg = hf_files.read_json(folder, "tokenizer_config.json") or {}
        smap = hf_files.read_json(folder, "special_tokens_map.json") or {}
        mcfg = hf_files.read_json(folder, "config.json") or {}
        klass = tcfg.get("tokenizer_class")
        flavour = _CLASSES.get(klass) if klass else mcfg.get("model_type")
        if flavour not in _FLAVOURS:
            raise NotImplementedError(
                f"{folder}: tokenizer {klass or mcfg.get('model_type')!r} is "
                "not ported (the port reads the RoBERTa and GPT-2 byte-level "
                "BPE tokenizers)")
        special = {}
        for k in _SPECIAL_KEYS:
            for src in (smap, tcfg):
                if k in src:
                    special[k] = _content(src[k])
        if "added_tokens_decoder" in tcfg:
            added = {int(i): dict(info) for i, info in
                     tcfg["added_tokens_decoder"].items()}
        else:
            tj = hf_files.read_json(folder, "tokenizer.json") or {}
            added = {int(t["id"]): dict(t) for t in tj.get("added_tokens",
                                                           [])}
        return cls(vocab, merges, flavour,
                   add_prefix_space=tcfg.get("add_prefix_space", False),
                   clean_up_tokenization_spaces=tcfg.get(
                       "clean_up_tokenization_spaces", False),
                   special=special, added=added)

    # ---------------------------------------------------------------- ids
    def token_id(self, tok: str) -> int:
        if tok in self.vocab:
            return self.vocab[tok]
        if tok in self.added:
            return self.added[tok]["id"]
        unk = self.special.get("unk_token")
        if unk is not None and unk in self.vocab:
            return self.vocab[unk]
        raise KeyError(f"token {tok!r} is not in the vocabulary")

    @property
    def pad_token_id(self) -> Optional[int]:
        pad = self.special.get("pad_token")
        return None if pad is None else self.token_id(pad)

    def _bpe(self, piece: str) -> List[int]:
        """The ids of one pre-tokenized piece (bytes mapped, then merged by
        rank)."""
        hit = self._cache.get(piece)
        if hit is not None:
            return hit
        word = [self.byte_encoder[b] for b in piece.encode("utf-8")]
        while len(word) > 1:
            best, rank = None, None
            for k in range(len(word) - 1):
                r = self.ranks.get((word[k], word[k + 1]))
                if r is not None and (rank is None or r < rank):
                    best, rank = (word[k], word[k + 1]), r
            if best is None:
                break
            merged, k = [], 0
            while k < len(word):
                if k < len(word) - 1 and (word[k], word[k + 1]) == best:
                    merged.append(word[k] + word[k + 1])
                    k += 2
                else:
                    merged.append(word[k])
                    k += 1
            word = merged
        ids = [self.token_id(t) for t in word]
        self._cache[piece] = ids
        return ids

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """`text` cut into (segment, is_added_token) at the added and
        special tokens, longest first; an lstrip (rstrip) token takes the
        whitespace on its left (right)."""
        out: List[Tuple[str, bool]] = []
        toks = sorted(self.added, key=len, reverse=True)
        i = start = 0
        while i < len(text):
            for tok in toks:
                if text.startswith(tok, i):
                    info = self.added[tok]
                    left = i
                    if info.get("lstrip"):
                        while left > start and text[left - 1].isspace():
                            left -= 1
                    if left > start:
                        out.append((text[start:left], False))
                    out.append((tok, True))
                    i += len(tok)
                    if info.get("rstrip"):
                        while i < len(text) and text[i].isspace():
                            i += 1
                    start = i
                    break
            else:
                i += 1
        if start < len(text):
            out.append((text[start:], False))
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of `text`, with no special tokens around them (HF's
        `encode(text, add_special_tokens=False)`)."""
        ids: List[int] = []
        for k, (seg, is_added) in enumerate(self._split_added(text)):
            if is_added:
                ids.append(self.added[seg]["id"])
                continue
            if self.add_prefix_space and k == 0 and not seg.startswith(" "):
                seg = " " + seg
            for piece in pre_tokenize(seg):
                ids.extend(self._bpe(piece))
        return ids

    def __call__(self, texts: Sequence[str], max_len: int):
        """HF's `tok(texts, padding="max_length", truncation=True,
        max_length=max_len)`: (ids, attention mask), int32 (N, max_len);
        RoBERTa's <s> ... </s> around each text (GPT-2 adds none)."""
        pad = self.pad_token_id
        if pad is None:
            raise ValueError(
                "Asking to pad but the tokenizer does not have a padding "
                f"token ({self.flavour} tokenizer files with no pad_token)")
        wrap = _FLAVOURS[self.flavour]["wrap"]
        ids = np.full((len(texts), max_len), pad, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for r, text in enumerate(texts):
            toks = self.encode(text)
            if wrap:
                toks = ([self.token_id(self.special["bos_token"])]
                        + toks[:max(max_len - 2, 0)]
                        + [self.token_id(self.special["eos_token"])])
            toks = toks[:max_len]
            ids[r, :len(toks)] = toks
            mask[r, :len(toks)] = 1
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        """`tok.decode(ids)`: special tokens kept, bytes decoded as UTF-8
        with invalid sequences replaced, then the saved config's
        clean-up."""
        parts, buf = [], bytearray()
        for i in ids:
            tok = self.ids_to_tokens[int(i)]
            if tok in self.added:
                parts.append(buf.decode("utf-8", errors="replace"))
                parts.append(tok)
                buf = bytearray()
                continue
            for c in tok:
                b = self.byte_decoder.get(c)
                buf.extend(c.encode("utf-8") if b is None else bytes([b]))
        parts.append(buf.decode("utf-8", errors="replace"))
        text = "".join(parts)
        if self.clean_up_tokenization_spaces:
            text = clean_up_tokenization(text)
        return text

