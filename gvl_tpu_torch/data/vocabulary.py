"""Word-level vocabulary, tokenization, and class maps.

Behavioral spec: reference video_dataset.py:109-158 (Translator/ClassMap) and
misc/build_vocab.py. The translate/rtranslate rules are preserved exactly so
caption token ids and decoded strings are bit-compatible:
- strip a fixed punctuation set, lowercase, whitespace split;
- token ids: [BOS=0] + word ids (unknown -> vocab_size) + [EOS=0], truncated
  to max_len-2 words;
- rtranslate: cut at the first 0 and append '.'.

The port's copy of gvl_tpu/data/vocabulary.py.
"""

from __future__ import annotations

import json
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List

import numpy as np

_STRIP_TOKENS = ['!', '@', '%', '^', '*', '|', '#', '[', ']', '$', ',', ':',
                 '!', '_', ';', '.', '?', '"', '\\n', '\\', '.']


def normalize_sentence(sentence: str) -> List[str]:
    for token in _STRIP_TOKENS:
        sentence = sentence.replace(token, ' ')
    return sentence.replace('.', ' . ').replace(',', ' , ').lower().split()


class Translator:
    """word <-> id mapping with BOS/EOS id 0 and OOV id = vocab_size."""

    def __init__(self, translator_json: str, vocab_size: int):
        self.vocab_size = vocab_size
        with open(translator_json, "r") as f:
            vocab = json.load(f)
        assert vocab_size == len(vocab["word_to_ix"]), \
            f"vocab_size {vocab_size} != dict {len(vocab['word_to_ix'])}"
        self.word_to_ix: Dict[str, int] = defaultdict(
            lambda: self.vocab_size, vocab["word_to_ix"])
        self.ix_to_word: Dict[str, str] = defaultdict(
            lambda: str(self.vocab_size), vocab["ix_to_word"])

    def translate(self, sentence: str, max_len: int) -> np.ndarray:
        words = normalize_sentence(sentence)
        ids = [self.word_to_ix[w] for w in words][: max_len - 2]
        return np.array([0] + ids + [0], dtype=np.int64)

    def rtranslate(self, sent_ids) -> str:
        out = []
        for idx in sent_ids:
            if idx == 0:
                break
            out.append(self.ix_to_word[str(int(idx))])
        return " ".join(out) + "." if out else ""


def build_vocabulary(sentences: Iterable[str], min_count: int = 1
                     ) -> Dict[str, Dict]:
    """Build a Translator-compatible vocab json dict from raw sentences
    (reference tool: misc/build_vocab.py). ids start at 1 (0 = BOS/EOS)."""
    counter: Counter = Counter()
    for s in sentences:
        counter.update(normalize_sentence(s))
    words = sorted(w for w, c in counter.items() if c >= min_count)
    word_to_ix = {w: i + 1 for i, w in enumerate(words)}
    ix_to_word = {str(i + 1): w for i, w in enumerate(words)}
    return {"word_to_ix": word_to_ix, "ix_to_word": ix_to_word}


class ClassMap:
    """Action-class name <-> contiguous index (reference:
    video_dataset.py:139-157), for the TAL linear-probe task."""

    def __init__(self, class_path: str):
        with open(class_path, "r") as f:
            names = [line.strip("\n") for line in f.readlines()]
        self.name2idx = {n: i for i, n in enumerate(names)}
        self.idx2name = {i: n for i, n in enumerate(names)}

    def convert_name2idx(self, name: str) -> int:
        return self.name2idx[name]

    def convert_idx2name(self, idx: int) -> str:
        return self.idx2name[idx]

    def __len__(self):
        return len(self.name2idx)
