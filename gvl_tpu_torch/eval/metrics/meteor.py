"""METEOR 1.5 — faithful pure-Python port of the Java scorer.

The reference shells out to ``meteor-1.5.jar`` in `-norm -l en -stdio` mode
(reference densevid_eval3/pycocoevalcap_bak/meteor/meteor.py:12-25). This
module reimplements that scorer natively, following the Meteor 1.5 system
(Denkowski & Lavie 2014) component by component:

- **Normalizer** (``-norm``): WMT-style punctuation tokenization + lowercase
  (periods/commas kept inside numbers, dash split after digits).
- **Matchers**, applied in order with module weights (en defaults):
  exact (1.0), stem (0.6, Snowball English — the same ``englishStemmer``
  the jar embeds; the port carries nltk's in snowball.py), synonym
  (0.8, WordNet — used when nltk wordnet data is installed), paraphrase (0.6, phrase table — used when a table file is
  supplied). A (hyp, ref) pair keeps only its first (highest-priority)
  matching module.
- **Aligner**: beam search (beam 40) over hypothesis positions; completed
  alignments compared by (total covered words desc, chunks asc, sum of
  |hyp_start - ref_start| asc) — Meteor's PartialAlignment comparator.
- **Scorer** with the 1.5 `en` task parameters alpha=0.85, beta=0.2,
  gamma=0.6, delta=0.75: precision/recall weight content words delta and
  function words (1-delta), each match additionally weighted by its module
  weight; Fmean = P*R/(alpha*P + (1-alpha)*R); fragmentation penalty
  gamma * (chunks / avg_matches)^beta; segment score = (1-Pen)*Fmean.
- **Aggregation**: per-segment stats are computed against each reference
  and the best-scoring reference's stats are summed into corpus stats; the
  corpus METEOR is the score of the summed stats (how the jar's
  "EVAL ||| id" protocol aggregates) — not a mean of segment scores.

Data-file caveats (the only non-algorithmic deviations, both pluggable):
the jar's corpus-derived `function/en.words` list is replaced by the
closed-class English function-word list below (override via
``Meteor(function_words=...)``); the WordNet synonym and paraphrase-en
tables require their data files (nltk wordnet corpus / a paraphrase table
path) and are inactive when absent.
"""

from __future__ import annotations

import gzip
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

from gvl_tpu_torch.eval.metrics.snowball import EnglishStemmer

__all__ = ["Meteor", "MeteorStats", "meteor_normalize", "align",
           "FUNCTION_WORDS"]

# ---------------------------------------------------------------------------
# Normalizer (-norm): WMT/mteval-style punctuation tokenization + lowercase.
# Mirrors Meteor's Normalizer.normalizeAndLowerCase.
# ---------------------------------------------------------------------------

_NORM_RULES = [
    (re.compile(r"<skipped>"), ""),
    (re.compile(r"-\n"), ""),
    (re.compile(r"\n"), " "),
    (re.compile(r"&quot;"), '"'),
    (re.compile(r"&amp;"), "&"),
    (re.compile(r"&lt;"), "<"),
    (re.compile(r"&gt;"), ">"),
    # tokenize punctuation (except inside numbers, handled below)
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # tokenize period/comma unless surrounded by digits
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # tokenize dash preceded by a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
]


def meteor_normalize(line: str, lowercase: bool = True) -> List[str]:
    """Meteor `-norm` normalization of one segment -> token list."""
    s = " " + line + " "
    for pat, repl in _NORM_RULES:
        s = pat.sub(repl, s)
    if lowercase:
        s = s.lower()
    return s.split()


# ---------------------------------------------------------------------------
# Function words. Meteor ships a corpus-derived list (relative frequency
# >= 1e-3); with the jar data unavailable we use the English closed classes
# plus punctuation, which covers the head of that distribution.
# ---------------------------------------------------------------------------

FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no such which what whose
i you he she it we they me him her us them my your his its our their mine
yours hers ours theirs myself yourself himself herself itself ourselves
yourselves themselves one ones who whom whoever somebody someone something
anybody anyone anything everybody everyone everything nobody nothing
be am is are was were been being
have has had having do does did doing
will would shall should can could may might must ought need dare
not n't never
and or but nor so yet for as if then than because while although though
since unless until whether once whenever wherever however moreover
therefore thus hence also too either neither both
of in on at by with from to into onto upon about above below under over
between among through during before after against without within along
across behind beyond beneath beside besides near off out up down around
past toward towards via per
there here when where why how
's 'll 're 've 'd 'm 't
. , ! ? ; : ' " ` `` '' ( ) [ ] { } - -- ... & % $ # @ * + = < > / \\ _ ~ |
""".split())

# Default list used by Meteor() when no explicit list is passed; swap it
# process-wide with `default_function_words(...)` — the jar's real
# `function/en.words` (dumped by tools/make_goldens.sh step 6) can be
# installed here, and tools/meteor_sensitivity.py A/Bs the approximation.
_DEFAULT_FW = [FUNCTION_WORDS]


def load_function_words(path: str) -> frozenset:
    """Load a Meteor `function/en.words` dump (one word per line)."""
    with open(path, encoding="utf-8") as f:
        return frozenset(w.strip() for w in f if w.strip())


class default_function_words:
    """Context manager / setter for the process-wide default function-word
    list. `default_function_words(words)` as a plain call installs it;
    as a `with` block it restores the previous list on exit."""

    def __init__(self, words):
        self._old = _DEFAULT_FW[0]
        _DEFAULT_FW[0] = frozenset(words)

    def __enter__(self):
        return _DEFAULT_FW[0]

    def __exit__(self, *exc):
        _DEFAULT_FW[0] = self._old
        return False


# Process-wide default paraphrase table (the jar's paraphrase-en.gz, module
# weight 0.6). None = paraphrase matching off, an approximation vs the jar.
_DEFAULT_PT = [None]


def install_default_paraphrase_table(path: str) -> None:
    """Install the jar's dumped paraphrase table (make_goldens.sh step 6) as
    the process-wide default, clearing the 'meteor_paraphrases' approximation
    marker."""
    _DEFAULT_PT[0] = load_paraphrase_table(path)


def approximations():
    """Which aspects of this METEOR are approximate IN THIS PROCESS — the
    jar's corpus-derived data files that have not been installed (VERDICT r4
    #6: approximate numbers must be marked at the point of emission so no
    downstream parity claim silently consumes one). Empty list = all data
    files installed; scores then follow the faithful 1.5 port exactly."""
    out = []
    if _DEFAULT_FW[0] is FUNCTION_WORDS:      # built-in approx list active
        out.append("meteor_function_words")
    if _wordnet_or_none() is None:            # nltk wordnet corpus absent
        out.append("meteor_synonyms")
    if _DEFAULT_PT[0] is None:                # paraphrase-en table absent
        out.append("meteor_paraphrases")
    return sorted(out)


# ---------------------------------------------------------------------------
# Matchers
# ---------------------------------------------------------------------------

_snowball = None


def _get_stemmer():
    # the copy of nltk's English Snowball stemmer (snowball.py): nltk need
    # not be installed where the port runs
    global _snowball
    if _snowball is None:
        _snowball = EnglishStemmer()
    return _snowball


_wordnet_cache = ...  # sentinel: not probed yet


def _wordnet_or_none():
    # probe once per process: the LookupError raised when the corpus is
    # absent is expensive, and SCST calls the scorer every train step
    global _wordnet_cache
    if _wordnet_cache is ...:
        try:
            from nltk.corpus import wordnet
            wordnet.synsets("test")  # raises LookupError w/o the data
            _wordnet_cache = wordnet
        except Exception:
            _wordnet_cache = None
    return _wordnet_cache


class _Match:
    """A phrase match: hyp[i:i+li] ~ ref[j:j+lj] found by module `mod`."""

    __slots__ = ("i", "j", "li", "lj", "mod")

    def __init__(self, i, j, li, lj, mod):
        self.i, self.j, self.li, self.lj, self.mod = i, j, li, lj, mod


def _enumerate_matches(hyp: Sequence[str], ref: Sequence[str],
                       use_synonyms: bool,
                       paraphrases: Optional[Dict[Tuple[str, ...],
                                                  List[Tuple[str, ...]]]],
                       use_stem: bool = True) -> List[_Match]:
    """All candidate matches, keeping the best (lowest) module per pair."""
    matches: Dict[Tuple[int, int, int, int], _Match] = {}

    def add(i, j, li, lj, mod):
        key = (i, j, li, lj)
        if key not in matches:  # earlier (higher-priority) module wins
            matches[key] = _Match(i, j, li, lj, mod)

    # module 0: exact
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if hw == rw:
                add(i, j, 1, 1, 0)
    # module 1: stem
    if use_stem:
        stem = _get_stemmer().stem
        hs = [stem(w) for w in hyp]
        rs = [stem(w) for w in ref]
        for i, hw in enumerate(hs):
            for j, rw in enumerate(rs):
                if hw == rw:
                    add(i, j, 1, 1, 1)
    # module 2: synonym (WordNet synset overlap)
    if use_synonyms:
        wn = _wordnet_or_none()
        if wn is not None:
            hsyn = [frozenset(s.name() for s in wn.synsets(w)) for w in hyp]
            rsyn = [frozenset(s.name() for s in wn.synsets(w)) for w in ref]
            for i, a in enumerate(hsyn):
                for j, b in enumerate(rsyn):
                    if a and b and not a.isdisjoint(b):
                        add(i, j, 1, 1, 2)
    # module 3: paraphrase (phrase table)
    if paraphrases:
        max_len = max(len(k) for k in paraphrases)
        for i in range(len(hyp)):
            for li in range(1, min(max_len, len(hyp) - i) + 1):
                phrase = tuple(hyp[i:i + li])
                for alt in paraphrases.get(phrase, ()):
                    lj = len(alt)
                    for j in range(len(ref) - lj + 1):
                        if tuple(ref[j:j + lj]) == alt:
                            add(i, j, li, lj, 3)
    return list(matches.values())


# ---------------------------------------------------------------------------
# Aligner: beam search, Meteor's PartialAlignment ordering.
# ---------------------------------------------------------------------------

_BEAM = 40


class _Partial:
    __slots__ = ("hyp_used", "ref_used", "match", "parent", "cov", "chunks",
                 "dist", "last")

    def __init__(self):
        self.hyp_used = 0   # bitmask
        self.ref_used = 0
        self.match: Optional[_Match] = None   # last match taken
        self.parent: Optional["_Partial"] = None
        self.cov = 0        # total covered words (hyp + ref)
        self.chunks = 0
        self.dist = 0
        self.last = None    # (hyp_end_exclusive, ref_end_exclusive)

    def key(self):  # beam ordering: better sorts first
        return (-self.cov, self.chunks, self.dist)

    def extended(self, m: _Match) -> "_Partial":
        p = _Partial()
        p.hyp_used = self.hyp_used | (((1 << m.li) - 1) << m.i)
        p.ref_used = self.ref_used | (((1 << m.lj) - 1) << m.j)
        p.match, p.parent = m, self
        p.cov = self.cov + m.li + m.lj
        contiguous = self.last is not None and self.last == (m.i, m.j)
        p.chunks = self.chunks + (0 if contiguous else 1)
        p.dist = self.dist + abs(m.i - m.j)
        p.last = (m.i + m.li, m.j + m.lj)
        return p

    def match_list(self) -> List[_Match]:
        out, node = [], self
        while node is not None:
            if node.match is not None:
                out.append(node.match)
            node = node.parent
        out.reverse()
        return out


def align(hyp: Sequence[str], ref: Sequence[str],
          use_synonyms: bool = True,
          paraphrases: Optional[Dict] = None,
          use_stem: bool = True) -> List[_Match]:
    """Best alignment between hyp and ref token lists (Meteor objective)."""
    cand = _enumerate_matches(hyp, ref, use_synonyms, paraphrases, use_stem)
    by_start: Dict[int, List[_Match]] = {}
    for m in cand:
        by_start.setdefault(m.i, []).append(m)

    beam = [_Partial()]
    for i in range(len(hyp)):
        nxt: List[_Partial] = []
        for p in beam:
            if p.hyp_used >> i & 1:  # covered by an earlier phrase match
                nxt.append(p)
                continue
            nxt.append(p)  # skip word i
            for m in by_start.get(i, ()):
                if (p.hyp_used >> m.i) & ((1 << m.li) - 1):
                    continue
                if (p.ref_used >> m.j) & ((1 << m.lj) - 1):
                    continue
                nxt.append(p.extended(m))
        nxt.sort(key=_Partial.key)
        beam = nxt[:_BEAM]
    return beam[0].match_list()


# ---------------------------------------------------------------------------
# Scorer
# ---------------------------------------------------------------------------

# en task defaults, Meteor 1.5 (-l en): alpha beta gamma delta / weights
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
MODULE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase


class MeteorStats:
    """Sufficient statistics of one segment (or a sum over segments)."""

    FIELDS = ("h_content_len", "h_function_len", "r_content_len",
              "r_function_len", "h_content_matches", "h_function_matches",
              "r_content_matches", "r_function_matches", "covered_h",
              "covered_r", "chunks")

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0.0)

    def add(self, other: "MeteorStats") -> None:
        for f in self.FIELDS:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def score(self) -> float:
        d = DELTA
        p_den = d * self.h_content_len + (1 - d) * self.h_function_len
        r_den = d * self.r_content_len + (1 - d) * self.r_function_len
        p_num = d * self.h_content_matches + (1 - d) * self.h_function_matches
        r_num = d * self.r_content_matches + (1 - d) * self.r_function_matches
        p = p_num / p_den if p_den > 0 else 0.0
        r = r_num / r_den if r_den > 0 else 0.0
        if p + r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        avg_matches = (self.covered_h + self.covered_r) / 2.0
        if self.chunks > 0 and avg_matches > 0:
            frag = self.chunks / avg_matches
            pen = GAMMA * (frag ** BETA)
        else:
            pen = 0.0
        return (1.0 - pen) * fmean


def _segment_stats(hyp: List[str], ref: List[str], is_function,
                   use_synonyms: bool, paraphrases,
                   use_stem: bool = True) -> MeteorStats:
    st = MeteorStats()
    for w in hyp:
        if is_function(w):
            st.h_function_len += 1
        else:
            st.h_content_len += 1
    for w in ref:
        if is_function(w):
            st.r_function_len += 1
        else:
            st.r_content_len += 1
    chosen = sorted(align(hyp, ref, use_synonyms, paraphrases, use_stem),
                    key=lambda m: m.i)
    for m in chosen:
        w = MODULE_WEIGHTS[m.mod]
        for k in range(m.li):
            if is_function(hyp[m.i + k]):
                st.h_function_matches += w
            else:
                st.h_content_matches += w
        for k in range(m.lj):
            if is_function(ref[m.j + k]):
                st.r_function_matches += w
            else:
                st.r_content_matches += w
        st.covered_h += m.li
        st.covered_r += m.lj
    # chunks of the chosen alignment (on hyp-sorted matches so the count is
    # order-independent of the search)
    chunks, last = 0, None
    for m in chosen:
        if last != (m.i, m.j):
            chunks += 1
        last = (m.i + m.li, m.j + m.lj)
    st.chunks = chunks
    return st


def load_paraphrase_table(path: str) -> Dict[Tuple[str, ...],
                                             List[Tuple[str, ...]]]:
    """Load a Meteor paraphrase table: lines `prob ||| phrase ||| phrase`."""
    table: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        for line in f:
            parts = [p.strip() for p in line.split("|||")]
            if len(parts) < 3:
                continue
            a, b = tuple(parts[1].split()), tuple(parts[2].split())
            if a and b:
                table.setdefault(a, []).append(b)
    return table


class Meteor:
    """pycocoevalcap-compatible METEOR 1.5 scorer.

    compute_score(gts, res): gts/res map id -> list[str]; the hypothesis is
    res[id][0]; each segment is scored against its best reference, stats are
    summed, and the corpus score is the score of the summed stats (matching
    the jar's aggregate protocol).
    """

    def __init__(self, function_words=None, use_synonyms=True,
                 paraphrase_table: Optional[str] = None,
                 use_stem: bool = True):
        self._function_words = (_DEFAULT_FW[0] if function_words is None
                                else function_words)
        self._use_synonyms = use_synonyms
        self._use_stem = use_stem
        self._paraphrases = (load_paraphrase_table(paraphrase_table)
                             if paraphrase_table else _DEFAULT_PT[0])

    def method(self):
        return "Meteor"

    def _is_function(self, w: str) -> bool:
        return w in self._function_words

    def score_segment(self, hyp: str, refs: Sequence[str]
                      ) -> Tuple[float, MeteorStats]:
        h = meteor_normalize(hyp)
        best_score, best_stats = 0.0, None
        for ref in refs:
            st = _segment_stats(h, meteor_normalize(ref), self._is_function,
                                self._use_synonyms, self._paraphrases,
                                self._use_stem)
            s = st.score()
            if best_stats is None or s > best_score:
                best_score, best_stats = s, st
        if best_stats is None:
            best_stats = _segment_stats(h, [], self._is_function,
                                        self._use_synonyms, self._paraphrases,
                                        self._use_stem)
        return best_score, best_stats

    def compute_score(self, gts: Dict, res: Dict):
        total = MeteorStats()
        per_seg: List[float] = []
        for k in res:
            s, st = self.score_segment(res[k][0], gts.get(k, []))
            per_seg.append(s)
            total.add(st)
        return total.score(), per_seg
