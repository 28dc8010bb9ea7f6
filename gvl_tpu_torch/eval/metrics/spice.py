"""SPICE — Semantic Propositional Image Caption Evaluation (pure Python).

Behavioral spec: reference ``densevid_eval3/pycocoevalcap_bak/spice/spice.py``
(a wrapper that shells out to ``spice-1.0.jar``; used only in the
``2018_cider`` verbose scorer set, reference ``evaluate2018_cider.py:62``).
The metric (Anderson et al., "SPICE: Semantic Propositional Image Caption
Evaluation", ECCV 2016) parses each caption into a scene graph of objects,
attributes and relations, flattens it to a bag of semantic tuples
``(obj)`` / ``(obj, attr)`` / ``(subj, rel, obj)``, and reports the F1 of
binary tuple matching between the candidate's tuples and the union of the
references' tuples, with a per-category breakdown
(All / Object / Attribute / Relation / Cardinality / Color / Size).

What is and is not reproduced here:

- reproduced exactly: the tuple/category semantics, the binary set-matching
  protocol (references merged into ONE graph first — duplicates across refs
  collapse), the jar wrapper's aggregation (``average_score`` = mean of the
  per-item ``All`` F-scores over sorted ids, ``spice.py:86-89``), its output
  schema (per-item ``{category: {p,r,f}}`` with NaN for undefined
  categories, ``float_convert`` at ``spice.py:26-29``), and its input
  sanity contract (one candidate, >=1 refs).
- approximated: the parser. The jar derives scene graphs from a Stanford
  CoreNLP dependency parse plus WordNet synset equivalence; neither
  CoreNLP nor the WordNet data files exist in this toolchain, so parsing
  here is a self-contained rule-based English chunker (closed-class
  lexicons + a small verb/adjective lexicon + suffix morphology) and
  tuple-element equivalence is lemma/stem equality, upgraded to WordNet
  synset overlap automatically when the nltk corpus is installed (same
  probe the METEOR port uses). Absolute parity with the jar is therefore
  NOT claimed; scores are deterministic, monotone in semantic overlap, and
  carry the metric's intended propositional signal.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np

from gvl_tpu_torch.eval.metrics.meteor import _get_stemmer, _wordnet_or_none

# ---------------------------------------------------------------------------
# Lexicons (closed classes + the small open-class seed lists the chunker
# needs to separate verbs/adjectives from the default-noun class).
# ---------------------------------------------------------------------------

DETERMINERS = frozenset("""
a an the this that these those his her its their our your my some any no
each every either neither another such
""".split())

PRONOUNS = frozenset("""
he she it they we you i him her them us me someone somebody something
anyone anybody anything everyone everybody everything who which what
himself herself itself themselves
""".split())

PREPOSITIONS = frozenset("""
in on at by with from into onto over under above below behind beside
between among through across around near inside outside against along
toward towards up down off out of for about during before after without
within beneath underneath atop upon next beyond past via
""".split())

CONJUNCTIONS = frozenset("and or but so because while as if when then".split())

COPULAS = frozenset("is are was were be been being am".split())

AUXILIARIES = frozenset("""
do does did has have had will would can could shall should may might must
not n't
""".split())

NUMBER_WORDS = {
    "zero": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15,
    "sixteen": 16, "seventeen": 17, "eighteen": 18, "nineteen": 19,
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
    "seventy": 70, "eighty": 80, "ninety": 90, "hundred": 100,
    "dozen": 12, "several": -1, "many": -1, "few": -1, "couple": 2,
    "both": 2,
}

COLORS = frozenset("""
red orange yellow green blue purple violet pink brown black white gray
grey tan beige maroon navy teal cyan magenta golden gold silver blonde
blond dark light colorful colored multicolored
""".split())

SIZES = frozenset("""
big small large little tiny huge giant enormous massive gigantic short
tall long wide narrow thick thin deep shallow miniature oversized
""".split())

# common video/image-caption adjectives beyond colors/sizes
ADJECTIVES = frozenset("""
young old new happy sad angry beautiful pretty ugly dirty clean wet dry
hot cold warm cool fast slow quick empty full open closed broken wooden
metal plastic glass round square flat soft hard heavy striped plaid furry
fluffy shiny bright dim cloudy sunny rainy snowy busy crowded quiet loud
fresh delicious tasty ripe raw cooked fried baked grilled male female
elderly asian african american european bald bearded smiling professional
electric electronic digital modern antique vintage rusty sharp dull
curly straight messy neat fancy plain nude naked barefoot athletic
""".split()) | COLORS | SIZES

# common caption verbs (base forms); inflections recognized morphologically
VERBS = frozenset("""
hold stand sit walk run jump play eat drink look watch ride drive fly
swim read write talk speak sing dance cook cut chop slice mix stir pour
add put place take grab carry throw catch kick hit swing wear smile
laugh cry sleep lie lean hang climb fall push pull open close turn move
point reach touch wash clean wipe brush comb spread apply remove lift
lower bend stretch wave clap shake nod drop pick serve feed pet pat
kiss hug fight race chase follow lead cross enter exit leave arrive
park stop start begin finish continue prepare make build fix repair
paint draw show display perform demonstrate explain describe introduce
use operate press type click scroll flip fold wrap unwrap tie untie
attach connect plug light blow spray sprinkle dip coat season marinate
bake boil fry grill roast steam microwave heat melt freeze slice peel
grate whisk knead roll squeeze crack beat blend grind measure weigh
taste smell sniff bite chew swallow sip gulp toast decorate garnish
surf skate ski snowboard dive row paddle fish hunt shoot aim throw
bounce dribble pass score tackle wrestle box punch block dodge stretch
exercise train practice warm juggle balance flip spin twirl bow kneel
crawl hop skip march stroll jog sprint hike wander gather meet greet
wave salute speak shout whisper yell announce interview host present
film record photograph pose model style trim shave curl dye braid
""".split())

_IRREGULAR_PAST = {
    "sat": "sit", "stood": "stand", "held": "hold", "ran": "run",
    "ate": "eat", "drank": "drink", "rode": "ride", "drove": "drive",
    "flew": "fly", "swam": "swim", "read": "read", "wrote": "write",
    "spoke": "speak", "sang": "sing", "took": "take", "threw": "throw",
    "caught": "catch", "hit": "hit", "wore": "wear", "slept": "sleep",
    "lay": "lie", "hung": "hang", "fell": "fall", "made": "make",
    "built": "build", "drew": "draw", "lit": "light", "blew": "blow",
    "froze": "freeze", "shot": "shoot", "met": "meet", "cut": "cut",
    "put": "put", "left": "leave", "led": "lead", "began": "begin",
    "gave": "give", "got": "get", "went": "go", "came": "come",
    "saw": "see", "said": "say", "told": "tell", "brought": "bring",
    "bought": "buy", "taught": "teach", "knelt": "kneel",
}

_IRREGULAR_PLURAL = {
    "men": "man", "women": "woman", "children": "child", "people":
    "person", "feet": "foot", "teeth": "tooth", "geese": "goose",
    "mice": "mouse", "knives": "knife", "leaves": "leaf", "wolves":
    "wolf", "shelves": "shelf", "loaves": "loaf", "wives": "wife",
    "dishes": "dish", "glasses": "glass",
}

_TOKEN_RE = re.compile(r"[a-z]+(?:'[a-z]+)?|\d+(?:\.\d+)?")


def _tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


# ---------------------------------------------------------------------------
# Light lemmatizer (CoreNLP's lemma annotator stand-in).
# ---------------------------------------------------------------------------

def _verb_base(w: str) -> str | None:
    """Base form if `w` looks like an inflected form of a known verb."""
    if w in VERBS:
        return w
    if w in _IRREGULAR_PAST:
        return _IRREGULAR_PAST[w]
    for suf, strip in (("ing", 3), ("ed", 2), ("es", 2), ("s", 1)):
        if w.endswith(suf) and len(w) > strip + 2:
            stem = w[:-strip]
            if stem in VERBS:
                return stem
            if stem + "e" in VERBS:                     # riding -> ride
                return stem + "e"
            if (len(stem) >= 2 and stem[-1] == stem[-2]
                    and stem[:-1] in VERBS):            # running -> run
                return stem[:-1]
    return None


def _noun_singular(w: str) -> str:
    if w in _IRREGULAR_PLURAL:
        return _IRREGULAR_PLURAL[w]
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith(("ches", "shes", "sses", "xes", "zes")) and len(w) > 4:
        return w[:-2]
    if w.endswith("s") and not w.endswith(("ss", "us", "is")) and len(w) > 3:
        return w[:-1]
    return w


def lemma(word: str, tag: str) -> str:
    if tag == "VERB":
        return _verb_base(word) or word
    if tag in ("NOUN", "PRON"):
        return _noun_singular(word)
    return word


# ---------------------------------------------------------------------------
# Coarse tagger + chunker. Token tags: DET NUM PRON PREP CONJ COP AUX ADV
# ADJ VERB NOUN. Unknown open-class words default to NOUN; -ing/-ed forms
# are disambiguated positionally by the chunker (inside an NP before the
# head they behave as ADJ, after a complete NP as VERB).
# ---------------------------------------------------------------------------

_ADJ_SUFFIXES = ("ful", "ous", "ive", "less", "able", "ible", "ish")


def _tag_one(w: str) -> str:
    if w in DETERMINERS:
        return "DET"
    if w in PRONOUNS:
        return "PRON"
    if w in COPULAS:
        return "COP"
    if w in AUXILIARIES:
        return "AUX"
    if w in PREPOSITIONS:
        return "PREP"
    if w in CONJUNCTIONS:
        return "CONJ"
    if w in NUMBER_WORDS or w[0].isdigit():
        return "NUM"
    if w in ADJECTIVES:
        return "ADJ"
    if _verb_base(w) is not None:
        return "VERB"
    if w.endswith("ly") and len(w) > 4:
        return "ADV"
    if w.endswith(_ADJ_SUFFIXES) and len(w) > 5:
        return "ADJ"
    return "NOUN"


class SceneObject:
    __slots__ = ("name", "attributes")

    def __init__(self, name: str):
        self.name = name
        self.attributes: List[str] = []


class SceneGraph:
    """Objects + attributes + relations extracted from one caption."""

    def __init__(self):
        self.objects: List[SceneObject] = []
        self.relations: List[Tuple[str, str, str]] = []

    def tuples(self) -> Set[tuple]:
        out: Set[tuple] = set()
        for o in self.objects:
            out.add((o.name,))
            for a in o.attributes:
                out.add((o.name, a))
        for s, r, t in self.relations:
            out.add((s, r, t))
        return out


def parse_scene_graph(caption: str) -> SceneGraph:
    """Rule-based scene-graph extraction (CoreNLP-parse stand-in).

    Grammar, applied left to right:
      NP       := (DET)? (NUM|ADJ|participle)* NOUN+        # head = last noun
                  (consecutive nouns merge into a compound head,
                   e.g. 'fire hydrant'; NUM -> cardinality attribute)
      relation := NP VERB (ADV)? (PREP)? NP   -> (s, verb[ prep], o)
                | NP PREP NP                  -> (s, prep, o)
                | NP COP PREP NP              -> (s, prep, o)
      attr     := NP COP (ADV)? ADJ+          -> (s, adj)...
                | NP COP NP                   -> (s, head2)  # nominal pred.
                | NP VERB [no object]         -> (s, verb)   # intransitive
    """
    toks = _tokenize(caption)
    tags = [_tag_one(w) for w in toks]
    g = SceneGraph()

    i, n = 0, len(toks)

    def read_np(i: int) -> Tuple[SceneObject | None, int]:
        """Parse one NP starting at i; returns (object or None, next_i)."""
        attrs: List[str] = []
        nouns: List[str] = []
        j = i
        while j < n:
            w, t = toks[j], tags[j]
            if t == "DET" or t == "ADV":
                j += 1
                continue
            if t == "NUM":
                attrs.append(str(NUMBER_WORDS.get(w, w)))
                j += 1
                continue
            if t == "ADJ":
                attrs.append(w)
                j += 1
                continue
            if t == "VERB" and not nouns and w.endswith(("ing", "ed")) \
                    and j + 1 < n and tags[j + 1] in ("NOUN", "ADJ", "NUM"):
                # participle premodifier: 'a running man', 'sliced bread'
                attrs.append(_verb_base(w) or w)
                j += 1
                continue
            if t in ("NOUN", "PRON"):
                nouns.append(lemma(w, t))
                j += 1
                # compound continues only through further nouns
                while j < n and tags[j] == "NOUN":
                    nouns.append(lemma(toks[j], "NOUN"))
                    j += 1
                break
            break
        if not nouns:
            return None, j if j > i else i + 1
        obj = SceneObject(" ".join(nouns))
        obj.attributes = attrs
        return obj, j

    def attach(obj: SceneObject) -> str:
        g.objects.append(obj)
        return obj.name

    subj: str | None = None
    while i < n:
        t = tags[i]
        if t in ("DET", "NUM", "ADJ", "NOUN", "PRON") or (
                t == "VERB" and toks[i].endswith(("ing", "ed"))
                and i + 1 < n and tags[i + 1] in ("NOUN", "ADJ", "NUM")
                # participle premodifier only at a fresh NP start ('a
                # running man'), never straight after a verb context
                # ('is cooking eggs' must parse as a verb clause)
                and (i == 0 or tags[i - 1] in ("DET", "NUM", "ADJ",
                                               "ADV", "CONJ"))):
            obj, i = read_np(i)
            if obj is not None:
                subj = attach(obj)
            continue
        if t == "PREP" and subj is not None:
            prep = toks[i]
            obj, j = read_np(i + 1)
            if obj is not None:
                tail = attach(obj)
                g.relations.append((subj, prep, tail))
                subj = tail            # nearest-NP attachment for later PPs
                i = j
                continue
            i += 1
            continue
        if t == "COP" and subj is not None:
            j = i + 1
            while j < n and tags[j] in ("AUX", "ADV", "DET"):
                j += 1
            if j < n and tags[j] == "ADJ":
                sobj = g.objects[-1]
                while j < n and tags[j] in ("ADJ", "CONJ", "ADV"):
                    if tags[j] == "ADJ":
                        sobj.attributes.append(toks[j])
                    j += 1
                i = j
                continue
            if j < n and tags[j] == "PREP":
                prep = toks[j]
                obj, k = read_np(j + 1)
                if obj is not None:
                    tail = attach(obj)
                    g.relations.append((subj, prep, tail))
                    subj = tail
                    i = k
                    continue
            if j < n and tags[j] == "VERB":
                i = j          # progressive 'is running ...' -> verb clause
                continue
            obj, k = read_np(j)
            if obj is not None:
                # nominal predicate: 'the man is a doctor' -> (man, doctor)
                for o in g.objects:
                    if o.name == subj:
                        o.attributes.append(obj.name)
                        break
                i = k
                continue
            i += 1
            continue
        if t == "VERB" and subj is not None:
            verb = _verb_base(toks[i]) or toks[i]
            j = i + 1
            while j < n and tags[j] in ("ADV", "AUX"):
                j += 1
            prep = None
            if j < n and tags[j] == "PREP":
                prep = toks[j]
                j += 1
            obj, k = read_np(j)
            if obj is not None:
                rel = f"{verb} {prep}" if prep else verb
                tail = attach(obj)
                g.relations.append((subj, rel, tail))
                subj = tail            # nearest-NP attachment for later PPs
                i = k
            else:
                # intransitive: verb becomes an attribute of the subject
                for o in g.objects:
                    if o.name == subj:
                        o.attributes.append(verb)
                        break
                i = j
            continue
        i += 1
    return g


# ---------------------------------------------------------------------------
# Tuple matching + categories.
# ---------------------------------------------------------------------------

CATEGORIES = ("All", "Object", "Attribute", "Relation",
              "Cardinality", "Color", "Size")


def _categories_of(tup: tuple) -> List[str]:
    cats = ["All"]
    if len(tup) == 1:
        cats.append("Object")
    elif len(tup) == 2:
        cats.append("Attribute")
        if tup[1].lstrip("-").replace(".", "").isdigit():
            cats.append("Cardinality")
        if tup[1] in COLORS:
            cats.append("Color")
        if tup[1] in SIZES:
            cats.append("Size")
    else:
        cats.append("Relation")
    return cats


def _canon_word(w: str) -> str:
    """Canonical form for tuple-element equality: lemma then stem (the
    stand-in for the jar's lemma + WordNet-synset equivalence)."""
    parts = w.split(" ")
    stem = _get_stemmer().stem
    return " ".join(stem(_noun_singular(p)) for p in parts)


def _canon_tuple(tup: tuple) -> tuple:
    return tuple(_canon_word(w) for w in tup)


def _synsets(word: str) -> frozenset:
    wn = _wordnet_or_none()
    if wn is None:
        return frozenset()
    return frozenset(s.name() for s in wn.synsets(word.replace(" ", "_")))


def _tuples_match(a: tuple, b: tuple) -> bool:
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x == y:
            continue
        sx, sy = _synsets(x), _synsets(y)
        if sx and sy and not sx.isdisjoint(sy):
            continue
        return False
    return True


def _match_count(cand: Set[tuple], ref: Set[tuple]) -> int:
    """Binary matching: each candidate tuple matches at most one distinct
    reference tuple (greedy over exact matches first, then synonym)."""
    exact = cand & ref
    m = len(exact)
    rest_c = cand - exact
    rest_r = set(ref - exact)
    for c in sorted(rest_c):
        for r in sorted(rest_r):
            if _tuples_match(c, r):
                rest_r.discard(r)
                m += 1
                break
    return m


def _prf(cand: Set[tuple], ref: Set[tuple]) -> Dict[str, float]:
    nc, nr = len(cand), len(ref)
    if nc == 0 and nr == 0:
        return {"p": math.nan, "r": math.nan, "f": math.nan}
    m = _match_count(cand, ref)
    p = m / nc if nc else 0.0
    r = m / nr if nr else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"p": p, "r": r, "f": f}


def score_pair(candidate: str, refs: Sequence[str]) -> Dict[str, Dict]:
    """Per-item SPICE: candidate graph vs the UNION of the refs' graphs
    (the jar merges references into one scene graph before matching)."""
    cand = {_canon_tuple(t) for t in parse_scene_graph(candidate).tuples()}
    ref: Set[tuple] = set()
    for r in refs:
        ref |= {_canon_tuple(t) for t in parse_scene_graph(r).tuples()}
    out: Dict[str, Dict] = {}
    for cat in CATEGORIES:
        c = {t for t in cand if cat in _categories_of(t)}
        g = {t for t in ref if cat in _categories_of(t)}
        if cat == "All" and not c and not g:
            # an empty-vs-empty 'All' would NaN the corpus mean (the jar
            # never emits one — CoreNLP always parses something); treat
            # identical empties as a perfect match
            out[cat] = {"p": 1.0, "r": 1.0, "f": 1.0}
        else:
            out[cat] = _prf(c, g)
    return out


def approximations():
    """SPICE here is structurally approximate: the jar derives scene graphs
    from a Stanford CoreNLP dependency parse (+ WordNet synsets); this port
    uses a rule-based chunker (module docstring). Always marked so no
    downstream parity claim can silently consume a SPICE number
    (VERDICT r4 #6)."""
    return ["spice_parser"]


class Spice:
    """pycocoevalcap-compatible scorer (reference spice.py:32-97 contract:
    sorted ids, one candidate per id, >=1 refs, returns the mean of the
    per-item All-F scores plus the per-item category score sets)."""

    def compute_score(self, gts: Dict, res: Dict):
        assert sorted(gts.keys()) == sorted(res.keys())
        img_ids = sorted(gts.keys())
        scores: List[Dict] = []
        spice_f: List[float] = []
        for iid in img_ids:
            hypo, refs = res[iid], gts[iid]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            s = score_pair(hypo[0], refs)
            scores.append(s)
            spice_f.append(float(s["All"]["f"]))
        return float(np.mean(np.asarray(spice_f))), scores

    def method(self) -> str:
        return "SPICE"
