"""Stanford PTBTokenizer — pure-Python port of the behavior the reference
pipeline depends on.

The reference shells to `stanford-corenlp-3.4.1.jar
edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase` and then
drops tokens found in a PUNCTUATIONS list (reference
densevid_eval3/pycocoevalcap_bak/tokenizer/ptbtokenizer.py:19-46). This
module reproduces that contract:

- PTB3 escaping: brackets -> -LRB-/-RRB-/-LCB-/-RCB-, opening/closing double
  quotes -> `` / '', unicode quotes/dashes normalized, ellipsis -> ...
- Clitic/contraction splitting: n't ('can't' -> 'ca n't', 'won't' ->
  'wo n't'), 's 're 've 'll 'd 'm, possessives (dogs' -> dogs '),
  assimilations (cannot -> can not, gonna -> gon na, ...).
- Number-aware punctuation splitting: 5.5 / 5,000 / 5:30 stay single
  tokens; currency/percent split ($5 -> $ 5, 50% -> 50 %).
- Abbreviation periods kept (mr., u.s.); sentence punctuation split.
- Americanization of common British spellings (PTBTokenizer's
  `americanize` option defaults to true).
- `-lowerCase`, then the pycocoevalcap PUNCTUATIONS filter. That filter is
  applied with the *uppercase* spellings (-LRB- etc.) to the *lowercased*
  stream, exactly as pycocoevalcap does — so bracket tokens survive as
  '-lrb-' in the real pipeline, and they do here too.

Unreproduced Java behaviors are limited to long-tail lexer states that do
not occur in caption text (SGML entities, non-BMP unicode classes, the full
Americanize word table).
"""

from __future__ import annotations

import re
from typing import Dict, List

__all__ = ["tokenize_line", "ptb_tokenize", "PUNCTUATIONS"]

# pycocoevalcap's filter list, verbatim (note: uppercase bracket escapes,
# applied after lowercasing — intentionally so, see module docstring).
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_ABBREVIATIONS = {
    "mr.", "mrs.", "ms.", "dr.", "prof.", "sr.", "jr.", "st.", "vs.", "etc.",
    "inc.", "ltd.", "co.", "corp.", "gen.", "col.", "capt.", "sgt.", "rev.",
    "gov.", "sen.", "rep.", "jan.", "feb.", "mar.", "apr.", "jun.", "jul.",
    "aug.", "sep.", "sept.", "oct.", "nov.", "dec.", "mon.", "tue.", "wed.",
    "thu.", "fri.", "sat.", "sun.", "e.g.", "i.e.", "a.m.", "p.m.", "u.s.",
    "u.k.", "no.", "ft.", "oz.", "lb.", "lbs.", "vol.", "ca.", "approx.",
}

_ASSIMILATIONS = {
    "cannot": ["can", "not"], "gonna": ["gon", "na"], "gotta": ["got", "ta"],
    "wanna": ["wan", "na"], "lemme": ["lem", "me"], "gimme": ["gim", "me"],
    "'tis": ["'t", "is"], "'twas": ["'t", "was"],
}

# Common -our/-re British spellings (PTBTokenizer americanize=true default).
_AMERICANIZE = {
    "colour": "color", "colours": "colors", "coloured": "colored",
    "flavour": "flavor", "flavours": "flavors", "labour": "labor",
    "neighbour": "neighbor", "neighbours": "neighbors", "harbour": "harbor",
    "honour": "honor", "behaviour": "behavior", "favourite": "favorite",
    "favour": "favor", "humour": "humor", "odour": "odor",
    "theatre": "theater", "centre": "center", "centres": "centers",
    "metre": "meter", "litre": "liter", "fibre": "fiber",
    "grey": "gray", "practise": "practice", "defence": "defense",
    "offence": "offense", "licence": "license", "travelling": "traveling",
    "travelled": "traveled", "jewellery": "jewelry", "moustache": "mustache",
    "pyjamas": "pajamas", "tyre": "tire", "tyres": "tires",
}

_UNICODE_MAP = {
    "‘": "`", "’": "'", "“": "``", "”": "''",
    "–": "--", "—": "--", "…": "...",
    " ": " ",
}

_CLITICS = ("'s", "'re", "'ve", "'ll", "'d", "'m")


def _split_word(tok: str) -> List[str]:
    """Recursive PTB splitting of one whitespace-delimited chunk."""
    if not tok:
        return []
    low = tok.lower()

    if low in _ASSIMILATIONS:
        return _ASSIMILATIONS[low]
    if low in _AMERICANIZE:
        return [_AMERICANIZE[low]]

    # pure punctuation runs
    if tok in ("...", "--"):
        return [tok]
    if re.fullmatch(r"\.{3,}|\. \. \.", tok):
        return ["..."]

    # leading punctuation (brackets, quotes, sentence punct, currency)
    m = re.match(r"^([(\[{])", tok)
    if m:
        esc = {"(": "-LRB-", "[": "-LRB-", "{": "-LCB-"}[m.group(1)]
        return [esc] + _split_word(tok[1:])
    m = re.match(r"^(``|\"|`)", tok)
    if m:
        return ["``" if m.group(1) in ('"', "``") else "`"] \
            + _split_word(tok[len(m.group(1)):])
    m = re.match(r"^([$#])(?=.)", tok)
    if m:
        return [m.group(1)] + _split_word(tok[1:])

    # trailing punctuation
    m = re.search(r"([)\]}])$", tok)
    if m:
        esc = {")": "-RRB-", "]": "-RRB-", "}": "-RCB-"}[m.group(1)]
        return _split_word(tok[:-1]) + [esc]
    m = re.search(r"(''|\")$", tok)
    if m:
        return _split_word(tok[: -len(m.group(1))]) + ["''"]
    m = re.search(r"([!?;]+)$", tok)
    if m:
        tail = list(m.group(1))
        return _split_word(tok[: -len(m.group(1))]) + tail
    if tok.endswith(","):
        return _split_word(tok[:-1]) + [","]
    if tok.endswith(":") and not re.fullmatch(r"\d+:\d+(:\d+)?", tok):
        return _split_word(tok[:-1]) + [":"]
    if tok.endswith("%"):
        return _split_word(tok[:-1]) + ["%"]
    if tok.endswith("..."):
        return _split_word(tok[:-3]) + ["..."]
    if tok.endswith(".") and len(tok) > 1:
        # keep abbreviation/initialism periods (mr., u.s., single initials)
        if low in _ABBREVIATIONS:
            return [tok]
        if re.fullmatch(r"([a-z]\.){2,}", low):  # u.s., e.g.
            return [tok]
        if len(tok) == 2 and tok[0].isalpha():   # initial "j."
            return [tok]
        return _split_word(tok[:-1]) + ["."]

    # clitics / possessives (after trailing punct is stripped)
    for cl in _CLITICS:
        if low.endswith(cl) and len(tok) > len(cl):
            return _split_word(tok[: -len(cl)]) + [tok[-len(cl):]]
    m = re.fullmatch(r"(\w+)(n't)", tok, flags=re.IGNORECASE)
    if m:
        base = m.group(1)
        bl = base.lower()
        if bl == "ca" or bl == "can":
            base = base[:2]  # can't -> ca n't
        elif bl == "won" or bl == "wo":
            base = base[:2]  # won't -> wo n't
        elif bl == "shan" or bl == "sha":
            base = base[:3]
        return [base, m.group(2)]
    if re.fullmatch(r"\w+s'", tok, flags=re.IGNORECASE):
        return [tok[:-1], "'"]  # plural possessive

    # mid-token sentence punctuation glued between words ("end.start")
    m = re.match(r"^([^\s,!?;]+)([,!?;])(.+)$", tok)
    if m and not (m.group(2) == "," and m.group(1)[-1:].isdigit()
                  and m.group(3)[:1].isdigit()):
        return (_split_word(m.group(1)) + [m.group(2)]
                + _split_word(m.group(3)))

    return [tok]


def tokenize_line(line: str, lowercase: bool = True) -> List[str]:
    """PTBTokenizer -preserveLines [-lowerCase] of one line."""
    s = line
    for u, r in _UNICODE_MAP.items():
        s = s.replace(u, r)
    s = s.replace("&amp;", "&").replace("&quot;", '"')
    # straight double quotes: opening if preceded by start/space, else closing
    s = re.sub(r'(^|\s)"', r"\1 `` ", s)
    s = s.replace('"', " '' ")
    # separate -- when attached to words
    s = re.sub(r"(\w)--(\w)", r"\1 -- \2", s)
    s = re.sub(r"\.\.\.", " ... ", s)
    toks: List[str] = []
    for chunk in s.split():
        toks.extend(_split_word(chunk))
    if lowercase:
        toks = [t.lower() for t in toks]
    return [t for t in toks if t]


def ptb_tokenize(captions: Dict) -> Dict:
    """pycocoevalcap PTBTokenizer.tokenize contract:
    id -> [{'caption': str}, ...]  =>  id -> ['tok tok ...', ...],
    lowercased, with the PUNCTUATIONS filter applied post-lowercase."""
    drop = set(PUNCTUATIONS)
    out = {}
    for k, entries in captions.items():
        lst = []
        for e in entries:
            s = e["caption"] if isinstance(e, dict) else e
            toks = [t for t in tokenize_line(s.replace("\n", " "))
                    if t not in drop]
            lst.append(" ".join(toks))
        out[k] = lst
    return out
