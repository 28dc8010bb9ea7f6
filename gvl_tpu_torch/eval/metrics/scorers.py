"""Pure-Python caption scorers with pycocoevalcap-compatible APIs.

The reference's metric harness shells out to Java (METEOR 1.5 jar, Stanford
PTBTokenizer — reference densevid_eval3/pycocoevalcap_bak/meteor/meteor.py,
tokenizer/ptbtokenizer.py). This environment has no JVM, so the scorers are
reimplemented natively:

- Bleu: corpus BLEU-1..4, clipped counts, 'closest' effective ref length —
  same math as pycocoevalcap's BleuScorer (per-sentence scores use +1
  smoothing like the original's running ratios).
- CiderD: TF-IDF n-gram cosine with length gaussian (sigma=6) and count
  clipping, df from the per-call corpus, x10 scale — CIDEr-D.
- Rouge: ROUGE-L F with beta=1.2.
- Meteor: faithful METEOR 1.5 port (gvl_tpu_torch/eval/metrics/meteor.py) —
  normalizer, exact+Snowball-stem (+WordNet synonym / paraphrase when their
  data files are present) beam alignment, content/function-word delta
  weighting, en task parameters, jar-style aggregate corpus scoring.
- ptb_tokenize: faithful Stanford PTBTokenizer port
  (gvl_tpu_torch/eval/metrics/ptb_tokenizer.py) with pycocoevalcap's
  post-tokenization punctuation filter semantics.

APIs: compute_score(gts, res) where gts/res map id -> list[str] (tokenized
sentences); returns (corpus_score, per_id_scores).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

from gvl_tpu_torch.eval.metrics.meteor import Meteor  # noqa: F401 (re-export)
from gvl_tpu_torch.eval.metrics.ptb_tokenizer import \
    ptb_tokenize  # noqa: F401 (re-export)


def _ngrams(words: List[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


class Bleu:
    def __init__(self, n: int = 4):
        self.n = n

    def method(self):
        return "Bleu"

    def compute_score(self, gts, res) -> Tuple[List[float], List[List[float]]]:
        n = self.n
        total_clip = [0] * n
        total_count = [0] * n
        hyp_len_sum, ref_len_sum = 0, 0
        per_sentence: List[List[float]] = [[] for _ in range(n)]

        keys = list(res.keys())
        for k in keys:
            hyp = res[k][0].split()
            refs = [r.split() for r in gts[k]]
            hyp_len = len(hyp)
            # closest reference length
            ref_len = min((abs(len(r) - hyp_len), len(r)) for r in refs)[1] \
                if refs else 0
            hyp_len_sum += hyp_len
            ref_len_sum += ref_len
            s_clip, s_cnt = [0] * n, [0] * n
            for i in range(n):
                h_ng = _ngrams(hyp, i + 1)
                max_ref = Counter()
                for r in refs:
                    for ng, c in _ngrams(r, i + 1).items():
                        max_ref[ng] = max(max_ref[ng], c)
                clipped = sum(min(c, max_ref[ng]) for ng, c in h_ng.items())
                s_clip[i] = clipped
                s_cnt[i] = max(len(hyp) - i, 0)
                total_clip[i] += clipped
                total_count[i] += s_cnt[i]
            # per-sentence bleu with +1 smoothing, own brevity penalty
            bp_s = 1.0 if hyp_len >= ref_len else \
                math.exp(1 - ref_len / hyp_len) if hyp_len > 0 else 0.0
            run = 1.0
            for i in range(n):
                run *= (s_clip[i] + 1.0) / (s_cnt[i] + 1.0)
                per_sentence[i].append(bp_s * (run ** (1.0 / (i + 1))))

        bp = 1.0 if hyp_len_sum >= ref_len_sum else \
            math.exp(1 - ref_len_sum / max(hyp_len_sum, 1))
        scores = []
        run = 1.0
        for i in range(n):
            prec = total_clip[i] / max(total_count[i], 1)
            run *= max(prec, 1e-16)
            scores.append(bp * (run ** (1.0 / (i + 1))))
        return scores, per_sentence


class Rouge:
    beta = 1.2

    def method(self):
        return "Rouge"

    @staticmethod
    def _lcs(a: List[str], b: List[str]) -> int:
        dp = [0] * (len(b) + 1)
        for i in range(1, len(a) + 1):
            prev = 0
            for j in range(1, len(b) + 1):
                cur = dp[j]
                dp[j] = prev + 1 if a[i - 1] == b[j - 1] else \
                    max(dp[j], dp[j - 1])
                prev = cur
        return dp[len(b)]

    def compute_score(self, gts, res):
        scores = []
        for k in res:
            hyp = res[k][0].split()
            best = 0.0
            for ref in gts[k]:
                r = ref.split()
                lcs = self._lcs(hyp, r)
                p = lcs / len(hyp) if hyp else 0.0
                rec = lcs / len(r) if r else 0.0
                if p > 0 and rec > 0:
                    b2 = self.beta ** 2
                    best = max(best, (1 + b2) * p * rec / (rec + b2 * p))
            scores.append(best)
        return (sum(scores) / max(len(scores), 1), scores)


class Cider:
    """CIDEr-D: clipped TF-IDF n-gram cosine with length gaussian, df from
    the evaluation corpus, scale x10."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self):
        return "Cider"

    def compute_score(self, gts, res, df_override=None, log_m_override=None,
                      corpus=None):
        """(mean, per-key scores) of `res` against `gts`. The document
        frequencies come from `df_override`, else from `corpus` (a list of
        reference lists), else from the references of `gts`' keys."""
        keys = list(res.keys())
        if df_override is not None:
            # precomputed corpus df (single dict keyed by ngram tuple of any
            # order, as in the cider package's df_mode='corpus')
            df = [df_override] * self.n
            log_m = float(log_m_override)
        else:
            # document frequencies over reference sets
            df = [defaultdict(float) for _ in range(self.n)]
            docs = corpus if corpus is not None else [gts[k] for k in keys]
            for refs in docs:
                for i in range(self.n):
                    seen = set()
                    for ref in refs:
                        seen |= set(_ngrams(ref.split(), i + 1).keys())
                    for ng in seen:
                        df[i][ng] += 1.0
            log_m = math.log(max(len(docs), 1))

        def vecs(words):
            out, norms, length = [], [], len(words)
            for i in range(self.n):
                cnt = _ngrams(words, i + 1)
                v = {ng: c * (log_m - math.log(max(df[i].get(ng, 0.0), 1.0)))
                     for ng, c in cnt.items()}
                out.append(v)
                norms.append(math.sqrt(sum(x * x for x in v.values())))
            return out, norms, length

        scores = []
        for k in keys:
            hyp_v, hyp_n, hyp_len = vecs(res[k][0].split())
            score = 0.0
            for ref in gts[k]:
                ref_v, ref_n, ref_len = vecs(ref.split())
                delta = hyp_len - ref_len
                for i in range(self.n):
                    num = sum(min(hyp_v[i].get(ng, 0.0), ref_v[i][ng]) * ref_v[i][ng]
                              for ng in ref_v[i])
                    den = hyp_n[i] * ref_n[i]
                    sim = num / den if den > 0 else 0.0
                    sim *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    score += sim / self.n
            scores.append(score * 10.0 / max(len(gts[k]), 1))
        return (sum(scores) / max(len(scores), 1), scores)


