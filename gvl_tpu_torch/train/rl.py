"""SCST (self-critical sequence training) reinforcement fine-tuning.

Port of gvl_tpu/train/rl.py (reference pdvc/rl_tool.py and the RL branch of
pdvc/pdvc.py:764-810):
- a multinomial rollout (train mode) and a greedy rollout (eval mode) for
  every matched (query, GT) pair;
- reward = weighted scorer mix (Meteor 0.95 + CiderD 0.05 in the shipped
  cfgs) of sampled-vs-GT minus greedy-vs-GT, computed over token-ID STRINGS
  (rl_tool.py:46-52 array_to_str: the scorers see "17 4 382");
- policy-gradient loss -logprob * advantage with the token mask shifted
  right by one (build_rl_loss, LSTM_DSA.py:54-61);
- sentence-level and paragraph-level rewards mixed by cl_sent_ratio /
  cl_para_ratio (pdvc.py:779-803).

The scorers run on the host over numpy copies of the rollouts: the port's
counterpart of the JAX package's pure_callback. The scorers are the port's
own copies (gvl_tpu_torch/eval/metrics/scorers.py).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from gvl_tpu_torch.eval.metrics.scorers import Cider, Meteor


class CiderD(Cider):
    """CIDEr-D with an optional precomputed document-frequency corpus
    (reference rl_tool.py:15-31: `CiderD(df=opt.cached_tokens)` loads a
    pickle of ANet-train token-id ngram dfs: {'document_frequency':
    {ngram_tuple: df}, 'ref_len': log(#docs)}). When the cache is present
    its df/ref_len replace the per-call corpus statistics, as the cider
    package's df_mode='corpus'; otherwise the per-call df is used."""

    def __init__(self, df: Optional[str] = None, n: int = 4,
                 sigma: float = 6.0):
        super().__init__(n=n, sigma=sigma)
        self.df_cache = None
        self.ref_len = None
        for path in ([df, df + ".p", os.path.join("data", str(df) + ".p")]
                     if df else []):
            if path and os.path.exists(path):
                with open(path, "rb") as f:
                    blob = pickle.load(f)
                self.df_cache = blob["document_frequency"]
                self.ref_len = float(blob["ref_len"])
                break

    def compute_score(self, gts, res):
        if self.df_cache is None:
            return super().compute_score(gts, res)
        return super().compute_score(
            gts, res, df_override=self.df_cache, log_m_override=self.ref_len)


def array_to_str(arr) -> str:
    out = []
    for x in arr:
        out.append(str(int(x)))
        if int(x) == 0:
            break
    return " ".join(out)


def array_to_str_para(arr2d) -> str:
    parts = []
    for sub in arr2d:
        parts.append(array_to_str(sub).rstrip("0").strip())
    return " ".join(p for p in parts if p)


def init_scorer(types: Optional[List[str]] = None,
                cached_tokens: Optional[str] = None) -> Dict:
    types = types or ["Meteor", "CiderD"]
    scorers = {}
    for t in types:
        if t == "CiderD":
            scorers[t] = CiderD(df=cached_tokens)
        else:
            # token-ID strings: Snowball stems of digit tokens are identities
            # and WordNet synonyms never fire, so without those modules the
            # score is the same and the per-step host work is smaller
            scorers[t] = Meteor(use_synonyms=False, use_stem=False)
    return scorers


def get_caption_reward(scorers: Dict, greedy_res: np.ndarray,
                       gt_tokens: np.ndarray, gen_result: np.ndarray,
                       score_weights: Dict[str, float],
                       is_para: bool = False) -> np.ndarray:
    """rewards = score(sampled) - score(greedy), per pair."""
    n = len(gen_result)
    to_str = array_to_str_para if is_para else array_to_str
    res = {i: [to_str(gen_result[i])] for i in range(n)}
    res.update({n + i: [to_str(greedy_res[i])] for i in range(n)})
    gts = {i: [array_to_str(gt_tokens[i % n][1:])] for i in range(2 * n)}

    total = np.zeros(2 * n)
    for name, scorer in scorers.items():
        _, per = scorer.compute_score(gts, res)
        total = total + score_weights.get(name, 0.0) * np.asarray(per)
    return (total[:n] - total[n:]).astype(np.float32)


def rl_reward_callback(scorers: Dict, score_weights: Dict[str, float],
                       sent_ratio: float, para_ratio: float,
                       m2o_rate: int = 1, n_groups: int = 1):
    """The host reward function of the SCST step.

    Inputs (numpy): gen (B,G,L) int, greedy (B,G,L) int, gt (B,G,Lc) int,
    valid (B,G) bool. Output: rewards (B,G) float32. G may be m2o_rate x
    the GT width (many-to-one rollouts); the paragraph GT then uses each
    caption once (slots [0, G/m2o_rate)).

    n_groups > 1: the G axis carries `n_groups` decoder layers' rollouts
    concatenated (the fused path: one host call for all layers). Sentence
    rewards are per slot; paragraph rewards per (video, layer) block, so
    fused == per-layer exactly."""

    def host_fn(gen, greedy, gt, valid):
        B, G, L = gen.shape
        Gg = G // max(n_groups, 1)           # slots per layer group
        G0 = Gg // max(m2o_rate, 1)          # GT width within a group
        gen_f = gen.reshape(B * G, L)
        greedy_f = greedy.reshape(B * G, L)
        gt_f = gt.reshape(B * G, -1)
        rewards = np.zeros((B * G,), np.float32)
        vmask = valid.reshape(B * G).astype(bool)
        if sent_ratio > 0 and vmask.any():
            idx = np.nonzero(vmask)[0]
            r = get_caption_reward(scorers, greedy_f[idx], gt_f[idx],
                                   gen_f[idx], score_weights)
            rewards[idx] += sent_ratio * r
        if para_ratio > 0:
            genb = gen.reshape(B, n_groups, Gg, L)
            greedyb = greedy.reshape(B, n_groups, Gg, L)
            gtb = gt.reshape(B, n_groups, Gg, -1)
            validb = valid.reshape(B, n_groups, Gg)
            para_r = np.zeros((B, n_groups), np.float32)
            for b in range(B):
                for g in range(n_groups):
                    if not validb[b, g].any():
                        continue
                    keep = np.nonzero(validb[b, g])[0]
                    # paragraph GT: each caption once (replica-0 slots only)
                    keep_gt = keep[keep < G0] if m2o_rate > 1 else keep
                    if len(keep_gt) == 0:
                        keep_gt = keep
                    r = get_caption_reward(
                        scorers, greedyb[b, g][keep][None].astype(np.int64),
                        gtb[b, g][keep_gt].reshape(1, -1),
                        genb[b, g][keep][None].astype(np.int64),
                        score_weights, is_para=True)
                    para_r[b, g] = r[0]
            rewards += para_ratio * np.repeat(para_r.reshape(-1), Gg)
        return rewards.reshape(B, G)

    return host_fn


def rl_policy_loss(sample_logprobs: torch.Tensor, gen_seq: torch.Tensor,
                   rewards: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """-logprob * advantage over generated tokens (reference build_rl_loss:
    mask = (seq>0) shifted right with a leading 1; an invalid pair keeps a
    leading-1 mask with zero reward, as the reference's zeroed-seq handling
    at pdvc.py:805)."""
    B, G, L = gen_seq.shape
    lp = sample_logprobs.reshape(B * G, L)
    seq = (gen_seq * valid[..., None]).reshape(B * G, L)
    rew = (rewards * valid).reshape(B * G, 1).to(lp.dtype).expand(-1, L)
    mask = (seq > 0).to(lp.dtype)
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
    out = -lp * rew * mask
    return out.sum() / (mask.sum() + 1e-6)
