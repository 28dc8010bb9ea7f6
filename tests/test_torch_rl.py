"""The port's SCST (gvl_tpu_torch.train.rl, match_layer_m2o, the sampled
decode and the SCST branches of the train step) against the JAX package's.

The host-side copies (token strings, rewards, CIDEr-D's document-frequency
cache) must equal JAX's exactly on the same numpy inputs; the policy loss
within 1e-6. The many-to-one matcher is held to JAX on tie-free costs by
the set of queries each GT gets (its `rate` replica columns are tied by
construction, so the slot order may differ). The SCST step, fused and per
layer, runs against the jitted JAX step from the same weights on the same
batch: JAX's rollouts and matches are captured in this process (its reward
callback and its m2o matcher wrapped by monkeypatch), the port's draws are
forced to JAX's tokens keyed by (layer, video, query), and the losses, the
rewards and the caption head's gradients are compared.
"""

import math
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvl_tpu.train.criterion as jcrit
import gvl_tpu.train.rl as jrl
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu_torch.convert import jax_grads_to_named
from gvl_tpu_torch.models import captioner as pcap
from gvl_tpu_torch.models.gvl import GVLArch
from gvl_tpu_torch.train import criterion as pcrit
from gvl_tpu_torch.train import rl as prl
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from tests.test_torch_model import jax_world
from tests.test_torch_train_step import (LOSS_SIDE, adam_mu, make_batch,
                                         statics_kw)


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def token_rows(rs, n, L, vocab=30, p_eos=0.15):
    """Token-id rows with a 0 somewhere in most of them."""
    x = rs.randint(1, vocab, (n, L))
    x[rs.rand(n, L) < p_eos] = 0
    return x.astype(np.int32)


# ------------------------------------------------------------- host copies

def test_array_to_str_equals_jax(rs):
    rows = token_rows(rs, 20, 9)
    for r in rows:
        assert prl.array_to_str(r) == jrl.array_to_str(r)
    for i in range(0, 20, 4):
        block = rows[i:i + 4]
        assert prl.array_to_str_para(block) == jrl.array_to_str_para(block)
    assert prl.array_to_str([5, 3, 0, 9]) == "5 3 0"


@pytest.mark.parametrize("types", [["Meteor"], ["Meteor", "CiderD"]])
def test_get_caption_reward_equals_jax(rs, types):
    weights = {"Meteor": 0.95, "CiderD": 0.05}
    gen, greedy = token_rows(rs, 12, 8), token_rows(rs, 12, 8)
    gt = token_rows(rs, 12, 10)
    gt[:, 0] = 0
    gen[:3] = gt[:3, 1:9]             # some rollouts hit their reference
    want = jrl.get_caption_reward(jrl.init_scorer(types), greedy, gt, gen,
                                  weights)
    got = prl.get_caption_reward(prl.init_scorer(types), greedy, gt, gen,
                                 weights)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("case", ["plain", "m2o4_groups2_para"])
def test_rl_reward_callback_equals_jax(rs, case):
    """Sentence rewards alone (rate 1, one group), and the fused layout of
    two layers with m2o 4 and both sentence and paragraph rewards: the
    rewards equal JAX's exactly."""
    rate, groups, para = (1, 1, 0.0) if case == "plain" else (4, 2, 0.5)
    B, G0, L = 3, 3, 7
    G = rate * G0 * groups
    gen = token_rows(rs, B * G, L).reshape(B, G, L)
    greedy = token_rows(rs, B * G, L).reshape(B, G, L)
    gt = np.tile(token_rows(rs, B * G0, L + 1).reshape(B, G0, L + 1),
                 (1, rate * groups, 1))
    valid = rs.rand(B, G) > 0.3
    valid[1] = False                  # a video without a valid slot
    kw = dict(m2o_rate=rate, n_groups=groups)
    types = ["Meteor", "CiderD"]
    w = {"Meteor": 0.95, "CiderD": 0.05}
    want = jrl.rl_reward_callback(jrl.init_scorer(types), w, 1.0, para,
                                  **kw)(gen, greedy, gt, valid)
    got = prl.rl_reward_callback(prl.init_scorer(types), w, 1.0, para,
                                 **kw)(gen, greedy, gt, valid)
    np.testing.assert_array_equal(got, want)
    assert (got[1] == 0).all() and (got != 0).any()


def test_ciderd_document_frequency_cache_equals_jax(rs, tmp_path):
    """A document-frequency pickle built from synthetic token-id captions,
    as the reference's cache is (rl_tool.py:15-31): both CiderD read it and
    score alike, and without it both take the per-call frequencies."""
    docs = [" ".join(map(str, r[r > 0])) for r in token_rows(rs, 40, 8, 12)]
    df = {}
    for d in docs:
        words = d.split()
        grams = {tuple(words[i:i + n]) for n in range(1, 5)
                 for i in range(len(words) - n + 1)}
        for g in grams:
            df[g] = df.get(g, 0.0) + 1.0
    path = tmp_path / "ngrams.p"
    with open(path, "wb") as f:
        pickle.dump({"document_frequency": df,
                     "ref_len": math.log(float(len(docs)))}, f)
    gts = {i: [docs[i]] for i in range(10)}
    res = {i: [docs[(i + 1) % 10] if i % 3 else docs[i]] for i in range(10)}
    for df_path in (str(path), str(tmp_path / "missing")):
        want = jrl.CiderD(df=df_path)
        got = prl.CiderD(df=df_path)
        assert (got.df_cache is None) == (want.df_cache is None)
        s_want, per_want = want.compute_score(gts, res)
        s_got, per_got = got.compute_score(gts, res)
        assert s_got == s_want
        np.testing.assert_array_equal(np.asarray(per_got),
                                      np.asarray(per_want))
    assert prl.CiderD(df=str(path)).compute_score(gts, res)[0] > 0


def test_rl_policy_loss_matches_jax(rs):
    """Within 1e-6, invalid pairs and rollouts that end early included."""
    B, G, L = 3, 5, 7
    lps = rs.uniform(-5, 0, (B, G, L)).astype(np.float32)
    seq = token_rows(rs, B * G, L).reshape(B, G, L)
    rewards = rs.randn(B, G).astype(np.float32)
    valid = rs.rand(B, G) > 0.3
    want = float(jrl.rl_policy_loss(jnp.asarray(lps), jnp.asarray(seq),
                                    jnp.asarray(rewards), jnp.asarray(valid)))
    got = float(prl.rl_policy_loss(torch.from_numpy(lps),
                                   torch.from_numpy(seq),
                                   torch.from_numpy(rewards),
                                   torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------- matcher

@pytest.mark.parametrize("Nq", [16, 10])
def test_match_layer_m2o_matches_jax(rs, Nq):
    """rate*G = 12 below Nq = 16 (every GT gets `rate` queries) and above
    Nq = 10 (dummy rows; all queries used), on tie-free costs: per GT the
    same set of queries. Which replica slots of a GT hold them is a tie,
    and so, above Nq, is which of them stay empty."""
    B, G, rate = 4, 3, 4
    cost = rs.randn(B, Nq, G).astype(np.float32)
    gt_mask = np.arange(G)[None, :] < np.array([3, 2, 1, 0])[:, None]
    cost = np.where(gt_mask[:, None, :], cost, 0.0).astype(np.float32)
    mq_j, valid_j = map(np.asarray, jax.jit(
        lambda c, m: jcrit.match_layer_m2o(c, m, rate))(
            jnp.asarray(cost), jnp.asarray(gt_mask)))
    mq_p, valid_p = pcrit.match_layer_m2o(torch.from_numpy(cost),
                                          torch.from_numpy(gt_mask), rate)
    mq_p, valid_p = mq_p.numpy(), valid_p.numpy()
    assert (mq_p[~valid_p] == 0).all()
    for b in range(B):
        for g in range(G):
            slots = [r * G + g for r in range(rate)]
            want = {int(mq_j[b, s]) for s in slots if valid_j[b, s]}
            got = {int(mq_p[b, s]) for s in slots if valid_p[b, s]}
            assert got == want, (b, g)
        n = int(gt_mask[b].sum())
        assert valid_p[b].sum() == min(Nq, rate * n)
        qs = mq_p[b][valid_p[b]]
        assert len(set(qs.tolist())) == len(qs)         # one slot a query


# --------------------------------------------------------------- sampling

@pytest.fixture(scope="module")
def head():
    """A tiny LSTM-DSA head with its inputs: 2 videos, 5 events, 3 levels,
    seeded weights, no dropout."""
    g = torch.Generator().manual_seed(0)
    h = pcap.LSTMDSACaptioner(vocab_size=20, input_encoding_size=16,
                              rnn_size=16, d_model=32, n_levels=3, n_heads=1,
                              n_points=4, att_hid_size=16, max_caption_len=7,
                              drop_prob=0.0)
    with torch.no_grad():
        for p in h.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    shapes = (12, 6, 3)
    B, Ne, S = 2, 5, sum(shapes)
    inputs = dict(query=torch.randn(B, Ne, 32, generator=g),
                  reference=torch.rand(B, Ne, 1, generator=g),
                  memory=torch.randn(B, S, 32, generator=g),
                  memory_mask=torch.ones(B, S, dtype=torch.bool),
                  temporal_shapes=shapes,
                  valid_ratios=torch.ones(B, 3))
    return h.train(), inputs


def test_sampled_logprobs_equal_teacher_forcing(head):
    """A sampled rollout s has, up to and with its first 0, the logprobs
    that teacher forcing of [0 | s] gives to s (the same inputs, the same
    hidden states): atol 1e-5. They are differentiable."""
    h, x = head
    gen = torch.Generator().manual_seed(3)
    seq, lps = h.sample(**x, greedy=False, temperature=1.0, generator=gen)
    assert lps.requires_grad and lps.dtype == torch.float32
    tf = h(x["query"], x["reference"], x["memory"], x["memory_mask"],
           x["temporal_shapes"], x["valid_ratios"],
           torch.cat([torch.zeros_like(seq[..., :1]), seq], -1))
    picked = torch.gather(tf, 3, seq[..., None])[..., 0]
    read = torch.cat([torch.ones_like(seq[..., :1]), (seq > 0)[..., :-1]],
                     -1).bool()
    assert read.sum() > read.shape[0] * read.shape[1]      # rollouts go on
    np.testing.assert_allclose(lps[read].detach().numpy(),
                               picked[read].detach().numpy(), atol=1e-5)


def test_seeded_sampling_repeats_and_greedy_is_the_argmax(head):
    h, x = head
    draws = [h.sample(**x, greedy=False, temperature=0.7,
                      generator=torch.Generator().manual_seed(11))[0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    other = h.sample(**x, greedy=False, temperature=0.7,
                     generator=torch.Generator().manual_seed(12))[0]
    assert not torch.equal(draws[0], other)
    with torch.no_grad():
        g1, l1 = h.eval().sample(**x)
        g2, l2 = h.sample(**x, greedy=True)
    h.train()
    assert torch.equal(g1, g2) and torch.equal(l1, l2)


def test_draw_frequencies_follow_softmax_over_temperature():
    """20000 draws per row at a fixed seed from three rows of logits:
    Pearson's chi-square against softmax(z / T) stays below the 0.999
    quantile of its distribution (the bins with an expected count of 5 or
    more)."""
    from scipy.stats import chi2
    z = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5, -3.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                      [5.0, 1.0, 2.0, 0.0, 3.0, 1.5]])
    T, n = 0.8, 20000
    gen = torch.Generator().manual_seed(5)
    counts = np.zeros(z.shape)
    for _ in range(n // 100):
        d = pcap.draw_tokens(z[None].expand(100, -1, -1), T, gen).numpy()
        for r in range(z.shape[0]):
            counts[r] += np.bincount(d[:, r], minlength=z.shape[1])
    expect = n * torch.softmax(z / T, -1).numpy()
    for r in range(z.shape[0]):
        keep = expect[r] >= 5
        stat = ((counts[r][keep] - expect[r][keep]) ** 2
                / expect[r][keep]).sum()
        assert stat < chi2.ppf(0.999, keep.sum() - 1), (r, stat)


# ------------------------------------------------------------ the SCST step

RL_SIDE = dict(LOSS_SIDE, caption_loss_type="rl", only_ft_captioner=True,
               optimizer_type="adamw", weight_decay=1e-4,
               rl_scorer_types=["Meteor", "CiderD"],
               rl_scorer_weights=[0.95, 0.05])


def run_jax_step(cfg, model, params, batch, monkeypatch):
    """One jitted JAX SCST step; returns (losses, the caption head's clipped
    gradients read from AdamW's first moment, the new params, the captured
    m2o matches (mq, valid) per call and reward calls (gen, greedy, valid,
    rewards))."""
    matches, rewards = [], []
    orig_m2o, orig_cb = jcrit.match_layer_m2o, jrl.rl_reward_callback

    def m2o(cost, gt_mask, rate):
        mq, valid = orig_m2o(cost, gt_mask, rate)
        jax.debug.callback(lambda a, b: matches.append(
            (np.asarray(a), np.asarray(b))), mq, valid)
        return mq, valid

    def callback(*a, **k):
        host_fn = orig_cb(*a, **k)

        def wrapped(gen, greedy, gt, valid):
            r = host_fn(gen, greedy, gt, valid)
            rewards.append((np.asarray(gen), np.asarray(greedy),
                            np.asarray(valid), np.asarray(r)))
            return r
        return wrapped

    monkeypatch.setattr(jcrit, "match_layer_m2o", m2o)
    monkeypatch.setattr(jrl, "rl_reward_callback", callback)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg),
                             **dict(statics_kw(cfg), caption_rl=True))
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32)
          for k, v in j_weight_dict(cfg).items()}
    state, losses = jax.jit(step_fn)(state, db, jw, jax.random.PRNGKey(0))
    losses = {k: float(v) for k, v in losses.items()}
    mu = adam_mu(state.opt_state)["params"]["caption_head_0"]
    grads = jax.tree_util.tree_map(np.zeros_like, params)
    grads["params"]["caption_head_0"] = jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, mu)
    return losses, grads, state.params, matches, rewards


@pytest.mark.parametrize("fuse", [True, False])
def test_scst_step_matches_jax(fuse, monkeypatch):
    """One SCST step (m2o 4 over G = 3 GT slots of 10 queries: dummy rows,
    every query used; Meteor 0.95 + CiderD 0.05; AdamW under
    only_ft_captioner), fused (one sampled and one greedy chain for both
    layers) and per layer. The port's matches hold per GT the queries
    JAX's do; its greedy rollouts and rewards equal JAX's slot for slot
    once keyed by (layer, video, query); its draws are forced to JAX's
    tokens so keyed. Losses: rtol 1e-4 / atol 1e-6. The caption head's
    clipped gradients (JAX's read from AdamW's first moment): max abs
    difference <= 1e-3 x their max abs + 1e-7. Only the caption head
    moves in either package."""
    cfg, model, params, port, sd0 = jax_world(
        **dict(RL_SIDE, fuse_caption_layers=fuse))
    batch = make_batch(cfg)
    want, jgrads, jparams, jmatch, jrew = run_jax_step(cfg, model, params,
                                                       batch, monkeypatch)
    Ld, B, G = cfg.dec_layers, batch["gt_mask"].shape[0], 3
    (mq_j, valid_j), = jmatch                     # (Ld*B, rate*G)
    assert len(jrew) == (1 if fuse else Ld)
    C = mq_j.shape[1]
    if not fuse:
        # under jit the per-layer host callbacks run in no fixed order: each
        # is the layer whose valid mask it carries (they differ here)
        masks = [valid_j[l * B:(l + 1) * B] for l in range(Ld)]
        assert not np.array_equal(masks[0], masks[1])
        jrew = [next(r for r in jrew if np.array_equal(r[2], m))
                for m in masks]
    gen_j = np.concatenate([r[0] for r in jrew], 1)   # (B, Ld*C, L)
    greedy_j = np.concatenate([r[1] for r in jrew], 1)
    rew_j = np.concatenate([r[3] for r in jrew], 1)

    pmatch, prew, calls = [], [], []
    orig_m2o, orig_cb = pcrit.match_layer_m2o, prl.rl_reward_callback

    def m2o(cost, gt_mask, rate):
        out = orig_m2o(cost, gt_mask, rate)
        pmatch.append(tuple(x.numpy() for x in out))
        return out

    def jax_slot(l, b, s):
        """JAX's slot (in the layers' concatenation) of the query the port
        put in slot s of layer l, video b."""
        mq_p = pmatch[0][0]
        q = mq_p[l * B + b, s]
        hit = np.nonzero(valid_j[l * B + b] & (mq_j[l * B + b] == q))[0]
        assert len(hit) == 1 and hit[0] % G == s % G, (l, b, s)
        return l * C + hit[0]

    def forced():
        """JAX's tokens at the port's valid slots, per sample call."""
        mq_p, valid_p = pmatch[0]
        out = np.zeros((B, Ld * C, gen_j.shape[-1]), np.int64)
        for l in range(Ld):
            for b in range(B):
                for s in np.nonzero(valid_p[l * B + b])[0]:
                    out[b, l * C + s] = gen_j[b, jax_slot(l, b, s)]
        return [out] if fuse else [out[:, l * C:(l + 1) * C]
                                   for l in range(Ld)]

    def draw(z, temperature, generator=None):
        n = len(calls)
        calls.append(z.shape)
        chain, t = divmod(n, cfg.max_caption_len)
        return torch.from_numpy(forced()[chain][:, :, t]).to(z.device)

    def callback(*a, **k):
        host_fn = orig_cb(*a, **k)

        def wrapped(gen, greedy, gt, valid):
            r = host_fn(gen, greedy, gt, valid)
            prew.append((gen, greedy, valid, r))
            return r
        return wrapped

    monkeypatch.setattr(pcrit, "match_layer_m2o", m2o)
    monkeypatch.setattr(pcap, "draw_tokens", draw)
    monkeypatch.setattr(prl, "rl_reward_callback", callback)
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg),
                             **dict(statics_kw(cfg), caption_rl=True))
    state = pstate.create_train_state(cfg, port, 100, pst)
    step = pstate.make_train_step(port, cfg, pst)
    try:
        got = {k: float(v) for k, v in
               step(state, batch, make_weight_dict(cfg)).items()}
    finally:
        port.eval()
    assert len(calls) == cfg.max_caption_len * (1 if fuse else Ld)

    # matches: per GT the same queries (jax_slot), as many in all
    mq_p, valid_p = pmatch[0]
    assert valid_p.sum() == valid_j.sum()
    assert valid_p.sum() == Ld * sum(min(cfg.num_queries, 4 * n)
                                     for n in batch["gt_mask"].sum(-1))
    # greedy rollouts and rewards, keyed by query
    greedy_p = np.concatenate([r[1] for r in prew], 1)
    rew_p = np.concatenate([r[3] for r in prew], 1)
    for l in range(Ld):
        for b in range(B):
            for s in np.nonzero(valid_p[l * B + b])[0]:
                js = jax_slot(l, b, s)
                np.testing.assert_array_equal(greedy_p[b, l * C + s],
                                              greedy_j[b, js])
                assert rew_p[b, l * C + s] == rew_j[b, js], (l, b, s)
    assert (rew_p != 0).any()

    assert set(got) == set(want)
    assert {"loss_caption", "loss_caption_0"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)

    arch = GVLArch.from_config(cfg)
    jg = jax_grads_to_named(jgrads, arch)
    head = [n for n, _ in port.named_parameters()
            if n.startswith("caption_head.0.")]
    assert head
    for n in head:
        p = dict(port.named_parameters())[n]
        w = jg[n].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-7, (n, err)
    moved_p = {k for k, v in port.state_dict().items()
               if not torch.equal(v, sd0[k])}
    assert moved_p and all(k.startswith("caption_head.") for k in moved_p)
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    j0 = dict(jax.tree_util.tree_leaves_with_path(params))
    moved_j = {path[1].key for path, v in jflat
               if not np.array_equal(np.asarray(v), np.asarray(j0[path]))}
    assert moved_j == {"caption_head_0"}


def test_caption_rl_is_ported_and_bf16_rollouts_are_refused():
    """caption_rl is no longer refused; bf16 rollouts still are, by name."""
    cfg, _, _, port, _ = jax_world(**RL_SIDE)
    ok = pstate.StepStatics(spec=LossSpec.from_config(cfg),
                            **dict(statics_kw(cfg), caption_rl=True))
    pstate.make_train_step(port, cfg, ok)
    bf16 = pstate.StepStatics(spec=LossSpec.from_config(cfg),
                              **dict(statics_kw(cfg), caption_rl=True,
                                     caption_bf16=True))
    with pytest.raises(NotImplementedError, match="caption_bf16"):
        pstate.make_train_step(port, cfg, bf16)
