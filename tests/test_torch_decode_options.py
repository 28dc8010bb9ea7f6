"""The port's decode options against the JAX package's, at a tiny config
with the LSTM-DSA head: beam search, early exit, the bf16 decode
(eval_decode_bf16), bf16 teacher forcing and SCST rollouts
(train_caption_bf16), eval_full_bf16 and the rule its bf16 taps follow.

One world (tests/test_torch_caption_heads.py fast_world): a JAX model and
the port with the same weights, the caption head fed the JAX trunk's
outputs. Random weights put many argmaxes within a bf16 rounding of each
other, so under bf16 the free-running tokens of the two frameworks are not
compared (tests/test_bf16_decode.py:39-41): JAX's tokens are forced into the
port's bf16 chain and the chosen logprobs compared. Tolerances are stated
where they are used.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvl_tpu.ops.ms_deform_attn as jmsda
from gvl_tpu.config import Config
from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.data.synthetic import make_synthetic_dataset
from gvl_tpu.eval.evaluate import EvalRunner as JaxEvalRunner
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu.utils.amp import bf16_cast_tree
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.models import captioner as pcap
from gvl_tpu_torch.models import layers as players
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.ops.ms_deform_attn import prep_taps
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from gvl_tpu_torch.utils.amp import to_bf16
from tests.test_torch_caption_heads import (draw_params, eos_biased,
                                            fast_world, head_inputs,
                                            jax_sample, port_sample)
from tests.test_torch_train_step import adam_mu, make_batch, statics_kw

BF16 = jnp.bfloat16
# bf16 logprobs: the two frameworks round the bf16 chain's matmuls, norms and
# softmaxes at other places, a bf16 ulp (2^-8 relative) here and there
BF16_LP_ATOL = 0.05


@functools.lru_cache(maxsize=None)
def world():
    cfg, model, params, port, inputs = fast_world(
        caption_decoder_type="standard")
    arrs, shapes, _ = head_inputs(model, params, inputs, cfg)
    return dict(cfg=cfg, model=model, params=params, port=port,
                inputs=inputs, arrs=arrs, shapes=shapes)


def alive_mask(seq):
    """Steps up to and including each caption's first EOS."""
    ended = np.cumsum(seq == 0, axis=-1)
    return (ended - (seq == 0)) == 0


# ----------------------------------------------------------- beam search
def test_beam_size_1_equals_greedy():
    w = world()
    greedy = port_sample(w["port"], w["arrs"], w["shapes"])
    beam = port_sample(w["port"], w["arrs"], w["shapes"], beam_size=1)
    np.testing.assert_array_equal(beam[0], greedy[0])
    alive = alive_mask(greedy[0])
    np.testing.assert_allclose(beam[1] * alive, greedy[1] * alive, rtol=0,
                               atol=1e-6)


def test_beam_search_matches_jax():
    """sample_beam at width 3: tokens exactly, logprobs within 1e-5."""
    w = world()
    want = jax_sample(w["model"], w["params"], w["arrs"], w["shapes"],
                      beam_size=3)
    got = port_sample(w["port"], w["arrs"], w["shapes"], beam_size=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def test_wider_beam_never_scores_worse():
    """The best beam's score (its logprobs summed up to its first EOS) at
    widths 1 < 2 < 4 never falls, up to f32 rounding."""
    w = world()
    scores = []
    for W in (1, 2, 4):
        seq, lps = port_sample(w["port"], w["arrs"], w["shapes"],
                               beam_size=W)
        scores.append((lps * alive_mask(seq)).sum(-1))
    for lo, hi in zip(scores, scores[1:]):
        assert (hi >= lo - 1e-5).all()
    assert (scores[-1] > scores[0] + 1e-3).any()


# ------------------------------------------------------------ early exit
@pytest.mark.parametrize("bias", [0.0, 3.0])
def test_early_exit_matches_jax_and_the_fixed_loop(bias):
    """The LSTM-DSA head: early exit gives the fixed loop's tokens (port and
    JAX) and JAX's while_loop logprobs (0 on the steps it does not run)
    within 2e-5; with EOS's logit raised by 3 the loop stops early. The
    stop is read every step or every third (EXIT_CHECK_EVERY's cadence
    rule): the output is the same."""
    w = world()
    port, params = w["port"], w["params"]
    head = port.caption_head[1]
    saved = {k: v.clone() for k, v in head.state_dict().items()}
    try:
        if bias:
            params = eos_biased(params, port, bias)
        fixed = port_sample(port, w["arrs"], w["shapes"])
        got = port_sample(port, w["arrs"], w["shapes"], early_exit=True)
        pcap.EXIT_CHECK_EVERY = 3
        try:
            every3 = port_sample(port, w["arrs"], w["shapes"],
                                 early_exit=True)
        finally:
            pcap.EXIT_CHECK_EVERY = 1
        want = jax_sample(w["model"], params, w["arrs"], w["shapes"],
                          early_exit=True)
    finally:
        head.load_state_dict(saved)
    np.testing.assert_array_equal(got[0], fixed[0])
    np.testing.assert_array_equal(want[0], fixed[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(every3[0], got[0])
    np.testing.assert_array_equal(every3[1], got[1])
    if bias:
        ran = int((np.abs(want[1]).sum((0, 1)) > 0).sum())
        assert 0 < ran < w["cfg"].max_caption_len
        assert (got[1][..., ran:] == 0).all()


# ------------------------------------------------ bf16 decode and rollouts
def forced_port_sample(port, arrs, shapes, tokens, bf16=True):
    """The port's decode with its draws forced to `tokens` (B, Ne, Lc), in
    the bf16 chain (or the f32 one): the chosen logprobs (B, Ne, Lc)."""
    step = [0]
    real = pcap.draw_tokens

    def forced(z, temperature, generator=None):
        t = step[0]
        step[0] += 1
        return torch.from_numpy(tokens[..., t]).long()

    q, ref, mem, mflat, vr = map(torch.from_numpy, arrs)
    if bf16:
        q, mem = to_bf16(q), to_bf16(mem)
    pcap.draw_tokens = forced
    try:
        with torch.no_grad(), port.caption_bf16() if bf16 else \
                contextlib.nullcontext():
            _, lps = port.caption_sample(1, q, ref, mem, mflat, shapes, vr,
                                         greedy=False)
    finally:
        pcap.draw_tokens = real
    return lps.numpy()


def jax_bf16_sample(w, **kw):
    """JAX's bf16 decode (evaluate.py:199-204): the caption parameters,
    query and memory cast to bf16."""
    model, shapes = w["model"], w["shapes"]
    p16 = bf16_cast_tree(w["params"])
    q, ref, mem, mflat, vr = map(jnp.asarray, w["arrs"])
    fn = jax.jit(lambda p, q, m, rng: model.apply(
        p, 1, q, ref, m, mflat, shapes, vr, method=model.caption_sample,
        rngs={"sample": rng}, **kw))
    seq, lps = fn(p16, q.astype(BF16), mem.astype(BF16),
                  jax.random.PRNGKey(7))
    assert lps.dtype == jnp.float32
    return np.asarray(seq), np.asarray(lps)


@pytest.mark.parametrize("greedy", [True, False], ids=["decode", "rollout"])
def test_bf16_chain_matches_jax_on_its_tokens(greedy):
    """eval_decode_bf16 (greedy) and the SCST sampled rollout under
    train_caption_bf16: JAX's bf16 tokens forced into the port's bf16
    chain give JAX's chosen logprobs (f32) within 0.05 on every step up to
    each caption's first EOS; the f32 chain on the same tokens differs from
    them by more (the bf16 rounding is real)."""
    w = world()
    seq, lps = jax_bf16_sample(w, greedy=greedy, deterministic=greedy)
    alive = alive_mask(seq)
    got = forced_port_sample(w["port"], w["arrs"], w["shapes"], seq)
    err = np.abs(got - lps)[alive]
    assert err.max() <= BF16_LP_ATOL, err.max()
    f32 = forced_port_sample(w["port"], w["arrs"], w["shapes"], seq,
                             bf16=False)
    assert np.abs(f32 - lps)[alive].max() > 1e-4


@functools.lru_cache(maxsize=None)
def bf16_trained():
    """One jitted JAX train step with train_caption_bf16 and one port step,
    same weights and batch: losses and named gradients."""
    w = world()
    cfg, model, params, port = w["cfg"], w["model"], w["params"], w["port"]
    batch = make_batch(cfg)
    skw = dict(statics_kw(cfg), caption_bf16=True)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **skw)
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    state, jl = jax.jit(step_fn)(state, db, jw, jax.random.PRNGKey(0))
    jg = jax_grads_to_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, adam_mu(state.opt_state)),
        GVLArch.from_config(cfg))
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **skw)
    try:
        pl = pstate.make_train_step(port, cfg, pst)(
            pstate.create_train_state(cfg, port, 100, pst), batch,
            make_weight_dict(cfg))
        pg = {n: p.grad.clone() for n, p in port.named_parameters()
              if p.grad is not None}
    finally:
        port.load_state_dict(saved)
        port.eval()
    return ({k: float(v) for k, v in jl.items()},
            {k: float(v) for k, v in pl.items()}, jg, pg)


def test_bf16_teacher_forcing_losses_match_jax():
    """train_caption_bf16: the caption losses (bf16 teacher forcing, f32
    NLL; 1e-4 apart at this world) within 1e-2 relative, the rest (f32
    trunk) 2e-4."""
    want, got = bf16_trained()[:2]
    assert set(got) == set(want)
    for k in want:
        tol = 1e-2 if k.startswith("loss_caption") or k == "total_loss" \
            else 2e-4
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-5,
                                   err_msg=k)


def test_bf16_teacher_forcing_gradients_match_jax():
    """The named gradients under train_caption_bf16, all finite. The caption
    head's pass through bf16 arithmetic: within 0.1 x their max abs (the
    widest, 0.07 at this world, are the sampling offsets', which go through
    the difference of two bf16-rounded value rows). The trunk's, where the
    caption loss's gradient meets the f32 losses', within 1e-2 x theirs."""
    want, got = bf16_trained()[2:]
    assert set(got) <= set(want)
    for name in want:
        wv = want[name].numpy()
        g = got[name].numpy() if name in got else np.zeros_like(wv)
        assert np.isfinite(g).all(), name
        tol = 0.1 if name.startswith("caption_head.") else 1e-2
        err = np.abs(g - wv).max()
        assert err <= tol * np.abs(wv).max() + 1e-6, (name, err)
    assert np.abs(got["caption_head.0.logit.weight"].numpy()).max() > 0


# ------------------------------------------------------------- full bf16
def test_prep_taps_bf16_rule_matches_jitted_jax():
    """The tap rule for bf16 loc and/or attn: the port's prep_taps against
    JAX's _prep_taps under jit (which XLA computes as eagerly: each bf16
    operation rounded), at the flagship's levels. Indices exactly, weights
    within a bf16 ulp of their size."""
    shapes = (100, 50, 25, 13)
    rs = np.random.RandomState(0)
    loc = rs.uniform(-0.05, 1.05, (2, 20, 4, 4, 4)).astype(np.float32)
    attn = rs.uniform(0, 0.2, loc.shape).astype(np.float32)
    jfn = jax.jit(lambda l, a: jmsda._prep_taps(shapes, l, a))
    for ldt, adt in ((BF16, BF16), (jnp.float32, BF16), (BF16, jnp.float32)):
        jl, ja = jnp.asarray(loc).astype(ldt), jnp.asarray(attn).astype(adt)
        want = [np.asarray(x.astype(jnp.float32)) for x in jfn(jl, ja)]
        pl = torch.from_numpy(np.asarray(jl.astype(jnp.float32)))
        pa = torch.from_numpy(np.asarray(ja.astype(jnp.float32)))
        pl = pl.bfloat16() if ldt == BF16 else pl
        pa = pa.bfloat16() if adt == BF16 else pa
        got = [x.float().numpy() for x in prep_taps(shapes, pl, pa)]
        for g, wv in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, wv)
        for g, wv in zip(got[2:], want[2:]):
            ulp = np.abs(wv) * 2.0 ** -8
            assert (np.abs(g - wv) <= ulp).all(), (ldt, adt)


def jax_taps_dtypes(model, params, inputs):
    """(loc, attn) dtypes reaching JAX's _prep_taps in its full-bf16 trunk,
    as traced under jit (evaluate.py:107-116)."""
    seen, real = [], jmsda._prep_taps

    def spy(shapes, loc, attn):
        seen.append((str(loc.dtype), str(attn.dtype)))
        return real(shapes, loc, attn)

    jmsda._prep_taps = spy
    try:
        feats, mask, dur = map(jnp.asarray, inputs)
        jax.jit(model.apply).lower(bf16_cast_tree(params), feats.astype(BF16),
                                   mask, dur)
    finally:
        jmsda._prep_taps = real
    return seen


def test_full_bf16_taps_dtypes_follow_jax():
    """Under eval_full_bf16 JAX's encoder gives the op an f32 loc and attn
    (its queries add the f32 position encodings) and its decoder an f32 loc
    (the references are scaled by the f32 valid ratios) beside a bf16 attn;
    the port's full-bf16 trunk hands its op the same dtypes, so on the card
    the decoder runs kernel 1's bf16-tap form and the encoder its f32
    form."""
    w = world()
    want = jax_taps_dtypes(w["model"], w["params"], w["inputs"])
    seen, real = [], players.ms_deform_attn_1d

    def spy(value, shapes, loc, attn):
        seen.append((str(loc.dtype).replace("torch.", ""),
                     str(attn.dtype).replace("torch.", "")))
        return real(value, shapes, loc, attn)

    players.ms_deform_attn_1d = spy
    try:
        feats, mask, dur = map(torch.from_numpy, w["inputs"])
        with torch.no_grad(), pcap_bf16(w["port"]):
            w["port"](feats.bfloat16(), mask, dur)
    finally:
        players.ms_deform_attn_1d = real
    assert seen == want
    n_enc = w["cfg"].enc_layers
    assert set(want[:n_enc]) == {("float32", "float32")}
    assert set(want[n_enc:]) == {("float32", "bfloat16")}


def pcap_bf16(port):
    from gvl_tpu_torch.utils.amp import bf16_parameters
    return bf16_parameters(port, promote=True)


@functools.lru_cache(maxsize=None)
def full_bf16_runs(tmp):
    """Both EvalRunners under eval_full_bf16 over a synthetic dataset of 8
    videos (2 batches), same weights: their DVC JSONs."""
    anno, feats, vocab, vsize = make_synthetic_dataset(tmp, num_videos=8,
                                                       feat_dim=32)
    cfg = Config()
    cfg.update(dict(world()["cfg"].to_dict()))
    cfg.update(dict(
        train_caption_file=anno, val_caption_file=anno,
        visual_feature_folder=feats, visual_feature_type="npy",
        dict_file=vocab, vocab_size=vsize, batch_size=4, eval_batch_size=4,
        eval_full_bf16=True, eval_disable_plot_hook=True))
    ds = DenseVideoDataset(anno, feats, vocab, False, cfg)
    batcher = Batcher(ds, cfg, 4, shuffle=False)
    model = jax_build_model(cfg, text_hidden_dim=48)
    b0 = next(iter(batcher))
    tree = jax.eval_shape(
        functools.partial(model.init, method=model.init_all),
        jax.random.PRNGKey(0), b0["video_feats"], b0["video_mask"],
        b0["duration"], captions=jnp.asarray(b0["captions"]))
    params = draw_params(tree, seed=5)
    jr = JaxEvalRunner(cfg, model, None, ds.translator)
    jr.set_params(params, None)
    _, want, *_ = jr.run(batcher, tmp + "/jax.json")
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg)), strict=True)
    _, got, *_ = EvalRunner(cfg, port, ds.translator).run(
        batcher, tmp + "/port.json")
    return want, got


def test_full_bf16_eval_matches_jax(tmp_path_factory):
    """EvalRunner.run under eval_full_bf16 against the JAX EvalRunner: every
    video present, every number finite; of the predictions both keep (by
    query), >= 80% of each video's; their proposal scores within 0.02 and
    boxes within 2% of the video's duration (the bf16 trunk: a bf16 ulp is
    2^-8 relative), their event counts equal."""
    want, got = full_bf16_runs(str(tmp_path_factory.mktemp("full_bf16")))
    assert got["results"].keys() == want["results"].keys()
    for vid, wv in want["results"].items():
        g = {p["query_id"]: p for p in got["results"][vid]}
        wq = {p["query_id"]: p for p in wv}
        common = set(g) & set(wq)
        assert len(common) >= 0.8 * len(wq), vid
        for q in common:
            a, b = g[q], wq[q]
            assert np.isfinite([a["proposal_score"], a["sentence_score"]]
                               + a["timestamp"]).all()
            assert abs(a["proposal_score"] - b["proposal_score"]) <= 0.02
            dur = b["vid_duration"]
            assert np.abs(np.subtract(a["timestamp"], b["timestamp"])).max() \
                <= 0.02 * dur
            assert a["pred_event_count"] == b["pred_event_count"]
