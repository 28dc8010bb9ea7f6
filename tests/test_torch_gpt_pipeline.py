"""The gpt2 (ClipCap) caption head through the port's train step and
EvalRunner, against the JAX package's, at tiny trunk widths with the
offline GPT-2 spec (vocab 1000, 128 wide, 2 layers of 4 heads), prefix
length 4 and prefix_size = hidden 64.

One world: eight synthetic videos (two eval batches of 4), dropout 0, the
JAX init with seeded noise (sigma 0.02) loaded into the port through
gvl_tpu_torch.convert. Its stop token is the token the random head emits
most often after the first step, so that captions end at different steps.
- `make_gpt_tokenize`: the same spec, gpt_tokens / gpt_mask and decoder as
  the JAX loop's.
- One train step (both caption layers) against the jitted JAX step: every
  loss rtol 2e-4 / atol 2e-5, every named gradient to 1e-3 of its max abs
  (the JAX gradients read from Adam's first moment, as
  tests/test_torch_train_step.py does).
- EvalRunner.run's DVC JSON against the JAX EvalRunner's, with early exit
  off and no decoder (eval.py's rule) and with early exit on and the train
  loop's decoder (validation's rule): structure exact, floats to 1e-4; the
  port's early exit gives the fixed loop's captions and scores.
- Both decode rules on ids that include the special ids 0-2: `_assemble`
  against the JAX runner's.
- bf16 (eval_use_amp / eval_decode_bf16 / eval_full_bf16 cast every
  parameter and the query features): JAX's bf16 tokens forced into the
  port's bf16 chain. In the jitted JAX branch the products run in bf16
  (f32 accumulation), LayerNorm statistics and normalisation in f32, the
  softmax's exp in bf16 and its sum in f32, GELU's tanh in bf16; torch
  rounds its bf16 elementwise ops once per op, not per step, so the chosen
  tokens' probabilities agree to BF16_PROB_ATOL and the port's own argmax
  picks JAX's token at >= 90% of the steps. Random weights put argmaxes
  within a bf16 rounding of each other, so free-running bf16 tokens are not
  compared.
Every JAX call is jitted; the JAX init and the train steps are computed
once per test run (once_per_test_run). Cost: ~45 s in one process.
"""

import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.config import Config
from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.data.synthetic import make_synthetic_dataset
from gvl_tpu.eval.evaluate import EvalRunner as JaxEvalRunner
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models.gpt_captioner import load_gpt2_spec as jax_gpt2_spec
from gvl_tpu.train import loop as jloop
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu.utils.amp import bf16_cast_tree
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.models.gpt_captioner import GPT2Spec
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.train import loop as ploop
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from gvl_tpu_torch.utils.amp import bf16_parameters, to_bf16
from tests.test_torch_eval import assert_same_json
from tests.test_torch_model import add_noise
from tests.test_torch_train_loop import once_per_test_run
from tests.test_torch_train_step import adam_mu

EVAL_BS, PFX_LEN = 4, 4
BF16_PROB_ATOL = 0.02


def gpt_cfg(tmp):
    anno, feats, vocab, vsize = make_synthetic_dataset(
        str(tmp), num_videos=2 * EVAL_BS, feat_dim=16, min_events=1,
        max_events=4, seed=2)
    cfg = Config()
    cfg.update(dict(
        train_caption_file=anno, val_caption_file=anno,
        visual_feature_folder=feats, visual_feature_type="npy",
        dict_file=vocab, vocab_size=vsize, feature_dim=16,
        frame_embedding_num=24, hidden_dim=64, nheads=4, enc_layers=1,
        dec_layers=2, transformer_ff_dim=64, num_feature_levels=3,
        num_queries=8, gt_proposal_sample_num=3, max_caption_len=8,
        cap_num_feature_levels=3, with_box_refine=1, max_eseq_length=4,
        caption_decoder_type="gpt2", prefix_length=PFX_LEN, prefix_size=64,
        caption_loss_coef=1.0, count_loss_coef=0.5, set_cost_class=2.0,
        set_cost_bbox=0.0, set_cost_giou=4.0, enable_contrastive=False,
        transformer_dropout_prob=0.0, drop_prob=0.0, batch_size=EVAL_BS,
        eval_batch_size=EVAL_BS, msda_impl="ref",
        eval_disable_plot_hook=True,
        load_pretrained_language_model_from_config="offline"))
    return cfg


def jax_model(cfg, stop):
    spec, _ = jax_gpt2_spec(cfg)
    spec = dataclasses.replace(spec, stop_token_id=stop)
    return jax_build_model(cfg, gpt_spec=spec), spec


def port_model(cfg, params, stop):
    spec = dataclasses.replace(ploop.make_gpt_tokenize(cfg)[0],
                               stop_token_id=stop)
    port = build_model(cfg, device="cpu", gpt_spec=spec)
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, gpt_spec=spec)), strict=True)
    return port


def compute_world(tmp):
    """The JAX init with noise and the stop token, in `tmp` (world.pkl)
    beside the synthetic data."""
    cfg = gpt_cfg(tmp)
    ds = DenseVideoDataset(cfg.val_caption_file, cfg.visual_feature_folder,
                           cfg.dict_file, False, cfg)
    batcher = Batcher(ds, cfg, EVAL_BS, shuffle=False)
    _, add_gpt, _ = jloop.make_gpt_tokenize(cfg)
    batch = add_gpt(next(iter(batcher)))
    model, _ = jax_model(cfg, 13)
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), jnp.asarray(batch["video_feats"]),
        jnp.asarray(batch["video_mask"]), jnp.asarray(batch["duration"]),
        captions=jnp.asarray(batch["gpt_tokens"])))
    # the stop token: the head's most frequent token after the first step
    probe = port_model(cfg, params, -1)
    with torch.no_grad():
        out = probe(*(torch.from_numpy(batch[k]) for k in
                      ("video_feats", "video_mask", "duration")))
        toks = probe.caption_sample_gpt(1, out["hs"][-1], 8)[0]
    stop = int(np.bincount(toks[..., 1:].numpy().ravel()).argmax())
    with open(tmp / "world.pkl", "wb") as f:
        pickle.dump(dict(cfg=cfg.to_dict(), params=params, stop=stop), f)


def load_world(tmp):
    """compute_world's init and stop token, with the dataset, the first
    batch and both models rebuilt around them."""
    with open(tmp / "world.pkl", "rb") as f:
        w = pickle.load(f)
    cfg = Config()
    cfg.update(w["cfg"])
    ds = DenseVideoDataset(cfg.val_caption_file, cfg.visual_feature_folder,
                           cfg.dict_file, False, cfg)
    batcher = Batcher(ds, cfg, EVAL_BS, shuffle=False)
    batch = jloop.make_gpt_tokenize(cfg)[1](next(iter(batcher)))
    params, stop = w["params"], w["stop"]
    model, _ = jax_model(cfg, stop)
    return dict(cfg=cfg, ds=ds, batcher=batcher, batch=batch, params=params,
                stop=stop, model=model, port=port_model(cfg, params, stop),
                tmp=tmp)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Its init computed once per test run (once_per_test_run)."""
    return once_per_test_run(tmp_path_factory, "torch_gpt_world",
                             compute_world, load_world)


def test_gpt_tokenize_matches_jax(world):
    """The offline spec, the hashed gpt_tokens / gpt_mask of a batch's raw
    captions and the validation decoder (which drops ids 0-2)."""
    cfg = world["cfg"]
    jspec, jadd, jdec = jloop.make_gpt_tokenize(cfg)
    pspec, padd, pdec = ploop.make_gpt_tokenize(cfg)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    assert pspec == GPT2Spec(vocab_size=1000, n_embd=128, n_layer=2, n_head=4,
                             prefix_length=PFX_LEN, prefix_size=64,
                             prefix_num_mapping_layer=2, stop_token_id=13)
    raw = next(iter(world["batcher"]))
    got, want = padd(dict(raw)), jadd(dict(raw))
    for k in ("gpt_tokens", "gpt_mask"):
        assert got[k].shape == (EVAL_BS, cfg.effective_max_gt_events,
                                cfg.max_caption_len)
        np.testing.assert_array_equal(got[k], want[k])
    ids = [0, 5, 1, 2, 3, 999]
    assert pdec(ids) == jdec(ids) == "w5 w3 w999"
    assert ploop.make_gpt_tokenize(Config()) == (None, None, None)


def compute_trained(world):
    """One jitted JAX train step and one port step on the same batch:
    losses and named gradients."""
    cfg, model, params, port, batch = (world[k] for k in (
        "cfg", "model", "params", "port", "batch"))
    arrs = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    skw = dict(enable_contrastive=False, caption_loss=True, two_stage=False,
               train_text_encoder=False, disable_mid_caption_heads=False,
               enable_pos_emb_for_captioner=False,
               temporal_shapes=tuple(cfg.temporal_shapes()), caption_gpt=True)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **skw)
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    state, jl = jax.jit(step_fn)(state, {k: jnp.asarray(v) for k, v in
                                         arrs.items()}, jw,
                                 jax.random.PRNGKey(0))
    arch = GVLArch.from_config(cfg, gpt_spec=port.caption_head[0].spec)
    jg = jax_grads_to_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, adam_mu(state.opt_state)), arch)

    saved = {k: v.clone() for k, v in port.state_dict().items()}
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **skw)
    step = pstate.make_train_step(port, cfg, pst)
    try:
        pl = step(pstate.create_train_state(cfg, port, 100, pst), arrs,
                  make_weight_dict(cfg))
        pg = {n: p.grad.clone() for n, p in port.named_parameters()
              if p.grad is not None}
    finally:
        port.load_state_dict(saved)
        port.eval()
    return ({k: float(v) for k, v in jl.items()},
            {k: float(v) for k, v in pl.items()}, jg, pg)


@pytest.fixture(scope="module")
def trained(world, tmp_path_factory):
    """compute_trained's result, computed once per test run."""
    def compute(root):
        torch.save(compute_trained(world), root / "trained.pt")

    return once_per_test_run(
        tmp_path_factory, "torch_gpt_trained", compute,
        lambda root: torch.load(root / "trained.pt", weights_only=False))


def test_train_step_losses_match_jax(trained):
    want, got = trained[:2]
    assert set(got) == set(want) and {"loss_caption", "loss_caption_0"} <= \
        set(got)
    assert got["loss_caption"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_train_step_named_gradients_match_jax(trained):
    """Every named gradient within 1e-3 x its max abs + 1e-7; the gpt2
    head's (one module shared by the layers) among them, non-zero."""
    want, got = trained[2:]
    assert set(got) <= set(want)
    head = [k for k in want if k.startswith("caption_head.0.gpt.")]
    assert len(head) == 2 + 12 * 2 + 2
    for name in want:
        w = want[name].numpy()
        g = got[name].numpy() if name in got else np.zeros_like(w)
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-7, (name, err)
    assert np.abs(got["caption_head.0.gpt.transformer.wte.weight"]
                  .numpy()).max() > 0


def eval_runs(world, early_exit, decoded):
    """Both EvalRunners over the world's two batches: their DVC JSONs (run
    once per world and options)."""
    key = ("eval", early_exit, decoded)
    if key in world:
        return world[key]
    cfg = Config()
    cfg.update(world["cfg"].to_dict())
    cfg.set("eval_decode_early_exit", early_exit)
    jdec = jloop.make_gpt_tokenize(cfg)[2] if decoded else None
    pdec = ploop.make_gpt_tokenize(cfg)[2] if decoded else None
    tmp = world["tmp"]
    jr = JaxEvalRunner(cfg, world["model"], None, world["ds"].translator,
                       gpt_decode=jdec)
    jr.set_params(world["params"], None)
    _, want, *_ = jr.run(world["batcher"],
                         str(tmp / f"jax_{early_exit}_{decoded}.json"))
    _, got, *_ = EvalRunner(cfg, world["port"], world["ds"].translator,
                            gpt_decode=pdec).run(
        world["batcher"], str(tmp / f"port_{early_exit}_{decoded}.json"))
    world[key] = want, got
    return want, got


@pytest.mark.parametrize("early_exit,decoded", [(False, False), (True, True)])
def test_eval_dvc_json_matches_jax(world, early_exit, decoded):
    want, got = eval_runs(world, early_exit, decoded)
    assert len(got["results"]) == 2 * EVAL_BS
    assert_same_json(got, want)
    sents = [p["sentence"] for v in got["results"].values() for p in v]
    lengths = {len(s.split()) for s in sents}
    assert len(lengths) > 1 and max(lengths) <= world["cfg"].max_caption_len
    assert all(f"w{world['stop']}" not in s.split() for s in sents)


def test_early_exit_gives_the_fixed_loops_captions(world):
    """The port's early exit, without a decoder, writes the fixed loop's
    captions and scores."""
    fixed = eval_runs(world, False, False)[1]
    tmp = world["tmp"]
    cfg = Config()
    cfg.update(world["cfg"].to_dict())
    cfg.set("eval_decode_early_exit", True)
    _, early, *_ = EvalRunner(cfg, world["port"], world["ds"].translator).run(
        world["batcher"], str(tmp / "port_early_plain.json"))
    assert_same_json(early, fixed)


def test_both_decode_rules_match_jax(world):
    """`_assemble` on ids with the special ids 0-2 before the stop: the
    validation decoder drops them, eval.py's rule writes every id up to the
    mask's length, w0 included; both as the JAX runner writes them."""
    cfg = world["cfg"]
    B, Nq, L = 2, 3, 5
    rs = np.random.RandomState(0)
    res = {"det": {
        "scores": np.array([[0.9, 0.5, 0.1], [0.8, 0.3, 0.0]], np.float32),
        "raw_boxes": rs.uniform(0.1, 0.9, (B, Nq, 2)).astype(np.float32),
        "boxes": rs.uniform(0, 30, (B, Nq, 2)).astype(np.float32),
        "labels": np.zeros((B, Nq), np.int64),
        "query_idx": np.array([[2, 0, 1], [1, 2, 0]]),
        "pred_count": np.array([2, 1])},
        "gpt_tokens": np.array([[[0, 1, 7, 2, 9]] * Nq] * B),
        "gpt_genmask": np.arange(L)[None, None] < np.array(
            [[5, 3, 0], [4, 1, 2]])[..., None],
        "cap_scores": rs.rand(B, Nq).astype(np.float32)}
    batch = {"keys": ["v_a", "v_b"], "duration": np.array([30.0, 40.0])}
    for rule in (None, ploop.make_gpt_tokenize(cfg)[2]):
        jdec = None if rule is None else jloop.make_gpt_tokenize(cfg)[2]
        jr = JaxEvalRunner(cfg, world["model"], None, None, gpt_decode=jdec)
        want = {"results": {}}
        jr._assemble(batch, res, want, {}, {}, 0.0)
        got = {"results": {}}
        EvalRunner(cfg, world["port"], None, gpt_decode=rule)._assemble(
            batch, res, got)
        assert_same_json(got, want)
        first = got["results"]["v_a"][0]["sentence"]       # query 2: 0 ids
        assert first == ""
        second = got["results"]["v_a"][1]["sentence"]      # query 0: 5 ids
        assert second == ("w7 w9" if rule else "w0 w1 w7 w2 w9")


def test_bf16_chain_matches_jax_on_its_tokens(world):
    """The bf16 decode: JAX's caption_sample_gpt over bf16_cast_tree(params)
    and bf16 query features, and the port's bf16 chain (every parameter
    read as bf16, the query features cast) fed JAX's tokens: each step's
    chosen-token probability within BF16_PROB_ATOL, the port's argmax JAX's
    token at >= 90% of the steps, and the eval runner's gpt2 branch reading
    bf16 parameters and features under eval_use_amp."""
    cfg, model, params, port, batch = (world[k] for k in (
        "cfg", "model", "params", "port", "batch"))
    feats = [batch[k] for k in ("video_feats", "video_mask", "duration")]
    with torch.no_grad():
        hs = port(*map(torch.from_numpy, feats))["hs"][-1]
    L = cfg.max_caption_len
    toks, probs, _ = jax.device_get(jax.jit(lambda p, h: model.apply(
        bf16_cast_tree(p), 1, h.astype(jnp.bfloat16), entry_length=L,
        method=model.caption_sample_gpt))(params, hs.numpy()))
    head = port.caption_head[1]
    B, Ne, _ = hs.shape
    forced = torch.from_numpy(np.array(toks)).reshape(B * Ne, L)
    got_p, agree = [], []
    with torch.no_grad(), bf16_parameters(port):
        logits, caches = head.gpt.prime(head.clip_project(
            to_bf16(hs).reshape(B * Ne, -1)))
        for t in range(L):
            got_p.append(torch.softmax(logits, -1).amax(-1).float())
            agree.append(logits.argmax(-1) == forced[:, t])
            logits = head.gpt.step(head.gpt.embed(forced[:, t, None]),
                                   PFX_LEN + t, caches)
            assert logits.dtype == torch.bfloat16
    got_p = torch.stack(got_p, 1).reshape(B, Ne, L).numpy()
    np.testing.assert_allclose(got_p, np.asarray(probs), rtol=0,
                               atol=BF16_PROB_ATOL)
    assert torch.stack(agree).float().mean() >= 0.9

    seen = []
    real = port.caption_sample_gpt

    def spy(layer, query, **kw):
        seen.append((query.dtype, head.gpt.transformer.wte.weight.dtype,
                     port.query_embed.weight.dtype))
        return real(layer, query, **kw)

    amp = Config()
    amp.update(dict(cfg.to_dict(), eval_use_amp=True))
    port.caption_sample_gpt = spy
    try:
        _, out, *_ = EvalRunner(amp, port, world["ds"].translator).run(
            [batch], str(world["tmp"] / "port_amp.json"))
    finally:
        del port.caption_sample_gpt
    assert seen == [(torch.bfloat16,) * 3]
    scores = [p["sentence_score"] for v in out["results"].values() for p in v]
    assert scores and np.isfinite(scores).all()
