"""The port's EvalRunner with the contrastive side on against the JAX
EvalRunner, on the synthetic dataset: the flagship's text side at tiny
widths, a frozen offline RoBERTa (hidden 32, 1 layer), grounding eval on.
Five videos at eval batch 2, so the last batch is partial and padded; G = 4
sentence slots, and videos with more sentences than G, so their sentences
past G are grounded in chunks. Same noisy weights (sigma 0.02) on both
sides.

The DVC JSON, the reranked JSON and both grounding JSONs must be equal:
keys, sentences, query ids, labels and counts exact, floats to rtol 1e-4 /
atol 1e-4. The eval losses, which both runners round to 3 places, to 1e-3.
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvl_tpu.config import Config
from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.data.synthetic import make_synthetic_dataset
from gvl_tpu.eval.evaluate import EvalRunner as JaxEvalRunner
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models.text_encoder import load_text_encoder as jax_text_encoder
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.models.text_encoder import load_text_encoder
from tests.test_torch_eval import assert_same_json
from tests.test_torch_model import add_noise
from tests.test_torch_text import FLAGSHIP_TEXT
from tests.test_torch_train_loop import once_per_test_run

N_VIDEOS, EVAL_BS, G = 5, 2, 4


def grounding_cfg(tmp, **kw):
    anno, feats, vocab, vsize = make_synthetic_dataset(
        str(tmp), num_videos=N_VIDEOS, feat_dim=16, min_events=2,
        max_events=10, seed=3)
    cfg = Config()
    cfg.update(dict(FLAGSHIP_TEXT, **dict(
        train_caption_file=anno, val_caption_file=anno,
        visual_feature_folder=feats, visual_feature_type="npy",
        dict_file=vocab, vocab_size=vsize, feature_dim=16,
        frame_embedding_num=24, hidden_dim=64, nheads=4, enc_layers=1,
        dec_layers=2, transformer_ff_dim=64, num_feature_levels=3,
        num_queries=8, gt_proposal_sample_num=G, max_caption_len=8,
        input_encoding_size=32, rnn_size=32, att_hid_size=32, cap_nheads=1,
        cap_num_feature_levels=3, with_box_refine=1,
        caption_decoder_type="standard", caption_loss_coef=1.0,
        count_loss_coef=0.5, set_cost_cl=2.0, set_cost_class=2.0,
        set_cost_bbox=0.0, set_cost_giou=4.0, max_eseq_length=6,
        eval_batch_size=EVAL_BS, msda_impl="ref", max_text_input_len=12,
        eval_enable_grounding=True, eval_set_cost_cl=1.0,
        eval_set_cost_class=0.0, eval_disable_plot_hook=True,
        load_pretrained_language_model_from_config="offline",
        offline_text_encoder_hidden=32, offline_text_encoder_layers=1)))
    cfg.update(kw)
    return cfg, anno


def once_pickled(tmp_path_factory, name, fn):
    """fn(root)'s result, computed once per test run (once_per_test_run)
    and handed to each worker through a pickle in `root`."""
    def compute(root):
        with open(root / "result.pkl", "wb") as f:
            pickle.dump(fn(root), f)

    def load(root):
        with open(root / "result.pkl", "rb") as f:
            return pickle.load(f)

    return once_per_test_run(tmp_path_factory, name, compute, load)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Computed once per test run."""
    return once_pickled(tmp_path_factory, "torch_grounding_runs", run_both)


@pytest.fixture(scope="module")
def match_runs(tmp_path_factory):
    """Matching scores on, weighed 1.0 in the reranking, and the text pass
    over bf16-rounded weights (eval_use_amp). Computed once per test run."""
    return once_pickled(tmp_path_factory, "torch_grounding_match_runs",
                        functools.partial(
                            run_both, eval_enable_matching_score=True,
                            eval_matching_score_weight=1.0,
                            eval_use_amp=True))


def noisy_world(tmp, **cfg_kw):
    """The world and its JAX weights: (cfg, the annotation file, the
    dataset, its eval batcher, the JAX text bundle, the JAX model, its
    noisy parameters)."""
    cfg, anno = grounding_cfg(tmp, **cfg_kw)
    ds = DenseVideoDataset(anno, cfg.visual_feature_folder, cfg.dict_file,
                           False, cfg)
    batcher = Batcher(ds, cfg, cfg.eval_batch_size, shuffle=False)
    bundle = jax_text_encoder(cfg)
    Dt = bundle.hidden_size
    model = jax_build_model(cfg, text_hidden_dim=Dt)
    batch = next(iter(batcher))
    ids, tmask = bundle.tokenize(batch["captions_raw"], G,
                                 cfg.max_text_input_len)
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), jnp.asarray(batch["video_feats"]),
        jnp.asarray(batch["video_mask"]), jnp.asarray(batch["duration"]),
        word_embed=jnp.zeros((EVAL_BS, G, cfg.max_text_input_len, Dt)),
        token_mask=jnp.asarray(tmask) > 0,
        gt_mask=jnp.asarray(batch["gt_mask"]),
        captions=jnp.asarray(batch["captions"])))
    return cfg, anno, ds, batcher, bundle, model, params


def run_both(tmp, **cfg_kw):
    """Both EvalRunners over the same batches from the same weights:
    (cfg, the GT annotations, the JAX run's result, the port's)."""
    cfg, anno, ds, batcher, bundle, model, params = noisy_world(tmp, **cfg_kw)
    Dt = bundle.hidden_size
    jr = JaxEvalRunner(cfg, model, bundle, ds.translator)
    jr.set_params(params, bundle.params)
    want = jr.run(batcher, str(tmp / "jax.json"))

    port = build_model(cfg, text_hidden_dim=Dt, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, Dt)), strict=True)
    text = load_text_encoder(cfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)
    got = EvalRunner(cfg, port, ds.translator, text).run(
        batcher, str(tmp / "port.json"))
    gt = json.load(open(anno))
    return cfg, gt, want, got


def test_the_world_has_a_partial_batch_and_sentences_past_g(runs):
    cfg, gt, *_ = runs
    assert N_VIDEOS % EVAL_BS and cfg.effective_max_gt_events == G
    counts = [len(v["sentences"]) for v in gt.values()]
    assert max(counts) > 2 * G and min(counts) <= G


def test_dvc_json_matches_jax(runs):
    _, gt, (_, want, *_), (_, got, *_) = runs
    assert len(got["results"]) == N_VIDEOS
    assert any(p["sentence"] for v in got["results"].values() for p in v)
    assert_same_json(got, want)


def test_reranked_json_matches_jax(runs):
    _, _, (want_path, *_), (got_path, *_) = runs
    assert got_path.endswith("_rerank_alpha0.3_temp2.0.json")
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    assert_same_json(got, want)


@pytest.mark.parametrize("which", [2, 3])
def test_grounding_json_matches_jax_with_a_key_per_sentence(runs, which):
    """which 2: the last decoder layer's grounding, 3: the aux one; the
    files beside the final DVC JSON hold the same."""
    _, gt, want, got = runs
    n_sent = sum(len(v["sentences"]) for v in gt.values())
    assert len(got[which]["results"]) == n_sent
    for vid, info in gt.items():
        for i, sent in enumerate(info["sentences"]):
            assert got[which]["results"][f"{vid[2:]}-{i}"][0]["sentence"] \
                == sent
    assert_same_json(got[which], want[which])
    suffix = ".grounding.json" if which == 2 else "_aux.grounding.json"
    with open(got[0] + suffix) as f:
        assert_same_json(json.load(f), want[which])


def test_eval_losses_match_jax(runs):
    """Averaged over the real videos (the padded row of the last batch left
    out by row_valid), contrastive_loss and contrastive_loss_0 included."""
    *_, want, got = runs
    want_l, got_l = want[4], got[4]
    assert set(got_l) == set(want_l)
    assert {"contrastive_loss", "contrastive_loss_0", "loss_ce",
            "loss_giou_0"} <= set(got_l)
    for k in want_l:
        np.testing.assert_allclose(got_l[k], want_l[k], atol=1e-3 + 1e-6,
                                   rtol=0, err_msg=k)


def test_text_side_eval_options_not_ported_raise_by_name(runs, tmp_path):
    """The contrastive side without its text encoder is refused by name;
    matching scores, eval_use_amp and zero-shot TAL, once refused, run
    (zero-shot TAL embeds the class names; its parity with JAX:
    tests/test_torch_tal.py)."""
    cfg, *_ = runs
    port = build_model(cfg, text_hidden_dim=32, device="cpu")
    text = load_text_encoder(cfg, device="cpu")
    for name in ("eval_enable_matching_score", "eval_use_amp"):
        setattr(cfg, name, True)
        try:
            runner = EvalRunner(cfg, port, None, text)
            assert runner.matching == (name == "eval_enable_matching_score")
            assert runner.text_bf16 == (name == "eval_use_amp")
        finally:
            setattr(cfg, name, False)
    runner = EvalRunner(cfg, port, None, text)
    runner.enable_zeroshot_tal(["a", "b c"])
    assert runner.class_embeds.shape == (2, cfg.contrastive_hidden_size)
    with pytest.raises(ValueError, match="text encoder"):
        EvalRunner(cfg, port, None)


def test_matching_score_dvc_json_matches_jax(match_runs):
    """With eval_enable_matching_score every prediction's cl_score is the
    cosine of its generated caption, encoded again, with its query's event
    embedding: the DVC JSON, cl_score included, equals the JAX runner's,
    and the scores are real cosines (non-zero, in [-1, 1])."""
    _, _, (_, want, *_), (_, got, *_) = match_runs
    assert_same_json(got, want)
    scores = [p["cl_score"] for v in got["results"].values() for p in v]
    assert len(scores) > 10
    assert all(-1.0 <= x <= 1.0 for x in scores)
    assert sum(x != 0.0 for x in scores) >= 0.9 * len(scores)


def test_matching_score_reranked_json_matches_jax(match_runs, runs):
    """The reranking weighs the cl_scores by eval_matching_score_weight
    1.0: the reranked JSON equals the JAX runner's, and its order differs
    from the run without matching scores for some video."""
    _, _, (want_path, *_), (got_path, *_) = match_runs
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    assert_same_json(got, want)
    with open(runs[3][0]) as f:
        plain = json.load(f)
    assert any([p["query_id"] for p in got["results"][v]]
               != [p["query_id"] for p in plain["results"][v]]
               for v in got["results"])


@pytest.mark.parametrize("which", [2, 3])
def test_eval_use_amp_grounding_jsons_match_jax(match_runs, runs, which):
    """eval_use_amp: the batch's text pass over bf16-rounded weights (the
    chunks past G over the f32 ones, as in the JAX package). Both grounding
    JSONs equal the JAX runner's; their cl_scores differ from the f32
    run's."""
    _, _, want, got = match_runs
    assert_same_json(got[which], want[which])
    plain = runs[3][which]["results"]
    diff = max(abs(got[which]["results"][k][0]["cl_score"]
                   - plain[k][0]["cl_score"]) for k in plain)
    assert diff > 1e-5
