"""The single-sentence grounding (SSVG), paragraph-captioning (PC) and
YouCook2 configs run by the port against the JAX package, on the CPU.

Each world is its yml as both packages load it, with the widths cut
(hidden 32, FFN 64, caption LSTM 32, contrastive 16, 24 frames, an
offline RoBERTa of 32 x 1 whose weights the port takes from the JAX
bundle) and everything else as published: the text-side switches, the
query count (30, 50 for PC, 100 for YouCook2), G, the losses and costs,
the feature types and their widths (tsp 512; c3d 500 from a folder given
as a string; YouCook2's resnet 2048 and bn 1024 read from the two folders
of the yml and concatenated to 3072). Data: the synthetic world written in
each type's file layout; parameters drawn by shape (jax.eval_shape of the
init, nothing compiled). Dropout is 0 on both sides, the sentence block's
attention dropout too.

Held: EvalRunner.run of both packages over the same batches (a partial
last batch): the DVC, reranked and both grounding JSONs at
test_torch_eval.py's tolerances; and one train step on the first train
batch, the JAX step jitted once: every loss rtol 2e-4 / atol 2e-5 and
every named gradient within 1e-3 x its max abs + 1e-7 (the JAX one read
from Adam's first moment less the L2 term; the contrastive
weight at its epoch-2 value, 0.1, so the loss and the matcher's cost are
live). anet_c3d_ssvg differs from anet_tsp_ssvg only in its features, so it
is held in eval only. Cost: ~150 s in one process.
"""

import functools
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvl_tpu.config import Config as JConfig
from gvl_tpu.config import load_config as j_load_config
from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.eval.evaluate import EvalRunner as JEvalRunner
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models import gvl as jgvl
from gvl_tpu.models import text as jtext
from gvl_tpu.models import text_encoder as jte
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_grads_to_named,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.models import text_encoder as pte
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.models.text import BertSelfAttention
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import (LossSpec, cl_weight_at_epoch,
                                           make_weight_dict)
from tests.test_torch_eval import assert_same_json
from tests.test_torch_train_step import adam_mu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 32
CUT = dict(hidden_dim=32, transformer_ff_dim=64, input_encoding_size=32,
           rnn_size=32, att_hid_size=32, contrastive_hidden_size=16,
           frame_embedding_num=24, max_text_input_len=12,
           load_pretrained_language_model_from_config="offline",
           offline_text_encoder_hidden=DT, offline_text_encoder_layers=1,
           drop_prob=0.0, transformer_dropout_prob=0.0, msda_impl="ref",
           batch_size=2, eval_batch_size=2, num_workers=1,
           eval_disable_plot_hook=True)
WORLDS = {"anet_tsp_ssvg": True, "anet_tsp_pc": True, "yc2_tsn_dvc": True,
          "anet_c3d_ssvg": False}        # name -> held in a train step too


def write_world(root, cfg):
    """The synthetic world (5 videos) in the layout of cfg's feature types;
    returns the config keys that point at it."""
    types = cfg.visual_feature_type
    types = types if isinstance(types, list) else [types]
    dims = {"tsp": 512, "c3d": 500, "resnet": 2048, "bn": 1024}
    anno, feats, vocab, vsize = make_synthetic_dataset(
        str(root), num_videos=5, feat_dim=sum(dims[t] for t in types),
        min_events=2, max_events=6, seed=3)
    if types == ["resnet", "bn"]:
        # YouCook2: <id>_resnet.npy and <id>_bn.npy in the folder the yml
        # names twice
        for name in os.listdir(feats):
            x = np.load(os.path.join(feats, name))
            key = name[:-4]
            np.save(os.path.join(feats, key[2:13] + "_resnet.npy"),
                    x[:, :2048])
            np.save(os.path.join(feats, key[2:13] + "_bn.npy"), x[:, 2048:])
            os.remove(os.path.join(feats, name))
    folder = cfg.visual_feature_folder
    folders = [feats] * len(folder) if isinstance(folder, list) else feats
    return dict(train_caption_file=anno, val_caption_file=anno,
                gt_file_for_eval=[anno], gt_file_for_para_eval=[],
                visual_feature_folder=folders, dict_file=vocab,
                vocab_size=vsize, eval_gt_file_for_grounding=os.path.join(
                    str(root), "grounding.json"))


def jax_params(model, cfg, seed=0):
    """The JAX model's parameters drawn by shape: normal(0, 0.05),
    LayerNorm scales around 1."""
    B, G, L = 2, cfg.effective_max_gt_events, cfg.max_text_input_len
    shapes = jax.eval_shape(
        functools.partial(model.init, method=model.init_all),
        jax.random.PRNGKey(0),
        jnp.zeros((B, cfg.frame_embedding_num, cfg.feature_dim)),
        jnp.ones((B, cfg.frame_embedding_num), bool), jnp.ones((B,)),
        captions=jnp.zeros((B, G, cfg.max_caption_len), jnp.int32),
        word_embed=jnp.zeros((B, G, L, DT)),
        token_mask=jnp.ones((B, G, L), bool), gt_mask=jnp.ones((B, G), bool))
    rs = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(shapes["params"], sep="/")
    return {"params": flax.traverse_util.unflatten_dict({
        k: (float(k.endswith("/scale"))
            + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        for k, s in flat.items()}, sep="/")}


def statics(pkg, cfg):
    return pkg.StepStatics(
        spec=(JLossSpec if pkg is jstate else LossSpec).from_config(cfg),
        enable_contrastive=cfg.enable_contrastive, caption_loss=True,
        two_stage=False, train_text_encoder=False,
        disable_mid_caption_heads=cfg.disable_mid_caption_heads,
        enable_pos_emb_for_captioner=False,
        temporal_shapes=tuple(cfg.temporal_shapes()))


def step_weights(cfg, wd):
    return {k: (cl_weight_at_epoch(cfg, 2) if k.startswith(
        "contrastive_loss") else v) for k, v in wd.items()}


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_published_yml_matches_jax(tmp_path, monkeypatch, name):
    yml = os.path.join(ROOT, "cfgs", name + ".yml")
    published = j_load_config(yml)
    d = {k: v for k, v in published.to_dict().items() if k != "device"}
    d.update(CUT)
    d.update(write_world(tmp_path, published))
    jcfg, pcfg = JConfig().update(d), PConfig().update(d)
    assert pcfg.to_dict() == dict(jcfg.to_dict(), device="cuda")
    if name == "anet_c3d_ssvg":
        assert isinstance(jcfg.visual_feature_folder, str)
    monkeypatch.setattr(jgvl, "SentenceContextBlock", functools.partial(
        jtext.SentenceContextBlock, dropout=0.0))

    bundle = jte.load_text_encoder(jcfg)
    model = jax_build_model(jcfg, text_hidden_dim=DT)
    params = jax_params(model, jcfg)
    arch = GVLArch.from_config(pcfg, DT)
    port = build_model(pcfg, text_hidden_dim=DT, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, arch), strict=True)
    for m in port.modules():
        if isinstance(m, BertSelfAttention):
            m.dropout = 0.0
    text = pte.load_text_encoder(pcfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)

    # ---- eval: both EvalRunners over the same batches
    ds = DenseVideoDataset(d["val_caption_file"], d["visual_feature_folder"],
                           d["dict_file"], False, jcfg)
    batcher = Batcher(ds, jcfg, jcfg.eval_batch_size, shuffle=False)
    assert next(iter(batcher))["video_feats"].shape[-1] == \
        published.feature_dim
    jr = JEvalRunner(jcfg, model, bundle, ds.translator)
    jr.set_params(params, bundle.params)
    want = jr.run(batcher, str(tmp_path / "jax.json"))
    got = EvalRunner(pcfg, port, ds.translator, text).run(
        batcher, str(tmp_path / "port.json"))
    assert len(got[1]["results"]) == 5
    for g, w in zip(got[1:4], want[1:4]):
        assert_same_json(g, w)
    if not WORLDS[name]:
        return

    # ---- one train step on the first train batch
    train_ds = DenseVideoDataset(d["train_caption_file"],
                                 d["visual_feature_folder"], d["dict_file"],
                                 True, jcfg, np.random.RandomState(0))
    batch = next(iter(Batcher(train_ds, jcfg, jcfg.batch_size, shuffle=True,
                              rng=np.random.RandomState(0), drop_last=True)))
    jbatch = dict(batch)
    jbatch["text_ids"], jbatch["text_mask"] = bundle.tokenize(
        batch["captions_raw"], jcfg.effective_max_gt_events,
        jcfg.max_text_input_len)
    db = {k: jnp.asarray(v) for k, v in jbatch.items()
          if isinstance(v, np.ndarray)}
    jst = statics(jstate, jcfg)
    state = jstate.create_train_state(jcfg, model, params, bundle.params,
                                      100, jst)
    step_jit = jax.jit(jstate.make_train_step(model, bundle.apply_fn, jcfg,
                                              jst)[0])
    jw = {k: jnp.asarray(v, jnp.float32)
          for k, v in step_weights(jcfg, j_weight_dict(jcfg)).items()}
    state, jlosses = step_jit(state, db, jw, jax.random.PRNGKey(0))
    # Adam's first moment after one update / 0.1, less the yml's L2 term
    # (optax adds weight_decay x the parameter to the gradient)
    jgrads = jax_grads_to_named(jax.tree_util.tree_map(
        lambda m, p: np.asarray(m) / 0.1 - jcfg.weight_decay * np.asarray(p),
        adam_mu(state.opt_state), params), arch)

    pst = statics(pstate, pcfg)
    pstate_ = pstate.create_train_state(pcfg, port, 100, pst, text)
    step = pstate.make_train_step(port, pcfg, pst, text)
    pbatch = pstate.add_text_inputs(dict(batch), text, pcfg)
    for k in ("text_ids", "text_mask"):
        np.testing.assert_array_equal(pbatch[k], jbatch[k])
    try:
        losses = step(pstate_, pbatch, step_weights(pcfg,
                                                    make_weight_dict(pcfg)))
    finally:
        port.eval()
    assert set(losses) == set(jlosses) and "contrastive_loss" in losses
    for k, v in jlosses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads) == set(jgrads)
    bad = []
    for n, g in grads.items():
        w = jgrads[n].numpy()
        err = np.abs(g.numpy() - w).max()
        print("GRAD", n, err / (np.abs(w).max() + 1e-12), np.abs(w).max())
        if not err <= 1e-3 * np.abs(w).max() + 1e-7:
            bad.append(n)
    assert not bad, bad
