"""The port's train step with the contrastive side on (gvl_tpu_torch.train
.state) against the JAX package's, at the tiny test config with the
flagship's text side (attention pool, layer-dependent text features, one
sentence layer with the cosine position table, cross-video negatives,
set_cost_cl 2.0, temperature 0.1) and a frozen offline RoBERTa text encoder
(hidden 64, 1 layer), from the same weights on the same seeded batch of
sentences. The contrastive weight is 0.1, the schedule's value from epoch
2, so the loss and the matcher's contrastive cost are both live.

Every dropout is 0 on both sides, as in tests/test_torch_train_step.py;
the sentence block's attention dropout, a fixed 0.1 in both packages, is
set to 0 too (the random streams of the two frameworks differ). The text
encoder runs without dropout in both packages anyway.

Tolerances: first-step losses rtol 2e-4 / atol 2e-5; named gradients max
abs difference <= 1e-3 x their own max abs + 1e-7; a 5-step trajectory of
the total loss rtol 1e-3; the text encoder unchanged by the steps.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.config import Config as JConfig
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models import gvl as jgvl
from gvl_tpu.models import text as jtext
from gvl_tpu.models import text_encoder as jte
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_grads_to_named,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.models import text_encoder as pte
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.models.text import BertSelfAttention
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import (LossSpec, cl_weight_at_epoch,
                                           make_weight_dict)
from tests.test_model import tiny_cfg
from tests.test_torch_model import add_noise
from tests.test_torch_text import FLAGSHIP_TEXT
from tests.test_torch_train_loop import once_per_test_run
from tests.test_torch_train_step import LOSS_SIDE, adam_mu, make_batch

N_STEPS = 5
LR = LOSS_SIDE["lr"]
G = 3
TEXT_SIDE = dict(FLAGSHIP_TEXT, set_cost_cl=2.0,
                 contrastive_loss_temperature=0.1, enable_cross_video_cl=True,
                 load_pretrained_language_model_from_config="offline",
                 offline_text_encoder_hidden=64, offline_text_encoder_layers=1,
                 max_text_input_len=12, gt_proposal_sample_num=G,
                 cl_schedule_time=[0, 2], cl_schedule_val=[0, 0.1])
WORDS = ("a man woman dog ball runs jumps throws catches the park field "
         "then slowly quickly again red blue").split()


def statics_kw(cfg, **kw):
    return dict(dict(enable_contrastive=True, caption_loss=True,
                     two_stage=False, train_text_encoder=False,
                     disable_mid_caption_heads=False,
                     enable_pos_emb_for_captioner=False,
                     temporal_shapes=tuple(cfg.temporal_shapes())), **kw)


def sentences(gt_mask, seed=3):
    """5-20 seeded words for each valid GT slot."""
    rs = np.random.RandomState(seed)
    return [[" ".join(rs.choice(WORDS, rs.randint(5, 21)))
             for _ in range(int(m.sum()))] for m in gt_mask]


def weights(cfg, wd):
    w = dict(wd)
    for k in w:
        if k.startswith("contrastive_loss"):
            w[k] = cl_weight_at_epoch(cfg, 2)
    assert w["contrastive_loss"] == 0.1
    return w


def compute_world(root):
    """build's results, written into `root` (world.pt): the tensors and
    numbers, the port's and the text encoder's weights after the steps."""
    mp = pytest.MonkeyPatch()
    # the sentence block's attention dropout off on the JAX side (its module
    # is built inside GVLModel.setup at every apply)
    mp.setattr(jgvl, "SentenceContextBlock",
               functools.partial(jtext.SentenceContextBlock, dropout=0.0))
    try:
        w = build(**LOSS_SIDE)
    finally:
        mp.undo()
    torch.save(dict({k: v for k, v in w.items()
                     if k not in ("cfg", "port", "text", "state")},
                    cfg=w["cfg"].to_dict(), port=w["port"].state_dict(),
                    text=w["text"].state_dict(), step=w["state"].step),
               root / "world.pt")


def load_world(root):
    """compute_world's results, with the port model and the text encoder
    (their weights after the steps) and a train state at its step count
    rebuilt."""
    w = torch.load(root / "world.pt", weights_only=False)
    cfg = JConfig().update(w.pop("cfg"))
    text = pte.load_text_encoder(cfg, device="cpu")
    text.load_state_dict(w.pop("text"), strict=True)
    port = build_model(cfg, text_hidden_dim=text.hidden_size, device="cpu")
    port.load_state_dict(w.pop("port"), strict=True)
    for m in port.modules():
        if isinstance(m, BertSelfAttention):
            m.dropout = 0.0
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    state = pstate.create_train_state(cfg, port, 100, pst, text)
    state.step = w.pop("step")
    return dict(w, cfg=cfg, port=port, text=text, state=state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once per test run (once_per_test_run)."""
    return once_per_test_run(tmp_path_factory, "torch_contrastive_world",
                             compute_world, load_world)


def initial(**loss_side):
    """The world's config, text bundle, JAX model, batch (JAX's with the
    bundle's tokens), device batch and noisy initial parameters."""
    cfg = tiny_cfg(feature_dim=32, **dict(TEXT_SIDE, **loss_side))
    bundle = jte.load_text_encoder(cfg)
    Dt = bundle.hidden_size
    model = jax_build_model(cfg, text_hidden_dim=Dt)
    batch = make_batch(cfg, G=G)
    batch["captions_raw"] = sentences(batch["gt_mask"])
    jbatch = dict(batch)
    ids, tmask = bundle.tokenize(batch["captions_raw"], G,
                                 cfg.max_text_input_len)
    jbatch["text_ids"], jbatch["text_mask"] = ids, tmask
    db = {k: jnp.asarray(v) for k, v in jbatch.items()
          if isinstance(v, np.ndarray)}
    word = jnp.zeros((2, G, cfg.max_text_input_len, Dt))
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), db["video_feats"], db["video_mask"],
        db["duration"], word_embed=word, token_mask=db["text_mask"] > 0,
        gt_mask=db["gt_mask"], captions=db["captions"]))
    return cfg, bundle, model, batch, jbatch, db, params


def port_initial(cfg, bundle, params, batch):
    """The port model (the sentence block's attention dropout off), the
    text encoder and the port's batch from `initial`'s weights."""
    Dt = bundle.hidden_size
    port = build_model(cfg, text_hidden_dim=Dt, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, Dt)), strict=True)
    for m in port.modules():
        if isinstance(m, BertSelfAttention):
            m.dropout = 0.0
    text = pte.load_text_encoder(cfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)
    return port, text, pstate.add_text_inputs(dict(batch), text, cfg)


def build(**loss_side):
    cfg, bundle, model, batch, jbatch, db, params = initial(**loss_side)
    Dt = bundle.hidden_size
    arch = GVLArch.from_config(cfg, Dt)

    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg),
                             **statics_kw(cfg))
    state = jstate.create_train_state(cfg, model, params, bundle.params, 100,
                                      jst)
    step_jit = jax.jit(jstate.make_train_step(model, bundle.apply_fn, cfg,
                                              jst)[0])
    jw = {k: jnp.asarray(v, jnp.float32)
          for k, v in weights(cfg, j_weight_dict(cfg)).items()}
    jax_losses, jax_grads = [], None
    for i in range(N_STEPS):
        state, losses = step_jit(state, db, jw, jax.random.PRNGKey(i))
        jax_losses.append({k: float(v) for k, v in losses.items()})
        if i == 0:
            jax_grads = jax.tree_util.tree_map(
                lambda m: np.asarray(m) / 0.1, adam_mu(state.opt_state))

    port, text, pbatch = port_initial(cfg, bundle, params, batch)
    text0 = {k: v.clone() for k, v in text.state_dict().items()}
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    pstate_ = pstate.create_train_state(cfg, port, 100, pst, text)
    step = pstate.make_train_step(port, cfg, pst, text)
    pw = weights(cfg, make_weight_dict(cfg))
    port_losses, port_grads = [], None
    try:
        for i in range(N_STEPS):
            losses = step(pstate_, pbatch, pw)
            port_losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:
                port_grads = {n: p.grad.clone()
                              for n, p in port.named_parameters()}
    finally:
        port.eval()
    return dict(cfg=cfg, port=port, text=text, text0=text0, state=pstate_,
                jbatch=jbatch, pbatch=pbatch, jax_losses=jax_losses,
                port_losses=port_losses,
                jax_grads=jax_grads_to_named(jax_grads, arch),
                port_grads=port_grads,
                jax_params=jax_params_to_state_dict(
                    jax.tree_util.tree_map(np.asarray, state.params), arch))


def test_text_inputs_equal_the_jax_tokenization(world):
    for k in ("text_ids", "text_mask"):
        np.testing.assert_array_equal(world["pbatch"][k], world["jbatch"][k])


def test_first_step_losses_match_jax(world):
    """Every loss of the first step, contrastive_loss and
    contrastive_loss_0 included: rtol 2e-4 / atol 2e-5."""
    want, got = world["jax_losses"][0], world["port_losses"][0]
    assert set(got) == set(want)
    assert {"contrastive_loss", "contrastive_loss_0", "loss_caption",
            "total_loss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_first_step_named_gradients_match_jax(world):
    """Every named gradient after the clip, the text side's (projections,
    word pool, sentence block) included: max abs difference <= 1e-3 x its
    own max abs + 1e-7. The JAX side is read back from Adam's first
    moment."""
    want, got = world["jax_grads"], world["port_grads"]
    assert set(got) == set(want)
    text_side = [k for k in got if k.startswith((
        "contrastive_projection", "word_context_model",
        "sentence_context_model"))]
    assert len(text_side) >= 16
    for name, g in got.items():
        w = want[name].numpy()
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)
    for name in text_side:
        # a bias that shifts every logit of a softmax alike has gradient 0
        if not name.endswith(("w2.bias", "key.bias")):
            assert float(got[name].abs().max()) > 1e-6, name


def test_loss_trajectory_matches_jax_with_the_text_encoder_frozen(world):
    """Five Adam steps on a fixed batch: total loss rtol 1e-3, the
    contrastive loss rtol 2e-3 / atol 1e-4, both falling; the text encoder
    is where it started and the parameters within 2 x lr x 5 of the JAX
    package's."""
    want = [l["total_loss"] for l in world["jax_losses"]]
    got = [l["total_loss"] for l in world["port_losses"]]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    cl = [l["contrastive_loss"] for l in world["port_losses"]]
    np.testing.assert_allclose(
        cl, [l["contrastive_loss"] for l in world["jax_losses"]], rtol=2e-3,
        atol=1e-4)
    assert cl[-1] < cl[0]
    for k, v in world["text"].state_dict().items():
        assert torch.equal(v, world["text0"][k]), k
    sd = world["port"].state_dict()
    diffs = np.concatenate([(sd[k] - v).abs().numpy().ravel() / LR
                            for k, v in world["jax_params"].items()])
    assert diffs.max() <= 2 * N_STEPS
    assert world["state"].step == N_STEPS
    assert world["state"].text_encoder is world["text"]


def test_contrastive_step_needs_the_text_encoder(world):
    cfg, port = world["cfg"], world["port"]
    st = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    with pytest.raises(ValueError, match="text encoder"):
        pstate.make_train_step(port, cfg, st)
    with pytest.raises(ValueError, match="text encoder"):
        pstate.create_train_state(cfg, port, 10, st)


@pytest.mark.parametrize("name", ["train_text_encoder", "text_bf16"])
def test_text_encoder_options_not_ported_raise_by_name(world, name):
    """The two text-encoder options the port once refused by name now build
    a state and a step, and the step runs (tests/test_torch_text_train.py
    holds both to the JAX package): train_text_encoder gives the state the
    text encoder's own optimizer and schedule, and a step that runs without
    them is refused (two steps: the text encoder's default schedule,
    warmup_linear, starts at lr 0); text_bf16 alone keeps the encoder
    frozen. The world's
    model and text encoder are left as they were."""
    cfg, port, text = world["cfg"], world["port"], world["text"]
    st = pstate.StepStatics(spec=LossSpec.from_config(cfg),
                            **statics_kw(cfg, **{name: True}))
    model_sd = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        state = pstate.create_train_state(cfg, port, 100, st, text)
        step = pstate.make_train_step(port, cfg, st, text)
        trains = name == "train_text_encoder"
        assert (state.text_optimizer is not None) == trains
        assert (state.text_scheduler is not None) == trains
        assert all(p.requires_grad == trains for p in text.parameters())
        assert not text.training
        if trains:
            with pytest.raises(ValueError, match="text encoder's optimizer"):
                step(pstate.TrainState(port, state.optimizer,
                                       state.scheduler, text_encoder=text),
                     world["pbatch"], weights(cfg, make_weight_dict(cfg)))
        for _ in range(2):       # the first at the warm-up's lr 0
            losses = step(state, world["pbatch"],
                          weights(cfg, make_weight_dict(cfg)))
            assert np.isfinite(float(losses["contrastive_loss"]))
        moved = any(not torch.equal(v, world["text0"][k])
                    for k, v in text.state_dict().items())
        assert moved == trains
    finally:
        port.load_state_dict(model_sd)
        port.eval()
        text.load_state_dict(world["text0"])
        text.requires_grad_(False).zero_grad(set_to_none=True)


def test_cl_gate_follows_the_contrastive_weight(world):
    """With the contrastive weight at 0 (the schedule's first epochs) the
    matcher runs without the contrastive cost: forward_losses at cl_gate 0
    gives exactly the losses of a spec without set_cost_cl."""
    cfg, port, text = world["cfg"], world["port"], world["text"]
    spec = LossSpec.from_config(cfg)
    assert spec.set_cost_cl == 2.0
    st = pstate.StepStatics(spec=spec, **statics_kw(cfg))
    off = pstate.StepStatics(spec=dataclasses.replace(spec, set_cost_cl=0.0),
                             **statics_kw(cfg))
    with torch.no_grad():
        gated = pstate.make_train_step(port, cfg, st, text).forward_losses(
            world["pbatch"], cl_gate=0.0)
        plain = pstate.make_train_step(port, cfg, off, text).forward_losses(
            world["pbatch"])
    assert set(gated) == set(plain)
    for k in gated:
        assert float(gated[k]) == float(plain[k]), k


def statics_from_config(cfg):
    """StepStatics as the JAX package's train loop derives them from a
    config (gvl_tpu/train/loop.py:188-208)."""
    return pstate.StepStatics(
        spec=LossSpec.from_config(cfg),
        enable_contrastive=cfg.enable_contrastive,
        caption_loss=cfg.caption_loss_coef > 0
        and cfg.caption_decoder_type != "none",
        two_stage=cfg.transformer_input_type == "gt_proposals",
        train_text_encoder=cfg.enable_contrastive
        and cfg.text_encoder_learning_strategy != "frozen",
        disable_mid_caption_heads=cfg.disable_mid_caption_heads,
        enable_pos_emb_for_captioner=False,
        temporal_shapes=tuple(cfg.temporal_shapes()),
        caption_rl=cfg.caption_loss_type == "rl",
        caption_cost=cfg.set_cost_caption > 0
        and cfg.transformer_input_type != "gt_proposals",
        caption_gpt=cfg.caption_decoder_type == "gpt2",
        text_bf16=bool(cfg.train_use_amp),
        caption_bf16=bool(cfg.get("train_caption_bf16", False)))


def test_flagship_yml_passes_every_check_and_multi_step_is_refused():
    """cfgs/anet_tsp_msvg_dvc.yml with the offline text encoder at
    roberta-base's widths: the train step's, the model's and the eval
    runner's checks pass, the model and the text encoder build (on the meta
    device: no weights are drawn), grounding eval is on. Without the offline
    flag the text encoder is refused by name. The configs whose text encoder
    trains (multi_step: YouMakeup and both TACoS), once refused by name,
    now pass the train step's and the eval runner's checks too, their G the
    JAX package's 64 slots."""
    import os

    from gvl_tpu.config import load_config
    from gvl_tpu_torch.eval.postprocess import GroundingSpec
    from gvl_tpu_torch.models.gvl import GVLModel
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "cfgs/anet_tsp_msvg_dvc.yml"),
                      load_pretrained_language_model_from_config="offline",
                      offline_text_encoder_hidden=768,
                      offline_text_encoder_layers=12)
    st = statics_from_config(cfg)
    assert st.enable_contrastive and not st.train_text_encoder
    spec = pte.RobertaSpec.offline(cfg)
    assert (spec.hidden_size, spec.num_layers, spec.num_heads,
            spec.intermediate_size) == (768, 12, 12, 3072)
    with torch.device("meta"):
        text = pte.TextEncoder(spec, device="meta")
        model = GVLModel(GVLArch.from_config(cfg, text.hidden_size),
                         device="meta")
    pstate._check_statics(st, text)
    assert cfg.eval_enable_grounding and cfg.enable_cross_video_cl
    assert GroundingSpec.from_config(cfg) == GroundingSpec(cost_cl=1.0,
                                                           cost_class=0.0)
    assert model.arch.enable_sentence_context_modeling
    assert model.contrastive_projection_text[0].in_features == 768
    assert len(model.contrastive_projection_event) == cfg.dec_layers
    cfg.load_pretrained_language_model_from_config = None
    with pytest.raises(FileNotFoundError,
                       match="pretrained_language_model='roberta-base'"):
        pte.load_text_encoder(cfg, device="cpu")
    for name in ("ym_i3d_msvg_dvc.yml", "tacos_c3d_msvg.yml",
                 "tacos_c3d_ssvg.yml"):
        other = load_config(os.path.join(root, "cfgs", name),
                            load_pretrained_language_model_from_config="x",
                            offline_text_encoder_hidden=768,
                            offline_text_encoder_layers=12)
        st = statics_from_config(other)
        assert st.enable_contrastive and st.train_text_encoder, name
        assert other.text_encoder_learning_strategy == "multi_step", name
        assert pte.effective_max_gt_events(other) == \
            other.effective_max_gt_events == 64, name
        pstate._check_statics(st, text)
        assert other.eval_enable_grounding, name
        with torch.device("meta"):
            GVLModel(GVLArch.from_config(other, text.hidden_size),
                     device="meta")
