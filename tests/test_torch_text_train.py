"""The port's train step with a text encoder that trains (gvl_tpu_torch.train
.state, train_text_encoder) against the JAX package's, at the tiny test
config with the YouMakeup / TACoS text side (`cfgs/ym_i3d_msvg_dvc.yml`:
layer-independent text features, attention word pool, one sentence layer
with the cosine position table, cross-video negatives, set_cost_cl 2.0,
temperature 0.1, weight_decay 1e-4 as L2 through the gradient, the text
encoder on a `multi_step` schedule of its own), an offline RoBERTa of hidden
64 and 1 layer, from the same weights on the same seeded batch of sentences.
One update is one epoch and the text encoder's learning rate halves from
epoch 2 and again from epoch 3, so the 5 steps cross both milestones.

Every dropout is 0 on both sides, as in tests/test_torch_contrastive_train.py
(the sentence block's fixed 0.1 too); the text encoder runs without dropout
in both packages.

The JAX side's gradients are read back from Adam's first moment, which the
L2 term enters: g = mu / 0.1 - weight_decay x the parameter before the step.
Tolerances are stated in each test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from tests.test_model import tiny_cfg
from tests.test_torch_contrastive_train import (G, TEXT_SIDE, sentences,
                                                statics_kw, weights)
from tests.test_torch_model import add_noise
from tests.test_torch_train_step import LOSS_SIDE, adam_mu, make_batch

N_STEPS = 5
WD = 1e-4
TEXT_LR = 1e-4
YM_TEXT = dict(
    TEXT_SIDE, enable_layer_diff_text_feature=False, weight_decay=WD,
    text_encoder_learning_strategy="multi_step", text_encoder_lr=TEXT_LR,
    text_encoder_lr_decay_start=2, text_encoder_lr_decay_every=1,
    text_encoder_lr_decay_rate=0.5, epoch=4)
STEPS_PER_EPOCH = 1
POOLER = "text_encoder.pooler."


def _jax_grads(opt_state, params):
    """Adam's first moment after one update / 0.1, less the L2 term."""
    return jax.tree_util.tree_map(
        lambda m, p: np.asarray(m) / 0.1 - WD * np.asarray(p),
        adam_mu(opt_state), params)


def run(n_steps, text_bf16=False):
    """n_steps of both packages' train step from the same weights, the text
    encoder training; returns their losses, first-step gradients and
    parameters before and after."""
    cfg = tiny_cfg(feature_dim=32, **dict(YM_TEXT, **LOSS_SIDE))
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
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), db["video_feats"], db["video_mask"],
        db["duration"], word_embed=jnp.zeros((2, G, cfg.max_text_input_len,
                                              Dt)),
        token_mask=db["text_mask"] > 0, gt_mask=db["gt_mask"],
        captions=db["captions"]))
    text_params = jax.tree_util.tree_map(np.asarray, bundle.params)
    arch = GVLArch.from_config(cfg, Dt)
    kw = statics_kw(cfg, train_text_encoder=True, text_bf16=text_bf16)

    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **kw)
    state = jstate.create_train_state(cfg, model, params, bundle.params,
                                      STEPS_PER_EPOCH, jst)
    step_jit = jax.jit(jstate.make_train_step(model, bundle.apply_fn, cfg,
                                              jst)[0])
    jw = {k: jnp.asarray(v, jnp.float32)
          for k, v in weights(cfg, j_weight_dict(cfg)).items()}
    jax_losses = []
    for i in range(n_steps):
        state, losses = step_jit(state, db, jw, jax.random.PRNGKey(i))
        jax_losses.append({k: float(v) for k, v in losses.items()})
        if i == 0:
            jax_grads = jax_grads_to_named(
                _jax_grads(state.opt_state, params), arch)
            jax_text_grads = flax_roberta_to_state_dict(
                _jax_grads(state.text_opt_state, text_params))

    port = build_model(cfg, text_hidden_dim=Dt, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(params, arch), strict=True)
    for m in port.modules():
        if isinstance(m, BertSelfAttention):
            m.dropout = 0.0
    text = pte.load_text_encoder(cfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(text_params),
                         strict=True)
    text0 = {k: v.clone() for k, v in text.state_dict().items()}
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **kw)
    pstate_ = pstate.create_train_state(cfg, port, STEPS_PER_EPOCH, pst,
                                        text)
    step = pstate.make_train_step(port, cfg, pst, text)
    pbatch = pstate.add_text_inputs(dict(batch), text, cfg)
    pw = weights(cfg, make_weight_dict(cfg))
    port_losses, lrs = [], []
    try:
        for i in range(n_steps):
            lrs.append(pstate_.text_optimizer.param_groups[0]["lr"])
            losses = step(pstate_, pbatch, pw)
            port_losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:
                port_grads = {n: p.grad.clone()
                              for n, p in port.named_parameters()}
                port_text_grads = {n: p.grad.clone()
                                   for n, p in text.named_parameters()}
    finally:
        port.eval()
    return dict(
        cfg=cfg, port=port, text=text, text0=text0, state=pstate_, lrs=lrs,
        jax_losses=jax_losses, port_losses=port_losses,
        jax_grads=jax_grads, port_grads=port_grads,
        jax_text_grads=jax_text_grads, port_text_grads=port_text_grads,
        jax_text0=flax_roberta_to_state_dict(text_params),
        jax_text=flax_roberta_to_state_dict(
            jax.tree_util.tree_map(np.asarray, state.text_params)))


@pytest.fixture(scope="module")
def patched():
    mp = pytest.MonkeyPatch()
    # the sentence block's attention dropout off on the JAX side (its module
    # is built inside GVLModel.setup at every apply)
    mp.setattr(jgvl, "SentenceContextBlock",
               functools.partial(jtext.SentenceContextBlock, dropout=0.0))
    try:
        yield
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def world(patched):
    return run(N_STEPS)


@pytest.fixture(scope="module")
def bf16_world(patched):
    return run(1, text_bf16=True)


def assert_losses_match(want, got):
    assert set(got) == set(want)
    assert {"contrastive_loss", "contrastive_loss_0", "loss_caption",
            "total_loss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def assert_grads_match(want, got, slack=None):
    """max abs difference <= 1e-3 x the JAX gradient's own max abs + 1e-7
    (+ slack(w) elementwise)."""
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name].numpy()
        bound = 1e-3 * np.abs(w).max() + 1e-7
        if slack is not None:
            bound = bound + slack(w)
        err = np.abs(g.numpy() - w)
        assert (err <= bound).all(), (name, err.max(), np.abs(w).max())


def test_first_step_losses_match_jax(world):
    """Every loss of the first step, contrastive_loss and
    contrastive_loss_0 included: rtol 2e-4 / atol 2e-5."""
    assert_losses_match(world["jax_losses"][0], world["port_losses"][0])


@pytest.mark.parametrize("which", ["model", "text_encoder"])
def test_first_step_named_gradients_match_jax(world, which):
    """Both parameter sets' named gradients after their own clip: max abs
    difference <= 1e-3 x the JAX gradient's max abs + 1e-7. The text
    encoder's reach every layer; the pooler's are 0 in both."""
    key = "grads" if which == "model" else "text_grads"
    want, got = world["jax_" + key], world["port_" + key]
    assert_grads_match(want, got)
    if which == "text_encoder":
        assert len(got) == len(dict(world["text"].named_parameters()))
        moving = [n for n in got if not n.startswith(POOLER)
                  and float(got[n].abs().max()) > 1e-6]
        assert len(moving) >= len(got) - 4
        for n in got:
            if n.startswith(POOLER):
                assert float(got[n].abs().max()) == 0.0, n
                assert float(np.abs(want[n].numpy()).max()) <= 1e-9, n


def test_loss_trajectory_matches_jax_with_the_text_encoder_training(world):
    """Five steps: total loss rtol 1e-3, the contrastive loss rtol 2e-3 /
    atol 1e-4, both falling; the text encoder's learning rate follows its
    multi_step schedule (1, 1, 1/2, 1/4, 1/4 of text_encoder_lr)."""
    want = [l["total_loss"] for l in world["jax_losses"]]
    got = [l["total_loss"] for l in world["port_losses"]]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    cl = [l["contrastive_loss"] for l in world["port_losses"]]
    np.testing.assert_allclose(
        cl, [l["contrastive_loss"] for l in world["jax_losses"]], rtol=2e-3,
        atol=1e-4)
    assert cl[-1] < cl[0]
    np.testing.assert_allclose(world["lrs"], np.array(
        [1, 1, 0.5, 0.25, 0.25]) * TEXT_LR, rtol=1e-12)
    assert world["state"].step == N_STEPS


def test_text_encoder_updates_match_jax(world):
    """After 5 steps each text parameter's update (after - before) is within
    1e-2 x the JAX update's max abs of it, and the pooler's, which only the
    L2 term moves, within 1e-6 absolute; every other parameter moved by
    more than lr / 2. The
    exception is the attention's key bias: it shifts every logit of a
    softmax alike, so its gradient is 0 in exact arithmetic and rounding
    noise in either package, and Adam turns noise into updates of unrelated
    sign; in both packages it moves by less than 1e-3 x lr over the 5 steps
    while the other parameters move by about lr a step."""
    got, want = world["text"].state_dict(), world["jax_text"]
    before, want0 = world["text0"], world["jax_text0"]
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(before[k], want0[k]), k
        du, dw = (got[k] - before[k]).numpy(), (want[k] - want0[k]).numpy()
        scale = np.abs(dw).max()
        if k.startswith(POOLER):
            assert np.abs(du - dw).max() <= 1e-6, k
            continue
        if k.endswith("attention.self.key.bias"):
            assert 0 < max(scale, np.abs(du).max()) < 1e-3 * TEXT_LR, k
            continue
        assert scale > 0.5 * TEXT_LR and np.abs(du).max() > 0, k
        assert np.abs(du - dw).max() <= 1e-2 * scale, (
            k, np.abs(du - dw).max(), scale)
    # the pooler's weight moved by about lr a step, as Adam moves a parameter
    # whose gradient is its L2 term alone; its bias, 0 at the start, has no
    # L2 term and stays
    pool = (got[POOLER + "dense.weight"] - before[POOLER + "dense.weight"])
    assert float(pool.abs().max()) > 0.5 * TEXT_LR
    assert torch.equal(got[POOLER + "dense.bias"],
                       before[POOLER + "dense.bias"])


def test_text_bf16_step_matches_jax(bf16_world):
    """The step with text_bf16 (train_use_amp): the text encoder's weights
    rounded to bfloat16, f32 arithmetic. First-step losses rtol 2e-4 /
    atol 2e-5; every text gradient is bfloat16-representable (the pooler's
    0), and within 1e-3 x the JAX gradient's max abs + 1e-7 + one bfloat16
    ulp (2^-7 of the element: both round an f32 gradient that differs in
    its last bits)."""
    assert_losses_match(bf16_world["jax_losses"][0],
                        bf16_world["port_losses"][0])
    got = bf16_world["port_text_grads"]
    for n, g in got.items():
        assert torch.equal(g, g.to(torch.bfloat16).float()), n
    assert_grads_match(bf16_world["jax_text_grads"], got,
                       slack=lambda w: np.abs(w) * 2.0 ** -7)


def test_text_bf16_losses_differ_from_the_f32_step(world, bf16_world):
    """The rounding is real: the bf16-weight step's contrastive loss is not
    the f32 step's."""
    a = bf16_world["port_losses"][0]["contrastive_loss"]
    b = world["port_losses"][0]["contrastive_loss"]
    assert a != b
