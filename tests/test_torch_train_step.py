"""The port's train step (gvl_tpu_torch.train.state) against the JAX
package's, at the tiny test config with both dropout probabilities 0, from
the same weights on the same seeded numpy batch.

One jitted JAX step gives the reference losses and, through Adam's first
moment (mu = 0.1 x the clipped gradient after the first update), the
reference gradients; four more give the loss trajectory. Tolerances are
stated where they are used. Schedules, the gradient clip and the optimizers
are held to optax on toy parameters.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.config import Config
from gvl_tpu.train import state as jstate
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from tests.test_torch_model import jax_world, make_inputs
from tests.test_torch_train_loop import once_per_test_run

N_STEPS = 5
LR = 5e-5
LOSS_SIDE = dict(
    drop_prob=0.0, transformer_dropout_prob=0.0, set_cost_class=2.0,
    set_cost_giou=4.0, set_cost_bbox=0.0, cls_loss_coef=2.0,
    giou_loss_coef=4.0, bbox_loss_coef=0.0, count_loss_coef=0.5,
    caption_loss_coef=2.0, lr=LR, grad_clip=100.0)


def statics_kw(cfg):
    return dict(enable_contrastive=False, caption_loss=True, two_stage=False,
                train_text_encoder=False, disable_mid_caption_heads=False,
                enable_pos_emb_for_captioner=False,
                temporal_shapes=tuple(cfg.temporal_shapes()))


def make_batch(cfg, G=3, seed=11):
    feats, mask, duration = make_inputs(cfg)
    rs = np.random.RandomState(seed)
    B, Lc = feats.shape[0], cfg.max_caption_len
    captions = rs.randint(1, cfg.vocab_size, (B, G, Lc)).astype(np.int32)
    captions[..., 0] = 0
    return dict(
        video_feats=feats, video_mask=mask, duration=duration,
        gt_boxes=np.stack([rs.uniform(0.2, 0.8, (B, G)),
                           rs.uniform(0.05, 0.4, (B, G))], -1).astype(np.float32),
        gt_labels=np.zeros((B, G), np.int32),
        gt_mask=np.arange(G)[None, :] < np.array([G, 2])[:, None],
        captions=captions,
        caption_mask=np.arange(Lc)[None, None, :] < rs.randint(
            3, Lc + 1, (B, G, 1)))


def adam_mu(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    assert len(found) == 1
    return found[0].mu


def compute_world(root):
    """Both packages' 5-step trajectory from the same weights, written into
    `root` (world.pt): the config, the losses, the first step's named
    gradients, the JAX parameters after the steps and the port's."""
    cfg, model, params, port, _ = jax_world(**LOSS_SIDE)
    batch = make_batch(cfg)

    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **statics_kw(cfg))
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    step_jit = jax.jit(step_fn)
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    jax_losses, jax_grads = [], None
    for i in range(N_STEPS):
        state, losses = step_jit(state, db, jw, jax.random.PRNGKey(i))
        jax_losses.append({k: float(v) for k, v in losses.items()})
        if i == 0:
            jax_grads = jax.tree_util.tree_map(
                lambda m: np.asarray(m) / 0.1, adam_mu(state.opt_state))
    arch = GVLArch.from_config(cfg)

    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    pstate_ = pstate.create_train_state(cfg, port, 100, pst)
    step = pstate.make_train_step(port, cfg, pst)
    pw = make_weight_dict(cfg)
    port_losses, port_grads = [], None
    try:
        for i in range(N_STEPS):
            losses = step(pstate_, batch, pw)
            port_losses.append({k: float(v) for k, v in losses.items()})
            if i == 0:
                port_grads = {n: p.grad.clone()
                              for n, p in port.named_parameters()}
    finally:
        port.eval()
    torch.save(dict(cfg=cfg.to_dict(), step=pstate_.step,
                    port=port.state_dict(), jax_losses=jax_losses,
                    port_losses=port_losses,
                    jax_grads=jax_grads_to_named(jax_grads, arch),
                    port_grads=port_grads,
                    jax_params=jax_params_to_state_dict(
                        jax.tree_util.tree_map(np.asarray, state.params),
                        arch)), root / "world.pt")


def load_world(root):
    """compute_world's results, with the port model (its weights after the
    steps) and a train state at its step count rebuilt."""
    w = torch.load(root / "world.pt", weights_only=True)
    cfg = Config().update(w.pop("cfg"))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(w.pop("port"), strict=True)
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    state = pstate.create_train_state(cfg, port, 100, pst)
    state.step = w.pop("step")
    return dict(w, cfg=cfg, arch=GVLArch.from_config(cfg), port=port,
                state=state)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once per test run (once_per_test_run)."""
    return once_per_test_run(tmp_path_factory, "torch_train_step_world",
                             compute_world, load_world)


def test_first_step_losses_match_jax(world):
    """Every loss of the first step, rtol 2e-4 / atol 2e-5 (f32, the
    tolerance of the forward parity tests)."""
    want, got = world["jax_losses"][0], world["port_losses"][0]
    assert set(got) == set(want)
    assert {"loss_caption", "loss_caption_0", "total_loss"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_first_step_named_gradients_match_jax(world):
    """Every named gradient (after the clip, as the optimizer sees it): max
    abs difference <= 1e-3 x its own max abs + 1e-7. The JAX side is read
    back from Adam's first moment, which costs one f32 rounding."""
    want, got = world["jax_grads"], world["port_grads"]
    assert set(got) == set(want)
    assert not any(k.startswith("caption_head.1.") for k in got)
    for name, g in got.items():
        w = want[name].numpy()
        scale = np.abs(w).max()
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)
    assert sum(float(np.abs(w.numpy()).max()) > 1e-6 for w in want.values()) \
        > 0.9 * len(want)                   # the gradients are not all zero


def test_loss_trajectory_matches_jax(world):
    """Five Adam steps on a fixed batch. Adam's first update is lr x sign(g),
    so a parameter whose gradient is ~0 may move by 2 x lr apart between the
    frameworks; the losses stay within rtol 1e-3, and they fall."""
    want = [l["total_loss"] for l in world["jax_losses"]]
    got = [l["total_loss"] for l in world["port_losses"]]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    for k in ("loss_caption", "loss_giou", "loss_ce_0"):
        np.testing.assert_allclose([l[k] for l in world["port_losses"]],
                                   [l[k] for l in world["jax_losses"]],
                                   rtol=2e-3, atol=1e-4, err_msg=k)


def test_parameters_after_the_trajectory_match_jax_in_units_of_lr(world):
    """After 5 updates no parameter is further than 2 x lr x 5 from the JAX
    package's, and 99% of all entries are within 0.5 x lr."""
    port_sd = world["port"].state_dict()
    diffs = np.concatenate([
        (port_sd[k] - v).abs().numpy().ravel() / LR
        for k, v in world["jax_params"].items()])
    assert diffs.max() <= 2 * N_STEPS
    assert np.quantile(diffs, 0.99) <= 0.5
    assert world["state"].step == N_STEPS


@pytest.mark.parametrize("name", ["caption_cost", "two_stage"])
def test_unported_train_options_raise_by_name(world, name):
    """The caption cost and two-stage queries, refused by name until they
    were ported, build a train state and take a step with finite losses
    (their parity with the JAX package: tests/test_torch_train_options.py).
    Under two_stage the model is a two-stage one (pos_trans, no
    reference_points)."""
    cfg = Config().update(dict(world["cfg"].to_dict(), set_cost_caption=1.0))
    port = copy.deepcopy(world["port"])
    if name == "two_stage":
        cfg.transformer_input_type = "gt_proposals"
        port = build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        assert not hasattr(port.transformer, "reference_points")
    kw = dict(statics_kw(cfg), **{name: True})
    st = pstate.StepStatics(spec=LossSpec.from_config(cfg), **kw)
    state = pstate.create_train_state(cfg, port, 10, st)
    losses = pstate.make_train_step(port, cfg, st)(
        state, make_batch(cfg), make_weight_dict(cfg), seed=1)
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert state.step == 1


def test_scheduled_sampling_is_refused(world):
    """Scheduled sampling, refused until it was ported, runs: at ss_prob
    0.25 a seeded step's losses are finite and repeat with the same seed
    (its parity with the JAX package: tests/test_torch_train_options.py)."""
    cfg, port = world["cfg"], world["port"]
    st = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    fwd = pstate.make_train_step(port, cfg, st).forward_losses
    batch = make_batch(cfg)
    port.train()
    try:
        with torch.no_grad():
            a = fwd(batch, seed=5, ss_prob=0.25)
            b = fwd(batch, seed=5, ss_prob=0.25)
    finally:
        port.eval()
    assert np.isfinite(float(a["loss_caption"]))
    for k in a:
        assert float(a[k]) == float(b[k]), k


def test_per_layer_caption_branch_matches_the_fused_one(world):
    """fuse_caption_layers=False takes one teacher-forcing pass per layer and
    gives the fused pass's losses (no dropout): rtol 2e-5 / atol 1e-6, the
    tolerance of the JAX package's own test of the two branches."""
    cfg, port = world["cfg"], world["port"]
    st = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    batch = make_batch(cfg)
    res = {}
    for fuse in (True, False):
        c = types.SimpleNamespace(fuse_caption_layers=fuse)
        with torch.no_grad():
            res[fuse] = pstate.make_train_step(port, c, st).forward_losses(batch)
    assert set(res[True]) == set(res[False])
    for k in res[True]:
        np.testing.assert_allclose(float(res[False][k]), float(res[True][k]),
                                   rtol=2e-5, atol=1e-6, err_msg=k)


def test_freeze_mode_steps_match_jax():
    """Three steps with only_ft_captioner at a gradient clip that is active
    (15, under the one-step global norm of ~20.6): the frozen parameters'
    gradients count in the clipped norm of their own step only. The head
    after the steps: 99% of its entries within 0.01 x lr of the JAX
    package's and none further than 2 x lr x 3 (Adam's first update is
    lr x sign(g)); nothing outside the head moves. Gradients left over from
    an earlier step would halve the second step's clip scale and put the
    median entry 0.1 x lr away."""
    n_steps = 3
    cfg, model, params, port, sd0 = jax_world(
        **dict(LOSS_SIDE, grad_clip=15.0, only_ft_captioner=True))
    batch = make_batch(cfg)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **statics_kw(cfg))
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_jit = jax.jit(jstate.make_train_step(model, None, cfg, jst)[0])
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    for i in range(n_steps):
        state, _ = step_jit(state, db, jw, jax.random.PRNGKey(i))
    want = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params),
        GVLArch.from_config(cfg))

    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    pstate_ = pstate.create_train_state(cfg, port, 100, pst)
    step = pstate.make_train_step(port, cfg, pst)
    norms = []
    for i in range(n_steps):
        step(pstate_, batch, make_weight_dict(cfg))
        norms.append(float(torch.sqrt(sum(
            (p.grad ** 2).sum() for p in port.parameters()))))
    np.testing.assert_allclose(norms, 15.0, rtol=1e-5)   # the clip was active
    got = port.state_dict()
    for k, v in sd0.items():
        if not k.startswith("caption_head."):
            assert torch.equal(got[k], v), k
    head = [k for k in want if k.startswith("caption_head.0.")]
    assert any(not torch.equal(got[k], sd0[k]) for k in head)
    diffs = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() / LR
                            for k in head])
    assert diffs.max() <= 2 * n_steps
    assert np.quantile(diffs, 0.99) <= 0.01


def compute_long_video_steps(root):
    """test_long_video_steps_match_jax's steps of both packages, into
    `root` (steps.pt)."""
    from jax.experimental.pallas import tpu as pltpu
    cfg, model, params, port, sd0 = jax_world(
        **dict(LOSS_SIDE, frame_embedding_num=300, msda_impl="pallas"))
    batch = make_batch(cfg)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **statics_kw(cfg))
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_jit = jax.jit(jstate.make_train_step(model, None, cfg, jst)[0])
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    want = []
    with pltpu.force_tpu_interpret_mode():
        for i in range(LONG_VIDEO_STEPS):
            state, losses = step_jit(state, db, jw, jax.random.PRNGKey(i))
            want.append({k: float(v) for k, v in losses.items()})
    want_params = jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params),
        GVLArch.from_config(cfg))

    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **statics_kw(cfg))
    pstate_ = pstate.create_train_state(cfg, port, 100, pst)
    step = pstate.make_train_step(port, cfg, pst)
    got = [{k: float(v) for k, v in
            step(pstate_, batch, make_weight_dict(cfg)).items()}
           for _ in range(LONG_VIDEO_STEPS)]
    torch.save(dict(cfg=cfg, want=want, want_params=want_params, got=got,
                    sd=port.state_dict(), sd0=sd0), root / "steps.pt")


LONG_VIDEO_STEPS = 3


def test_long_video_steps_match_jax(tmp_path_factory):
    """Three steps of a tiny long-video model (300 frames, levels 300, 150,
    75: S = 525 >= 512), whose encoder runs the banded op forward and
    backward, against the jitted JAX `step_fn` with msda_impl='pallas' (its
    kernels in interpret mode, as tests/test_model_pallas.py runs the
    model). First-step losses: rtol 5e-4 / atol 2e-5 (the jitted JAX side
    contracts loc * T - 0.5 into an FMA, which moves each lerp fraction by
    up to an ulp of the tap row, 3e-5 at row 300; the short model's 2e-4
    holds at row 24). Trajectory: total loss rtol 1e-3 and falling. The
    parameters after the steps: none further than 2 x lr x 3 from the JAX
    package's, 99% within 0.5 x lr, as the short model's trajectory test.
    The steps are computed once per test run (once_per_test_run)."""
    w = once_per_test_run(
        tmp_path_factory, "torch_train_step_long_video",
        compute_long_video_steps,
        lambda root: torch.load(root / "steps.pt", weights_only=False))
    cfg, want, got = w["cfg"], w["want"], w["got"]
    assert sum(cfg.temporal_shapes()) >= 512 and cfg.msda_band_margin > 0
    assert set(got[0]) == set(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=5e-4, atol=2e-5,
                                   err_msg=k)
    totals = [l["total_loss"] for l in got]
    np.testing.assert_allclose(totals, [l["total_loss"] for l in want],
                               rtol=1e-3)
    assert totals[-1] < totals[0]
    sd = w["sd"]
    diffs = np.concatenate([(sd[k] - v).abs().numpy().ravel() / LR
                            for k, v in w["want_params"].items()])
    assert diffs.max() <= 2 * LONG_VIDEO_STEPS
    assert np.quantile(diffs, 0.99) <= 0.5
    enc = "transformer.encoder.layers.0.self_attn.sampling_offsets.weight"
    assert not torch.equal(sd[enc], w["sd0"][enc])   # the banded op's gradient


# --------------------------------------------------------------- schedules

SCHEDULES = {
    "warmup_linear": ("warmup_linear", 1e-3, 40, 8, 0.1, 2, 1, 0.5, 5),
    "warmup_cosine": ("warmup_cosine", 1e-3, 40, 8, 0.25, 2, 1, 0.5, 5),
    "multi_step": ("multi_step", 1e-3, 40, 8, 0.1, 2, 1, 0.5, 5),
}


@pytest.mark.parametrize("strategy", sorted(SCHEDULES))
def test_schedule_matches_optax(strategy):
    """Values at every step from 0 past the end, rtol 1e-5 (f32 on the JAX
    side)."""
    want = jstate.build_schedule(*SCHEDULES[strategy])
    got = pstate.build_schedule(*SCHEDULES[strategy])
    for step in range(0, 46):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))),
                                   rtol=1e-5,
                                   atol=1e-10, err_msg=str(step))
    with pytest.raises(NotImplementedError):
        pstate.build_schedule("other", *SCHEDULES[strategy][1:])


# ------------------------------------------------------ clip and optimizers

def toy_params(rng):
    return {"caption_head_0": {"w": rng.randn(4, 3).astype(np.float32)},
            "bbox_head_1": {"w": rng.randn(5).astype(np.float32)},
            "class_head_0": {"w": rng.randn(3, 2).astype(np.float32)},
            "encoder": {"w": rng.randn(6).astype(np.float32)}}


def flat_names(tree):
    return {f"{k}.w": v["w"] for k, v in tree.items()}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(rng, max_norm):
    grads = toy_params(rng)
    want = jstate.clip_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), max_norm)
    params = {}
    for n, g in flat_names(grads).items():
        params[n] = torch.zeros(g.shape, requires_grad=True)
        params[n].grad = torch.from_numpy(g.copy())
    norm = pstate.clip_global_norm(params.values(), max_norm)
    np.testing.assert_allclose(float(norm), np.sqrt(sum(
        (g ** 2).sum() for g in flat_names(grads).values())), rtol=1e-6)
    for n, w in flat_names(want).items():
        np.testing.assert_allclose(params[n].grad.numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-8, err_msg=n)


OPTIMIZERS = {
    "adam": {},
    "adam_l2": dict(weight_decay=1e-2),
    "adamw": dict(optimizer_type="adamw", weight_decay=1e-2),
    "head_lr": dict(task_heads_different_lr=True, task_heads_lr=5e-3),
    "freeze_captioner": dict(only_ft_captioner=True),
    "freeze_class_head": dict(only_ft_class_head=True, weight_decay=1e-2),
    # the text encoder's optimizer: its own schedule (warm-up from the
    # config's default warmup_linear, or multi_step decaying after two of
    # the four updates), the model's optimizer type and weight decay, and no
    # freeze mode
    "text_warmup_linear": dict(
        for_text_encoder=True, weight_decay=1e-2, only_ft_captioner=True,
        text_encoder_lr=1e-2, text_encoder_warm_up_ratio=0.5),
    "text_multi_step": dict(
        for_text_encoder=True, weight_decay=1e-2, text_encoder_lr=1e-2,
        text_encoder_learning_strategy="multi_step",
        text_encoder_lr_decay_start=2, text_encoder_lr_decay_every=1,
        text_encoder_lr_decay_rate=0.5, epoch=4),
    "text_adamw": dict(
        for_text_encoder=True, optimizer_type="adamw", weight_decay=1e-2,
        text_encoder_lr=1e-2, text_encoder_warm_up_ratio=0.5,
        task_heads_different_lr=True, task_heads_lr=5e-3),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(rng, case):
    """Four updates with seeded gradients under a warm-up schedule (or the
    case's own), against optax from the same config: rtol 1e-5 / atol 1e-7
    on every parameter."""
    kw = dict(OPTIMIZERS[case])
    text = kw.pop("for_text_encoder", False)
    cfg = Config()
    cfg.update(dict(dict(lr=1e-2, learning_strategy="warmup_linear",
                         warm_up_ratio=0.5, epoch=1), **kw))
    total, spe = 6, 6
    if text and cfg.text_encoder_learning_strategy == "multi_step":
        spe = 1                     # one update an epoch: decays at 2 and 3
        total = cfg.epoch * spe
    params = toy_params(rng)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), params)
        for _ in range(4)]

    opt = jstate.build_optimizer(cfg, total, spe, for_text_encoder=text)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = opt.init(jp)
    import optax
    for g in grads:
        updates, opt_state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    named = {n: torch.from_numpy(v.copy()).requires_grad_()
             for n, v in flat_names(params).items()}
    popt, sched = pstate.build_optimizer(cfg, named, total, spe,
                                         for_text_encoder=text)
    for g in grads:
        for n, v in flat_names(g).items():
            named[n].grad = torch.from_numpy(v.copy())
        popt.step()
        sched.step()

    for n, w in flat_names(jp).items():
        np.testing.assert_allclose(named[n].detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    if text:
        # every parameter moves: no freeze mode, no head learning rate
        for n, v in flat_names(params).items():
            assert not np.array_equal(named[n].detach().numpy(), v), n
        assert len(popt.param_groups) == 1
    if case.startswith("freeze"):
        prefix = "caption_head" if "captioner" in case else "class_head"
        for n, v in flat_names(params).items():
            moved = not np.array_equal(named[n].detach().numpy(), v)
            assert moved == n.startswith(prefix), n
