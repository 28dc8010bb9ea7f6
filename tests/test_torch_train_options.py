"""The trainer's last three options in the port against the JAX package, on
the CPU: scheduled sampling (the LSTM-DSA head's serial chain at
ss_prob > 0), the caption cost (set_cost_caption > 0) and two-stage
queries (transformer_input_type 'gt_proposals').

Random draws differ between the frameworks, so both are handed the same
ones: `Draws` fixes every scheduled-sampling step's draws ahead from a
seeded numpy stream (the token argmax(prev_lp + gumbel), a draw from
exp(prev_lp), and a uniform number), given to JAX by patching
jax.random.categorical / uniform in this file only and to the port through
its seam, gvl_tpu_torch.models.captioner.ss_draws. Dropout is 0 on both
sides. Tolerances: the head's logprobs rtol 2e-4 / atol 5e-5
(tests/test_torch_captioner_train.py); a train step's losses rtol 2e-4 /
atol 2e-5 and each named gradient within 1e-3 x its max abs + 1e-7, the
JAX side read from Adam's first moment (tests/test_torch_train_step.py);
the two-stage trunk atol 2e-5 / rtol 2e-4 in f32, and in bf16 within 3
bf16 ulps of the tensor's max abs. The caption cost's criterion on numpy
inputs is held to JAX's in tests/test_torch_criterion.py. Each JAX train
step is jitted in the one test that reads it; the two-stage JAX parameters
are drawn by shape (jax.eval_shape, no compile). Cost: ~90 s in one
process.
"""

import contextlib
import copy
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.data.synthetic import make_synthetic_dataset
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.train import state as jstate
from gvl_tpu.train.checkpoint import import_pytorch_state_dict
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu.utils.amp import bf16_cast_tree
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.models import captioner as pcap
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from gvl_tpu_torch.train.import_reference import import_reference_state_dict
from gvl_tpu_torch.utils.amp import bf16_parameters, cast_floats
from tests.test_model import tiny_cfg
from tests.test_torch_import_reference import reference_payload
from tests.test_torch_caption_heads import draw_params
from tests.test_torch_model import jax_world
from tests.test_torch_train_step import (LOSS_SIDE, adam_mu, make_batch,
                                         statics_kw)

SS_PROB = 0.5
HEAD_TOL = dict(rtol=2e-4, atol=5e-5)


class Draws:
    """Every scheduled-sampling step's draws for events of `shape`, fixed
    ahead: step k's token is argmax(prev_lp + gumbel[k]) and its number
    numbers[k] (all 1.0, every draw rejected, with reject). Each framework
    takes them in the order its chain asks, from a counter of its own."""

    def __init__(self, shape, n_vocab, steps, seed=0, reject=False):
        rs = np.random.RandomState(seed)
        u = rs.uniform(1e-6, 1 - 1e-6, (steps,) + tuple(shape) + (n_vocab,))
        self.gumbel = (-np.log(-np.log(u))).astype(np.float32)
        self.numbers = rs.uniform(size=(steps,) + tuple(shape)).astype(
            np.float32)
        if reject:
            self.numbers[:] = 1.0
        self.calls = {"categorical": 0, "uniform": 0, "port": 0}

    def _next(self, who):
        k = self.calls[who]
        self.calls[who] += 1
        return k

    def categorical(self, key, logits, axis=-1, shape=None):
        return jnp.argmax(logits + self.gumbel[self._next("categorical")], -1)

    def uniform(self, key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return jnp.asarray(self.numbers[self._next("uniform")])

    def port(self, prev_lp, generator=None):
        k = self._next("port")
        tokens = torch.argmax(prev_lp + torch.from_numpy(self.gumbel[k]), -1)
        return tokens, torch.from_numpy(self.numbers[k])

    def patch(self, mp):
        mp.setattr(jax.random, "categorical", self.categorical)
        mp.setattr(jax.random, "uniform", self.uniform)
        mp.setattr(pcap, "ss_draws", self.port)


# --------------------------------------------------------- the ss head alone

@pytest.fixture(scope="module")
def head():
    cfg, model, params, port, _ = jax_world(drop_prob=0.0,
                                            transformer_dropout_prob=0.0)
    batch = make_batch(cfg)
    out = jax.jit(model.apply)(params, jnp.asarray(batch["video_feats"]),
                               jnp.asarray(batch["video_mask"]),
                               jnp.asarray(batch["duration"]))
    G = batch["captions"].shape[1]
    o = {k: np.asarray(out[k]) for k in ("memory", "mask_flat",
                                         "valid_ratios")}
    inputs = (np.asarray(out["hs"][1][:, :G]),
              np.asarray(out["layer_refs"][1][:, :G]), o["memory"],
              o["mask_flat"], tuple(cfg.temporal_shapes()),
              o["valid_ratios"], batch["captions"])
    return dict(cfg=cfg, model=model, params=params, port=port,
                inputs=inputs, caption_mask=batch["caption_mask"])


def port_inputs(inputs):
    return tuple(torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray)
                 else x for x in inputs)


def test_scheduled_sampling_head_matches_jax(head, monkeypatch):
    """The serial chain at ss_prob 0.5, train mode, against
    LSTMDSACaptioner.__call__(deterministic=False, ss_prob=0.5) given the
    same draws: every step's logprobs (B, G, Lc-1, V+1)."""
    cfg, model, inputs = head["cfg"], head["model"], head["inputs"]
    B, G, Lc = inputs[-1].shape
    draws = Draws((B, G), cfg.vocab_size + 1, Lc - 2, seed=1)
    draws.patch(monkeypatch)
    key = jax.random.PRNGKey(0)
    want = model.apply(head["params"], 1, *map(jnp.asarray, inputs[:4]),
                       inputs[4], jnp.asarray(inputs[5]),
                       jnp.asarray(inputs[6]), deterministic=False,
                       ss_prob=SS_PROB, rngs={"sample": key, "dropout": key},
                       method=model.caption_train)
    port = head["port"]
    port.train()
    try:
        with torch.no_grad():
            got = port.caption_train(1, *port_inputs(inputs),
                                     ss_prob=SS_PROB)
    finally:
        port.eval()
    assert draws.calls == {"categorical": Lc - 2, "uniform": Lc - 2,
                           "port": Lc - 2}
    assert 0.2 < (draws.numbers < SS_PROB).mean() < 0.8
    assert got.shape == want.shape == (B, G, Lc - 1, cfg.vocab_size + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **HEAD_TOL)
    # the draws moved the chain off teacher forcing
    with torch.no_grad():
        tf = port.caption_train(1, *port_inputs(inputs))
    assert np.abs(tf.numpy() - got.numpy()).max() > 1e-3


def test_every_draw_rejected_gives_the_fused_nll(head, monkeypatch):
    """At ss_prob 0.5 with every draw rejected the chain reads the teacher's
    tokens: caption_nll of its logprobs equals the fused teacher-forcing
    NLL (the input-side hoist changes f32 summation order only): rtol 1e-5,
    atol 1e-6."""
    inputs = head["inputs"]
    B, G, Lc = inputs[-1].shape
    draws = Draws((B, G), head["cfg"].vocab_size + 1, Lc - 2, reject=True)
    draws.patch(monkeypatch)
    port = head["port"]
    args = port_inputs(inputs)
    mask = torch.from_numpy(head["caption_mask"])
    port.train()
    try:
        with torch.no_grad():
            lp = port.caption_train(1, *args, ss_prob=SS_PROB)
            fused = port.caption_train_nll(1, *args, mask)
    finally:
        port.eval()
    assert draws.calls["port"] == Lc - 2
    seq = args[-1]
    nll = pcap.caption_nll(lp.reshape(B * G, *lp.shape[2:]),
                           seq[:, :, 1:].reshape(B * G, -1),
                           mask[:, :, 1:].reshape(B * G, -1))
    np.testing.assert_allclose(nll.reshape(B, G).numpy(), fused.numpy(),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------- train steps: ss, caption cost

def run_jax_step(cfg, model, params, batch, jst, ss_prob=0.0, weights=None):
    """One jitted JAX step: (losses, the step's gradients from Adam's first
    moment)."""
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    db = {k: jnp.asarray(v) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    jw = {k: jnp.asarray(v, jnp.float32)
          for k, v in (weights or j_weight_dict(cfg)).items()}
    state, losses = jax.jit(step_fn, static_argnums=(4,))(
        state, db, jw, jax.random.PRNGKey(0), ss_prob)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                   adam_mu(state.opt_state))
    return {k: float(v) for k, v in losses.items()}, grads


def run_port_step(cfg, port, batch, pst, ss_prob=0.0, weights=None):
    """One port step on a copy of `port`: (losses, named gradients, None
    for a parameter no loss reaches)."""
    port = copy.deepcopy(port)
    state = pstate.create_train_state(cfg, port, 100, pst)
    losses = pstate.make_train_step(port, cfg, pst)(
        state, batch, weights or make_weight_dict(cfg), ss_prob)
    return ({k: float(v) for k, v in losses.items()},
            {n: None if p.grad is None else p.grad.clone()
             for n, p in port.named_parameters()})


def step_world(case):
    """One step of each package from the same weights on the same batch:
    at ss_prob 0.5 with the same draws ("ss"), or with the caption cost at
    set_cost_caption 2 ("cost")."""
    cfg, model, params, port, _ = jax_world(**LOSS_SIDE)
    batch = make_batch(cfg)
    arch = GVLArch.from_config(cfg)
    B, G, Lc = batch["captions"].shape
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        if case == "ss":
            # the shared head folds both layers into one chain of B x 2G
            # events
            draws = Draws((B, 2 * G), cfg.vocab_size + 1, Lc - 2, seed=2)
            draws.patch(mp)
            out["calls"] = draws.calls
            kw, ss = statics_kw(cfg), SS_PROB
        else:
            cfg.set_cost_caption = 2.0
            kw, ss = dict(statics_kw(cfg), caption_cost=True), 0.0
            # the port's pair pass keeps no graph: its costs come without
            # gradient, the matched pairs' loss from a pass of their own
            seen = out["cost_requires_grad"] = []
            real = pstate.compute_criterion

            def spy(*a, cap_costs=None, **k):
                seen.extend(c.requires_grad for c in cap_costs)
                return real(*a, cap_costs=cap_costs, **k)

            mp.setattr(pstate, "compute_criterion", spy)
        jl, jg = run_jax_step(cfg, model, params, batch, jstate.StepStatics(
            spec=JLossSpec.from_config(cfg), **kw), ss)
        pl, pg = run_port_step(cfg, port, batch, pstate.StepStatics(
            spec=LossSpec.from_config(cfg), **kw), ss)
    finally:
        mp.undo()
    return dict(out, jax_losses=jl, port_losses=pl, port_grads=pg,
                jax_grads=jax_grads_to_named(jg, arch))


@pytest.fixture(scope="module")
def two_stage(tmp_path_factory):
    """A two-stage world on a synthetic dataset: its config, first train
    batch, JAX model, parameters drawn by shape (jax.eval_shape of the init
    with proposals: nothing compiles) and the port with the same weights."""
    root = tmp_path_factory.mktemp("two_stage")
    anno, feats, vocab, vsize = make_synthetic_dataset(
        str(root), num_videos=6, feat_dim=32)
    cfg = tiny_cfg(**dict(LOSS_SIDE, enable_contrastive=False, feature_dim=32,
                          transformer_input_type="gt_proposals",
                          train_caption_file=anno, val_caption_file=anno,
                          visual_feature_folder=feats,
                          visual_feature_type="npy", dict_file=vocab,
                          vocab_size=vsize, batch_size=3))
    ds = DenseVideoDataset(anno, feats, vocab, True, cfg)
    batch = next(iter(Batcher(ds, cfg, cfg.batch_size, shuffle=False)))
    model = jax_build_model(cfg, text_hidden_dim=48)
    params = draw_params(_shapes(model, cfg, two_stage=True), seed=3)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg)), strict=True)
    return dict(cfg=cfg, batch=batch, model=model, params=params, port=port)


def assert_step_matches(w):
    want, got = w["jax_losses"], w["port_losses"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    grads = w["jax_grads"]
    assert set(w["port_grads"]) == set(grads)
    for name, g in w["port_grads"].items():
        ref = grads[name].numpy()
        g = np.zeros_like(ref) if g is None else g.numpy()
        err, scale = np.abs(g - ref).max(), np.abs(ref).max()
        assert err <= 1e-3 * scale + 1e-7, (name, err, scale)


@pytest.mark.parametrize("case", ["ss", "cost"])
def test_train_step_matches_jax(case):
    """One step of each package: at ss_prob 0.5 with the same draws (the
    fused shared-head chain, caption_nll over its logprobs), and with the
    caption cost (the Nq x G NLL pass in the matcher; JAX reads the caption
    loss from its matched entries, the port computes the pass without
    gradient and the matched pairs again with it): every loss and every
    named gradient."""
    w = step_world(case)
    assert_step_matches(w)
    assert {"loss_caption", "loss_caption_0"} <= set(w["port_losses"])
    if case == "ss":
        Lc = 8
        assert w["calls"] == {"categorical": Lc - 2, "uniform": Lc - 2,
                              "port": Lc - 2}
    else:
        assert w["cost_requires_grad"] == [False, False]


# -------------------------------------------------------------- two-stage

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gt_proposals_trunk_matches_jax(two_stage, dtype):
    """The two-stage trunk: queries from the GT segments (masked slots out
    of the self-attention's keys), every layer's boxes the proposals. f32
    within atol 2e-5 / rtol 2e-4; under eval_full_bf16's casts (weights,
    features and proposals bf16) within 3 bf16 ulps of each tensor's max
    abs."""
    w = two_stage
    batch, model, port = w["batch"], w["model"], w["port"]
    keys = ("video_feats", "video_mask", "duration", "gt_boxes", "gt_mask")
    db = {k: jnp.asarray(batch[k]) for k in keys}
    t = {k: torch.from_numpy(np.asarray(batch[k])) for k in keys}
    bf = dtype == "bf16"
    jcast = (lambda x: x.astype(jnp.bfloat16)) if bf else (lambda x: x)
    want = jax.jit(functools.partial(model.apply,
                                     disable_iterative_refine=True))(
        bf16_cast_tree(w["params"]) if bf else w["params"],
        jcast(db["video_feats"]), db["video_mask"], db["duration"],
        proposals=jcast(db["gt_boxes"]), proposals_mask=db["gt_mask"])
    pcast = (lambda x: x.to(torch.bfloat16)) if bf else (lambda x: x)
    with torch.no_grad(), (bf16_parameters(port, promote=True) if bf
                           else contextlib.nullcontext()):
        got = port(pcast(t["video_feats"]), t["video_mask"], t["duration"],
                   proposals=pcast(t["gt_boxes"]),
                   proposals_mask=t["gt_mask"])
    got = cast_floats(got, torch.bfloat16, torch.float32)
    assert got["hs"].shape[2] == t["gt_mask"].shape[1]
    np.testing.assert_array_equal(
        got["pred_boxes"][-1].numpy(),
        np.broadcast_to(pcast(t["gt_boxes"]).float().numpy(),
                        got["pred_boxes"][-1].shape))
    for k in ("hs", "pred_logits", "pred_count", "pred_boxes", "memory"):
        g, ref = got[k].float().numpy(), np.asarray(want[k], np.float32)
        if bf:
            assert np.abs(g - ref).max() <= 3 * 2 ** -8 * np.abs(ref).max(), k
        else:
            np.testing.assert_allclose(g, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_gt_proposals_train_step_matches_jax(two_stage):
    """One two-stage step of each package, the class and box weights 0 as
    the train loop sets them: every loss and named gradient. The learnt
    queries get no gradient (None in the port, 0 in JAX)."""
    w = two_stage
    cfg, arch = w["cfg"], GVLArch.from_config(w["cfg"])
    weights = {k: 0.0 if any(q in k for q in ("loss_ce", "loss_bbox",
                                              "loss_giou")) else v
               for k, v in make_weight_dict(cfg).items()}
    kw = dict(statics_kw(cfg), two_stage=True)
    jl, jg = run_jax_step(cfg, w["model"], w["params"], w["batch"],
                          jstate.StepStatics(spec=JLossSpec.from_config(cfg),
                                             **kw), weights=weights)
    pl, pg = run_port_step(cfg, w["port"], w["batch"], pstate.StepStatics(
        spec=LossSpec.from_config(cfg), **kw), weights=weights)
    assert_step_matches(dict(jax_losses=jl, port_losses=pl, port_grads=pg,
                             jax_grads=jax_grads_to_named(jg, arch)))
    assert pg["query_embed.weight"] is None
    assert "transformer.pos_trans.weight" in pg


# ------------------------------------------------------ importing pos_trans

def imported(sd, arch, params, n_heads, drop=()):
    """(JAX's import of the numpy `sd` into `params`, its leaves under the
    top-level names `drop` removed, converted to port names, with its
    unused and unfilled lists) and the port's (out, unused, unfilled)."""
    new, junused, junfilled = import_pytorch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, params, n_heads=n_heads)
    flat = flax.traverse_util.flatten_dict(new["params"], sep="/")
    for k in junfilled:
        flat[k] = np.full_like(flat[k], np.nan)
    flat = {k: v for k, v in flat.items() if k.split("/")[0] not in drop}
    image = jax_params_to_state_dict(
        flax.traverse_util.unflatten_dict(flat, sep="/"), arch)
    return (image, sorted(junused), junfilled), \
        import_reference_state_dict(sd, arch)


def test_import_reference_pos_trans_in_both_modes(two_stage):
    """A reference .pth (it holds `reference_points` and the two-stage
    `pos_trans` / `pos_trans_norm`) against import_pytorch_state_dict: a
    two-stage model fills pos_trans and drops reference_points as used, a
    query-mode one the other way round; unused and unfilled stay empty in
    both and the weights are the JAX import's. The JAX importer reads
    reference_points in either mode (KeyError without it, AssertionError
    into the two-stage tree, which has none), so in two-stage mode it is
    given the tree with that leaf added. A query-mode checkpoint into a
    two-stage model leaves pos_trans unfilled, as in JAX."""
    cfg, port = two_stage["cfg"], two_stage["port"]
    n_heads, arch = cfg.nheads, port.arch
    qcfg = type(cfg)().update(dict(cfg.to_dict(),
                                   transformer_input_type="queries"))
    qarch = GVLArch.from_config(qcfg)
    qshapes = _shapes(jax_build_model(qcfg, text_hidden_dim=48), qcfg,
                      two_stage=False)
    sd = reference_payload(port.state_dict(), arch)["model"]
    sd.update({k: v for k, v in jax_params_to_state_dict(
        filled(qshapes, 0.5), qarch).items() if "reference_points" in k})

    tshapes = _shapes(jax_build_model(cfg, text_hidden_dim=48), cfg,
                      two_stage=True)
    jparams = filled(tshapes, 1e3)
    with pytest.raises(AssertionError, match="reference_points"):
        import_pytorch_state_dict({k: v.numpy() for k, v in sd.items()},
                                  jparams, n_heads=n_heads)
    jparams["params"]["reference_points"] = \
        filled(qshapes, 1e3)["params"]["reference_points"]
    (image, junused, junfilled), (out, unused, unfilled) = imported(
        sd, arch, jparams, n_heads, drop=("reference_points",))
    assert junused == unused == [] and junfilled == unfilled == []
    assert "transformer.pos_trans.weight" in out
    assert not any("reference_points" in k for k in out)
    for k, v in out.items():
        assert torch.equal(v, image[k]), k

    (image, junused, junfilled), (out, unused, unfilled) = imported(
        sd, qarch, filled(qshapes, 1e3), n_heads)
    assert junused == unused == [] and junfilled == unfilled == []
    assert not any("pos_trans" in k for k in out)
    for k, v in out.items():
        assert torch.equal(v, image[k]), k

    # a query-mode checkpoint into the two-stage model
    qonly = {k: v for k, v in sd.items() if "pos_trans" not in k}
    _, unused, unfilled = import_reference_state_dict(qonly, arch)
    assert unused == []
    assert unfilled == ["transformer.pos_trans.bias",
                        "transformer.pos_trans.weight",
                        "transformer.pos_trans_norm.bias",
                        "transformer.pos_trans_norm.weight"]
    _, junused, junfilled = import_pytorch_state_dict(
        {k: v.numpy() for k, v in qonly.items()}, jparams, n_heads=n_heads)
    assert junused == [] and sorted(junfilled) == [
        "pos_trans/bias", "pos_trans/kernel", "pos_trans_norm/bias",
        "pos_trans_norm/scale"]


def filled(shapes, value):
    """{'params': ...} of the shapes' tree, every leaf `value`."""
    return {"params": jax.tree_util.tree_map(
        lambda x: np.full(x.shape, value, np.float32), shapes["params"])}


def _shapes(model, cfg, two_stage):
    """The JAX model's parameter shapes (jax.eval_shape of its init)."""
    B, T, G = 2, cfg.frame_embedding_num, 3
    kw = dict(captions=jnp.zeros((B, G, cfg.max_caption_len), jnp.int32))
    if two_stage:
        kw.update(proposals=jnp.full((B, G, 2), 0.5),
                  proposals_mask=jnp.ones((B, G), bool))
    return jax.eval_shape(
        functools.partial(model.init, method=model.init_all),
        jax.random.PRNGKey(0), jnp.zeros((B, T, cfg.feature_dim)),
        jnp.ones((B, T), bool), jnp.ones((B,)), **kw)
