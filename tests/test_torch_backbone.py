"""The port's TSP backbone (gvl_tpu_torch.backbone) against the JAX
package's (gvl_tpu.backbone) on the CPU: torchvision-named checkpoints,
the clip features on carried-over weights, one SGD train step, the
schedule and the parameter groups.

Weights: tests/test_backbone_import.py's torch replica of torchvision's
VideoResNet (torchvision is not installed), randomised; into JAX through
its importer, into the port through gvl_tpu_torch.convert
.jax_tsp_to_state_dict of JAX's variables. Tolerances: features rtol 2e-4 /
atol 2e-5 (JAX's own test_forward_parity_*); the train step's as stated
in test_two_train_steps_match_jax. Cost: ~40 s in one process.
"""

import copy
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvl_tpu.backbone import train_tsp as jtrain
from gvl_tpu.backbone.import_torch import import_videoresnet_state_dict
from gvl_tpu.backbone.r2plus1d import TSPModel as JTSPModel
from gvl_tpu.backbone.tsp import make_clips as jax_make_clips
from gvl_tpu_torch.backbone import train_tsp as ptrain
from gvl_tpu_torch.backbone.import_torch import (
    flax_path, import_videoresnet_state_dict as port_import, load_tsp_checkpoint)
from gvl_tpu_torch.backbone.r2plus1d import R2Plus1D, TSPModel
from gvl_tpu_torch.backbone.tsp import (build_extractor,
                                        extract_clip_features, make_clips)
from gvl_tpu_torch.convert import jax_tsp_to_state_dict
from tests.test_backbone_import import VideoResNet, _randomize

BACKBONES = {"r2plus1d_18": ((2, 2, 2, 2), "2plus1d", (2, 6, 32, 32, 3)),
             "r3d_18": ((2, 2, 2, 2), "3d", (2, 6, 32, 32, 3)),
             "r2plus1d_34": ((3, 4, 6, 3), "2plus1d", (1, 4, 32, 32, 3))}


class JittedInit(JTSPModel):
    """The JAX TSPModel with its init jitted: the same variables, without
    the eager op-by-op compiles of an R(2+1)D init (~20 s). The tests put it
    in place of the JAX modules' TSPModel."""

    def init(self, rngs, *args, **kwargs):
        return jax.jit(functools.partial(super().init, **kwargs))(rngs, *args)


def replica(backbone, seed=0):
    layers, conv, _ = BACKBONES[backbone]
    tm = VideoResNet(layers, conv)
    if backbone == "r2plus1d_34":           # the IG65M weights' eps
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.eps = 1e-3
    return _randomize(tm, seed=seed).eval()


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_videoresnet_loads_strict(backbone):
    """torchvision's names: a VideoResNet's state_dict without its fc
    loads into R2Plus1D with strict=True, and the importer fills every
    entry and leaves no key unused (TSP's 'features.' prefix stripped,
    fc1 / fc2 onto a two-head TSPModel)."""
    sd = replica(backbone).state_dict()
    body = {k: v for k, v in sd.items() if not k.startswith("fc")}
    R2Plus1D(backbone).load_state_dict(body, strict=True)
    tsp = {"features." + k: v for k, v in body.items()}
    tsp.update({"fc1.weight": torch.randn(4, 512), "fc1.bias": torch.ones(4),
                "fc2.weight": torch.randn(2, 512), "fc2.bias": torch.ones(2)})
    model = TSPModel((4, 2), backbone)
    out, unused, unfilled = port_import(tsp, model)
    assert unused == [] and unfilled == []
    model.load_state_dict(out, strict=True)
    assert torch.equal(model.fc2.weight, tsp["fc2.weight"])


@pytest.mark.parametrize("backbone", sorted(BACKBONES))
def test_features_match_jax(backbone):
    """The port's clip features against TSPModel.apply(train=False) on the
    same weights (the replica through JAX's importer, then back through
    jax_tsp_to_state_dict), in eval mode: rtol 2e-4 / atol 2e-5."""
    tm = replica(backbone, seed=7)
    shape = BACKBONES[backbone][2]
    jm = JTSPModel(num_classes_list=(4,), backbone=backbone)
    variables = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]),
                        train=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables)
    new, unused, unfilled = import_videoresnet_state_dict(
        tm.state_dict(), variables, backbone=backbone)
    assert not unused and not unfilled
    clip = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want, _ = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        new, jnp.asarray(clip))
    model = TSPModel((4,), backbone)
    model.load_state_dict(jax_tsp_to_state_dict(new, backbone, (4,)),
                          strict=True)
    got = extract_clip_features(model, clip, batch_size=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
    with torch.no_grad():      # the replica itself, in torch
        ref = tm(torch.from_numpy(clip).permute(0, 4, 1, 2, 3)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_wrong_architecture_is_refused(tmp_path):
    """A 34-layer checkpoint into an 18-layer extractor raises (a shape,
    or the unmapped / unfilled check), as tsp.py:88-98 does; so does one
    with a block missing."""
    torch.save({"model": VideoResNet((3, 4, 6, 3)).state_dict()},
               tmp_path / "w34.pth")
    with pytest.raises(ValueError, match="does not match|shape"):
        build_extractor("r2plus1d_18", str(tmp_path / "w34.pth"), "cpu")
    sd = {k: v for k, v in VideoResNet().state_dict().items()
          if not k.startswith("layer4.1.")}
    torch.save({"model": sd}, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="does not match"):
        build_extractor("r2plus1d_18", str(tmp_path / "partial.pth"), "cpu")
    _, unused, unfilled = load_tsp_checkpoint(str(tmp_path / "partial.pth"),
                                              "r2plus1d_18")
    assert unused == [] and unfilled and all(
        k.startswith("layer4.1.") for k in unfilled)


def test_make_clips_matches_jax():
    frames = np.random.RandomState(0).randn(37, 4, 4, 3).astype(np.float32)
    for clip_len, stride in ((16, 16), (8, 5), (4, 40)):
        np.testing.assert_array_equal(
            make_clips(frames, clip_len, stride),
            jax_make_clips(frames, clip_len, stride))
    assert make_clips(frames[:0]).shape == (0, 16, 4, 4, 3)


def test_tsp_model_heads_and_gvf():
    """One head is `fc`, two `fc1` / `fc2`; GVF doubles the heads' input."""
    m = TSPModel((5,), "r3d_18")
    assert m.heads == ["fc"] and m.fc.in_features == 512
    m = TSPModel((5, 2), "r3d_18", use_gvf=True).eval()
    assert m.heads == ["fc1", "fc2"] and m.fc1.in_features == 1024
    with torch.no_grad():
        feat, logits = m(torch.randn(2, 4, 16, 16, 3), torch.randn(2, 512))
    assert feat.shape == (2, 512)
    assert [lg.shape for lg in logits] == [(2, 5), (2, 2)]
    with pytest.raises(ValueError, match="global video feature"):
        m(torch.randn(1, 4, 16, 16, 3))


# ------------------------------------------------------------ training

def test_schedules_match_jax():
    """WarmupMultiStepLR and the legacy warm-up + cosine, step by step,
    against the JAX schedules (float32): relative 1e-6."""
    args = (0.2, 10, [20, 40], 0.1, 1e-5)
    want = jtrain.warmup_multistep_schedule(*args)
    got = ptrain.warmup_multistep_schedule(*args)
    steps = list(range(0, 50, 3)) + [9, 10, 19, 20, 39, 40]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps], rtol=1e-6)
    legacy = optax.join_schedules(
        [optax.linear_schedule(0.0, 0.01, 5),
         optax.cosine_decay_schedule(0.01, 45)], [5])
    got = ptrain.legacy_schedule(0.01, 5, 50)
    np.testing.assert_allclose([got(s) for s in range(60)],
                               [float(legacy(s)) for s in range(60)],
                               rtol=1e-5, atol=1e-9)


def port_names(backbone, heads):
    """The port's state_dict name of each JAX TSPModel variable path."""
    out = {}
    for name in TSPModel(tuple(range(2, 2 + len(heads))),
                         backbone).state_dict():
        head, rest = name.split(".", 1)
        m = flax_path(f"{heads[head]}.{rest}" if head in heads else rest,
                      backbone)
        if m is not None:
            out[m[1]] = name
    return out


def test_param_groups_match_jax():
    """Every parameter's group (stem / backbone / fc) is the JAX label of
    the same variable (_group_labels)."""
    model = JTSPModel((3, 2), "r3d_18")
    params = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16, 3)),
        train=False))["params"]
    labels = flax.traverse_util.flatten_dict(jtrain._group_labels(params))
    names_of = port_names("r3d_18", {"fc1": "fc_0", "fc2": "fc_1"})
    seen = {names_of[k]: v for k, v in labels.items()}
    names = [n for n, _ in TSPModel((3, 2), "r3d_18").named_parameters()]
    assert sorted(seen) == sorted(names)
    for n in names:
        assert ptrain.param_group(n) == seen[n], n
    assert set(seen.values()) == {"stem", "backbone", "fc"}


def traces(opt_state, params):
    """The SGD momentum of the JAX groups that have one, a full tree with
    the stem (set_to_zero: no state) at 0."""
    flat = {k: np.zeros_like(np.asarray(v)) for k, v in
            flax.traverse_util.flatten_dict(params).items()}
    for group in ("backbone", "fc"):
        trace = opt_state.inner_states[group].inner_state[1][0].trace
        for k, v in flax.traverse_util.flatten_dict(trace).items():
            if not isinstance(v, optax.MaskedNode):
                flat[k] = np.asarray(v)
    return flax.traverse_util.unflatten_dict(flat)


def f64_gradients(model, batch, weight_decay):
    """The first step's SGD momentum (gradient + weight decay x parameter)
    of a float64 copy of `model` in train mode on `batch`."""
    m = copy.deepcopy(model).double().train()
    _, logits = m(torch.from_numpy(batch["clips"]).double(),
                  torch.from_numpy(batch["gvf"]).double())
    total = 0.0
    for lg, lab in zip(logits, batch["labels"]):
        lab = torch.from_numpy(lab)
        valid = lab >= 0
        ce = torch.nn.functional.cross_entropy(lg, lab.clamp(min=0),
                                               reduction="none")
        total = total + (ce * valid).sum() / valid.sum()
    total.backward()
    return {n: (p.grad + weight_decay * p.detach()).numpy()
            for n, p in m.named_parameters()}


def test_two_train_steps_match_jax(monkeypatch):
    """Two steps of make_tsp_train_step at batch 4 (a TSPModel with
    fc_dropout 0, the GVF on, one label -1) against the port's from the
    same weights: both steps' losses (rtol 2e-4 / atol 2e-5) and each
    group's rate at the second; after the first, the BatchNorm running
    statistics (flax's rule: momentum 0.99, the biased batch variance;
    rtol 1e-5 / atol 1e-6), and each tensor's update and SGD momentum of
    the backbone and fc groups within 3e-2 x its max abs; the frozen stem
    does not move. That tolerance is JAX's: its f32 gradients of layer1
    are 0.2-2% of their max abs off a float64 evaluation of the same step,
    the port's within 1e-5, which the port is held to (1e-4)."""
    # no warm-up and a milestone after one step: the first step at the
    # full rates, the second at gamma x them
    cfg = jtrain.TSPTrainConfig(backbone="r3d_18", num_classes_list=(3, 2),
                                use_gvf=True, backbone_lr=0.01, fc_lr=0.2,
                                lr_warmup_epochs=0, lr_milestones=(1,))
    shape = (4, 32, 32, 3)
    monkeypatch.setattr(jtrain, "TSPModel", JittedInit)
    _, params, stats, opt, opt_state = jtrain.create_tsp_train_state(
        cfg, shape, jax.random.PRNGKey(0), steps_per_epoch=1)
    model = JTSPModel(cfg.num_classes_list, cfg.backbone, cfg.use_gvf,
                      fc_dropout=0.0)
    jstep = jax.jit(jtrain.make_tsp_train_step(model, opt, cfg))

    port = ptrain.create_tsp_train_state(cfg, steps_per_epoch=1,
                                         device="cpu")
    port.model.load_state_dict(jax_tsp_to_state_dict(
        {"params": params, "batch_stats": stats}, "r3d_18", (3, 2), True),
        strict=True)
    port.model.dropout.p = 0.0
    pstep = ptrain.make_tsp_train_step(port, cfg)
    before = {k: v.clone() for k, v in port.model.state_dict().items()}

    rs = np.random.RandomState(0)
    for i in range(2):
        batch = {"clips": rs.randn(4, *shape).astype(np.float32),
                 "labels": [np.array([0, 2, 1, 1]), np.array([1, -1, 0, 1])],
                 "gvf": rs.randn(4, 512).astype(np.float32)}
        if i == 0:
            ref64 = f64_gradients(port.model, batch, cfg.weight_decay)
        params, stats, opt_state, jm = jstep(
            params, stats, opt_state, jnp.asarray(batch["clips"]),
            [jnp.asarray(l) for l in batch["labels"]],
            jnp.asarray(batch["gvf"]), jax.random.PRNGKey(i))
        pm = pstep(batch)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        if i == 0:
            check_first_step(port, before, params, stats, opt_state, ref64)
    lrs = [g["lr"] for g in port.optimizer.param_groups]
    np.testing.assert_allclose(lrs, [0.0, 1e-4, 2e-3], rtol=1e-6)


def check_first_step(port, before, params, stats, opt_state, ref64):
    want = jax_tsp_to_state_dict({"params": params, "batch_stats": stats},
                                 "r3d_18", (3, 2), True)
    got = port.model.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            moved = (v - before[k]).numpy()
            err = np.abs((got[k] - before[k]).numpy() - moved).max()
            assert err <= 3e-2 * np.abs(moved).max() + 1e-12, k
        if ptrain.param_group(k) == "stem" and k.endswith(("weight",
                                                            "bias")):
            assert torch.equal(got[k], before[k]), k
    assert any(not torch.equal(got[k], before[k]) for k in got
               if k.endswith("running_var"))
    momentum = jax_tsp_to_state_dict(
        {"params": traces(opt_state, params),
         "batch_stats": jax.tree_util.tree_map(np.asarray, stats)},
        "r3d_18", (3, 2), True)
    for n, p in port.model.named_parameters():
        if ptrain.param_group(n) == "stem":
            continue
        buf = port.optimizer.state[p]["momentum_buffer"].numpy()
        ref = momentum[n].numpy()
        assert np.abs(buf - ref).max() <= 3e-2 * np.abs(ref).max() + 1e-7, n
        assert np.abs(buf - ref64[n]).max() <= \
            1e-4 * np.abs(ref64[n]).max(), n


def test_train_tsp_runs_the_legacy_schedule(tmp_path, monkeypatch):
    """train_tsp without backbone_lr: one SGD group on the legacy warm-up +
    cosine schedule (JAX train_tsp's), each step at its scheduled rate,
    the history every log_every-th step, the model saved."""
    cfg = ptrain.TSPTrainConfig(backbone="r3d_18", num_classes_list=(3, 2),
                                lr=0.01, warmup_steps=2, total_steps=6)
    rs = np.random.RandomState(0)
    batches = [{"clips": rs.randn(2, 2, 8, 8, 3).astype(np.float32),
                "labels": [np.array([0, 2]), np.array([-1, -1])]}
               for _ in range(3)]
    seen = []
    step_fn = ptrain.make_tsp_train_step

    def spy(state, cfg):
        step = step_fn(state, cfg)

        def run(batch, seed=None):
            out = step(batch, seed)
            seen.append([g["lr"] for g in state.optimizer.param_groups])
            return out
        return run

    monkeypatch.setattr(ptrain, "make_tsp_train_step", spy)
    model, hist = ptrain.train_tsp(cfg, iter(batches), num_steps=3,
                                   log_every=2, checkpoint_dir=str(tmp_path),
                                   device="cpu")
    want = optax.join_schedules([optax.linear_schedule(0.0, 0.01, 2),
                                 optax.cosine_decay_schedule(0.01, 4)], [2])
    np.testing.assert_allclose([s[0] for s in seen],
                               [float(want(i)) for i in range(3)], rtol=1e-6)
    assert all(len(s) == 1 for s in seen) and len(hist) == 2
    assert all(h["loss_head1"] == 0.0 for h in hist)     # every label -1
    assert (tmp_path / "tsp-backbone.pth").exists()
    assert isinstance(model, TSPModel)
