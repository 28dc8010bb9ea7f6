"""The port's GVL model against the JAX package's, at the tiny test config:
the trunk dict, the greedy caption decode and the detection outputs.

Both models hold the same weights: JAX parameters with seeded noise
(sigma 0.02, so zero-initialised kernels are not zero and a transposed
layout shows) go through gvl_tpu_torch.convert. Inputs are seeded numpy with
one padded video. Tolerance: atol 2e-5 / rtol 2e-4 in f32; decoded tokens
must be equal. The long-video cases run a tiny model at 300 frames, 3 levels
(300, 150, 75: S = 525 >= 512), whose encoder self-attention is the banded
op: the JAX side with msda_impl='pallas', its kernels in interpret mode as
tests/test_model_pallas.py runs them, and outside jit (XLA's CPU compiler
contracts loc * T - 0.5 into an FMA, which moves the lerp fraction by an ulp
of the tap row, 3e-5 at row 300).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvl_tpu.eval.postprocess import detection_outputs as jax_detection
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu_torch.convert import jax_params_to_state_dict
from gvl_tpu_torch.eval.postprocess import detection_outputs
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from tests.test_model import tiny_cfg
from tests.test_torch_train_loop import computed_once

TOL = dict(rtol=2e-4, atol=2e-5)


def add_noise(params, seed=0, sigma=0.02):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + sigma * rs.randn(*np.shape(x)).astype(
            np.float32), params)


def make_inputs(cfg, B=2, seed=1):
    rs = np.random.RandomState(seed)
    T = cfg.frame_embedding_num
    feats = rs.randn(B, T, cfg.feature_dim).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, T * 2 // 3:] = False          # one padded video
    duration = rs.uniform(10, 100, (B,)).astype(np.float32)
    return feats, mask, duration


def jax_world(**cfg_kw):
    """(cfg, JAX model, noisy JAX params, port model with the same weights,
    the port's state_dict)."""
    cfg = tiny_cfg(enable_contrastive=False, feature_dim=32, **cfg_kw)
    model = jax_build_model(cfg, text_hidden_dim=48)
    feats, mask, duration = make_inputs(cfg)
    G = 3
    captions = jnp.zeros((feats.shape[0], G, cfg.max_caption_len), jnp.int32)
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = init(jax.random.PRNGKey(0), jnp.asarray(feats),
                  jnp.asarray(mask), jnp.asarray(duration), captions=captions)
    params = add_noise(params)
    sd = jax_params_to_state_dict(params, GVLArch.from_config(cfg))
    port = build_model(cfg, device="cpu")
    port.load_state_dict(sd, strict=True)
    return cfg, model, params, port, sd


def compute_world():
    cfg, model, params, port, sd = jax_world()
    feats, mask, duration = make_inputs(cfg)
    want = model.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                       jnp.asarray(duration))
    with torch.inference_mode():
        got = port(torch.from_numpy(feats), torch.from_numpy(mask),
                   torch.from_numpy(duration))
    return (cfg, params, port, (feats, mask, duration),
            jax.tree_util.tree_map(np.asarray, want), got)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Computed once per test run (computed_once); the JAX model rebuilt
    from its config."""
    cfg, params, port, inputs, want, got = computed_once(
        tmp_path_factory, "torch_model_world", compute_world)
    model = jax_build_model(cfg, text_hidden_dim=48)
    return cfg, model, params, port, inputs, want, got


LONG_VIDEO = dict(frame_embedding_num=300, msda_impl="pallas")


def compute_long_world():
    cfg, model, params, port, _ = jax_world(**LONG_VIDEO)
    assert sum(cfg.temporal_shapes()) >= 512 and cfg.msda_band_margin > 0
    feats, mask, duration = make_inputs(cfg)
    with pltpu.force_tpu_interpret_mode():
        want = model.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                           jnp.asarray(duration))
    with torch.inference_mode():
        got = port(torch.from_numpy(feats), torch.from_numpy(mask),
                   torch.from_numpy(duration))
    return cfg, jax.tree_util.tree_map(np.asarray, want), got


@pytest.fixture(scope="module")
def long_world(tmp_path_factory):
    """Computed once per test run (computed_once)."""
    return computed_once(tmp_path_factory, "torch_model_long_world",
                         compute_long_world)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("key", ["hs", "pred_logits", "pred_count",
                                 "pred_boxes", "memory", "valid_ratios",
                                 "query_pos", "layer_refs"])
def test_trunk_matches_jax(world, key):
    *_, want, got = world
    if key == "layer_refs":
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            close(g, w)
    else:
        close(got[key], want[key])
    np.testing.assert_array_equal(got["mask_flat"].numpy(),
                                  np.asarray(want["mask_flat"]))


@pytest.mark.parametrize("key", ["hs", "pred_logits", "pred_count",
                                 "pred_boxes", "memory"])
def test_long_video_trunk_matches_jax_pallas(long_world, key):
    """The trunk whose encoder runs the banded op (2 layers at S = 525),
    against the JAX trunk with the Pallas kernels. rtol 2e-4 as the trunk
    test above; atol 5e-5, not 2e-5: every softmax, layer norm and attention
    sum runs over 22 times as many tokens (525 against 24), and the outputs
    are of order 1 after four layers."""
    _, want, got = long_world
    close(got[key], want[key], rtol=2e-4, atol=5e-5)


def test_long_video_trunk_runs_the_banded_op(long_world, monkeypatch):
    from gvl_tpu_torch.models import layers
    cfg = long_world[0]
    calls = {"banded": 0, "dense": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(layers, "ms_deform_attn_1d_banded", counted(
        "banded", layers.ms_deform_attn_1d_banded))
    monkeypatch.setattr(layers, "ms_deform_attn_1d", counted(
        "dense", layers.ms_deform_attn_1d))
    port = build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    feats, mask, duration = make_inputs(cfg)
    with torch.inference_mode():
        port(torch.from_numpy(feats), torch.from_numpy(mask),
             torch.from_numpy(duration))
    assert calls == {"banded": cfg.enc_layers, "dense": cfg.dec_layers}


def test_caption_sample_matches_jax(world):
    cfg, model, params, port, _, want, got = world
    shapes = tuple(cfg.temporal_shapes())
    layer = cfg.dec_layers - 1
    sample = jax.jit(functools.partial(model.apply,
                                       method=model.caption_sample),
                     static_argnums=(1, 6))
    seq_j, lps_j = sample(
        params, layer, want["hs"][-1], want["layer_refs"][-1], want["memory"],
        want["mask_flat"], shapes, want["valid_ratios"])
    with torch.inference_mode():
        seq, lps = port.caption_sample(
            layer, got["hs"][-1], got["layer_refs"][-1], got["memory"],
            got["mask_flat"], shapes, got["valid_ratios"])
    np.testing.assert_array_equal(seq.numpy(), np.asarray(seq_j))
    assert (seq.numpy() > 0).any()        # the decode emits real words
    close(lps, lps_j, rtol=2e-4, atol=5e-5)


def test_detection_outputs_match_jax(world):
    *_, (feats, mask, duration), want, got = world
    dj = jax_detection(want, jnp.asarray(duration))
    dp = detection_outputs(got, torch.from_numpy(duration))
    assert dp.keys() == dj.keys()
    for k in ("query_idx", "labels", "pred_count"):
        np.testing.assert_array_equal(dp[k].numpy(), np.asarray(dj[k]))
    for k in ("scores", "boxes", "raw_boxes"):
        close(dp[k], dj[k], rtol=2e-4, atol=1e-4)


def test_long_video_model_with_msda_impl_ref_matches_jax_ref():
    """msda_impl='ref' at S = 525 >= 512: the JAX model runs the exact dense
    op in its encoder, and so must the port (the dense kernel route, as
    band_margin = 0 does), where it used to take the banded route. The
    encoder's sampling offsets are scaled x40 (taps up to 160 rows away, the
    band margin is 32), so the band clamp would show: the trunk must match
    JAX 'ref' within 1e-4 absolute (rtol 2e-4; the scaled offsets put taps
    at rows where an ulp of the tap position moves an output by 2e-5, the
    module tolerance) and differ from the same weights under 'pallas', the
    banded route, by more than 1e-3."""
    cfg, model, params, _, _ = jax_world(frame_embedding_num=300,
                                         msda_impl="ref")
    assert sum(cfg.temporal_shapes()) >= 512 and cfg.msda_band_margin > 0
    params = jax.tree_util.tree_map(np.asarray, params)
    for i in range(cfg.enc_layers):
        so = params["params"]["encoder"][f"layer_{i}"]["self_attn"][
            "sampling_offsets"]
        so["kernel"], so["bias"] = so["kernel"] * 40, so["bias"] * 40
    sd = jax_params_to_state_dict(params, GVLArch.from_config(cfg))
    feats, mask, duration = make_inputs(cfg)
    want = model.apply(params, jnp.asarray(feats), jnp.asarray(mask),
                       jnp.asarray(duration))
    got = {}
    for impl in ("ref", "pallas"):
        cfg.msda_impl = impl
        port = build_model(cfg, device="cpu")
        port.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            got[impl] = port(torch.from_numpy(feats), torch.from_numpy(mask),
                             torch.from_numpy(duration))
    for key in ("memory", "hs", "pred_boxes"):
        close(got["ref"][key], want[key], rtol=2e-4, atol=1e-4)
    assert float((got["pallas"]["memory"] - got["ref"]["memory"]).abs()
                 .max()) > 1e-3
