"""Each port module that holds or reaches the deformable-attention kernel,
against its JAX counterpart with the same (noisy) weights: MSDeformAttn1D,
the encoder and decoder layers, DeformableSoftAttention and
BasePyramidEncoder with a padded video_mask. Tiny test config, seeded numpy
inputs; tolerance atol 2e-5 / rtol 2e-4 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import base_encoder as jbe
from gvl_tpu.models import captioner as jcap
from gvl_tpu.models import layers as jlayers
from gvl_tpu.models import transformer as jtr
from gvl_tpu_torch.models import base_encoder as pbe
from gvl_tpu_torch.models import captioner as pcap
from gvl_tpu_torch.models import layers as players
from gvl_tpu_torch.models import transformer as ptr
from gvl_tpu_torch.models.gvl import build_model
from tests.test_model import tiny_cfg
from tests.test_torch_model import jax_world, make_inputs

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def world():
    cfg, _, params, _, sd = jax_world()
    return cfg, params["params"], sd


def load(module, sd, prefix, skip=()):
    sub = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)
           and not k[len(prefix):].startswith(skip)}
    module.load_state_dict(sub, strict=True)
    return module.eval()


def arr(rs, *shape, scale=1.0):
    return (scale * rs.randn(*shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def pyramid(cfg, rs, B=2):
    shapes = tuple(cfg.temporal_shapes())
    S = sum(shapes)
    mask = np.ones((B, S), bool)
    mask[1, -4:] = False
    vr = np.array([[1.0] * len(shapes), [0.75] * len(shapes)], np.float32)
    return shapes, S, mask, vr


@pytest.mark.parametrize("ref_width", [1, 2])
def test_msdeformattn_matches_jax(world, ref_width):
    cfg, params, sd = world
    rs = np.random.RandomState(3)
    C, L = cfg.hidden_dim, cfg.num_feature_levels
    shapes, S, mask, _ = pyramid(cfg, rs)
    Lq = 7
    query, memory = arr(rs, 2, Lq, C), arr(rs, 2, S, C)
    ref = rs.uniform(0.05, 0.95, (2, Lq, L, ref_width)).astype(np.float32)
    jm = jlayers.MSDeformAttn1D(C, L, cfg.nheads, 4, impl="ref")
    want = jm.apply({"params": params["decoder_layer_0"]["cross_attn"]},
                    jnp.asarray(query), jnp.asarray(ref), jnp.asarray(memory),
                    jnp.asarray(mask), shapes)
    pm = load(players.MSDeformAttn1D(C, L, cfg.nheads, 4), sd,
              "transformer.decoder.layers.0.cross_attn.")
    with torch.inference_mode():
        got = pm(t(query), t(ref), t(memory), t(mask), shapes)
    close(got, want)


def test_model_calls_the_kernel_wrapper_whatever_the_config(monkeypatch):
    # the JAX test configs set msda_impl='ref': the dense kernel's wrapper
    # (the short pyramid has no band either way)
    cfg = tiny_cfg(enable_contrastive=False, feature_dim=32, msda_impl="ref")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    calls = []

    def counted(*args):
        calls.append(1)
        return players.ms_deform_attn_1d_ref(*args)

    monkeypatch.setattr(players, "ms_deform_attn_1d", counted)
    feats, mask, duration = make_inputs(cfg)
    with torch.inference_mode():
        model(t(feats), t(mask), t(duration))
    assert len(calls) == cfg.enc_layers + cfg.dec_layers


@pytest.mark.parametrize("band_margin", [32, 0])
def test_msdeformattn_long_self_attention_needs_banded_kernel(band_margin):
    """One query per memory token at S = 525 >= 512: with band_margin=32 the
    module runs the banded op, as the JAX module with impl='pallas' does (its
    kernel in interpret mode); with band_margin=0 the dense op. The reference
    points are random, so taps leave the bands and the clamp shows. The JAX
    module runs outside jit: XLA's CPU compiler would contract loc * T - 0.5
    into an FMA and move the lerp fraction by an ulp of the tap row. atol
    2e-5 / rtol 2e-4, as the other modules."""
    import jax
    from jax.experimental.pallas import tpu as pltpu
    shapes = (280, 140, 70, 35)                    # S = 525 >= 512
    S, C, heads, points = sum(shapes), 32, 2, 2
    rs = np.random.RandomState(7)
    x = arr(rs, 1, S, C)
    ref = rs.uniform(0.05, 0.95, (1, S, len(shapes), 1)).astype(np.float32)
    jm = jlayers.MSDeformAttn1D(C, len(shapes), heads, points, impl="pallas",
                                band_margin=band_margin)
    args = (jnp.asarray(x), jnp.asarray(ref), jnp.asarray(x), None, shapes)
    with pltpu.force_tpu_interpret_mode():
        params = jax.tree_util.tree_map(
            lambda p: np.asarray(p) + 0.02 * rs.randn(*p.shape).astype(
                np.float32), jm.init(jax.random.PRNGKey(0), *args))
        want = jm.apply(params, *args)
    pm = players.MSDeformAttn1D(C, len(shapes), heads, points,
                                band_margin=band_margin)
    pm.load_state_dict({f"{name}.{k}": t(v.T if k == "weight" else v)
                        for name, p in params["params"].items()
                        for k, v in (("weight", p["kernel"]),
                                     ("bias", p["bias"]))}, strict=True)
    with torch.inference_mode():
        got = pm(t(x), t(ref), t(x), None, shapes)
        assert got.shape == (1, S, C)
        close(got, want)
        pm.band_margin = 32 - band_margin          # the other op
        other = pm(t(x), t(ref), t(x), None, shapes)
    assert float((got - other).abs().max()) > 1e-2   # the band clamp engaged


def test_encoder_layer_matches_jax(world):
    cfg, params, sd = world
    rs = np.random.RandomState(4)
    C = cfg.hidden_dim
    shapes, S, mask, vr = pyramid(cfg, rs)
    src, pos = arr(rs, 2, S, C), arr(rs, 2, S, C)
    ref = jtr.encoder_reference_points(shapes, jnp.asarray(vr))
    jm = jtr.DeformableEncoderLayer(C, cfg.transformer_ff_dim,
                                    cfg.num_feature_levels, cfg.nheads, 4,
                                    msda_impl="ref")
    want = jm.apply({"params": params["encoder"]["layer_1"]},
                    jnp.asarray(src), jnp.asarray(pos), ref,
                    jnp.asarray(mask), shapes)
    pm = load(ptr.DeformableEncoderLayer(C, cfg.transformer_ff_dim,
                                         cfg.num_feature_levels, cfg.nheads,
                                         4), sd, "transformer.encoder.layers.1.")
    pref = ptr.encoder_reference_points(shapes, t(vr))
    close(pref, ref)
    with torch.inference_mode():
        got = pm(t(src), t(pos), pref, t(mask), shapes)
    close(got, want)


def test_decoder_layer_matches_jax(world):
    cfg, params, sd = world
    rs = np.random.RandomState(5)
    C, Nq = cfg.hidden_dim, cfg.num_queries
    shapes, S, mask, vr = pyramid(cfg, rs)
    tgt, qpos, memory = arr(rs, 2, Nq, C), arr(rs, 2, Nq, C), arr(rs, 2, S, C)
    ref = rs.uniform(0.05, 0.95, (2, Nq, 2)).astype(np.float32)
    qmask = np.ones((2, Nq), bool)
    qmask[1, -3:] = False                 # exercises the key mask
    ref_in = jtr.expand_reference_for_levels(jnp.asarray(ref), jnp.asarray(vr))
    jm = jtr.DeformableDecoderLayer(C, cfg.transformer_ff_dim,
                                    cfg.num_feature_levels, cfg.nheads, 4,
                                    msda_impl="ref")
    want = jm.apply({"params": params["decoder_layer_1"]},
                    jnp.asarray(tgt), jnp.asarray(qpos), ref_in,
                    jnp.asarray(memory), jnp.asarray(mask), shapes,
                    jnp.asarray(qmask))
    pm = load(ptr.DeformableDecoderLayer(C, cfg.transformer_ff_dim,
                                         cfg.num_feature_levels, cfg.nheads,
                                         4), sd, "transformer.decoder.layers.1.")
    pref = ptr.expand_reference_for_levels(t(ref), t(vr))
    close(pref, ref_in)
    with torch.inference_mode():
        got = pm(t(tgt), t(qpos), pref, t(memory), t(mask), shapes, t(qmask))
    close(got, want)


@pytest.mark.parametrize("ref_width", [1, 2])
def test_deformable_soft_attention_matches_jax(world, ref_width):
    cfg, params, sd = world
    rs = np.random.RandomState(6)
    C, R, L = cfg.hidden_dim, cfg.rnn_size, cfg.cap_num_feature_levels
    shapes, S, mask, vr = pyramid(cfg, rs)
    Ne = 5
    memory, query = arr(rs, 2, S, C), arr(rs, 2, Ne, C)
    h = arr(rs, 2, Ne, R, scale=0.5)
    reference = rs.uniform(0.05, 0.95, (2, Ne, ref_width)).astype(np.float32)
    jm = jcap.DeformableSoftAttention(C, L, cfg.cap_nheads,
                                      cfg.cap_dec_n_points, cfg.att_hid_size,
                                      R, sampled_impl="twohot")
    p = {"params": params["caption_head_0"]["dsa"]}
    jref = jcap.prepare_dsa_reference(jnp.asarray(reference), jnp.asarray(vr),
                                      shapes, L, cfg.cap_dec_n_points)
    jval = jm.apply(p, jnp.asarray(memory), jnp.asarray(mask),
                    method=jm.project_value)
    want = jm.apply(p, jnp.concatenate([jnp.asarray(h), jnp.asarray(query)],
                                       -1), jnp.asarray(h), jref, jval, shapes)

    pm = load(pcap.DeformableSoftAttention(C, L, cfg.cap_nheads,
                                           cfg.cap_dec_n_points,
                                           cfg.att_hid_size, R, R + C),
              sd, "caption_head.0.core.", skip=("rnn.",))
    pref = pcap.prepare_dsa_reference(t(reference), t(vr), shapes, L,
                                      cfg.cap_dec_n_points)
    close(pref, jref)
    with torch.inference_mode():
        pval = pm.project_value(t(memory), t(mask))
        close(pval, jval)
        got = pm(torch.cat([t(h), t(query)], -1), t(h), pref, pval, shapes)
    close(got, want)


def test_base_pyramid_encoder_matches_jax(world):
    cfg, params, sd = world
    feats, mask, duration = make_inputs(cfg)      # video 1 is padded
    jm = jbe.BasePyramidEncoder(cfg.num_feature_levels, cfg.hidden_dim)
    want = jm.apply({"params": params["base_encoder"]}, jnp.asarray(feats),
                    jnp.asarray(mask), jnp.asarray(duration))
    pm = load(pbe.BasePyramidEncoder(cfg.num_feature_levels, cfg.hidden_dim,
                                     cfg.feature_dim), sd, "base_encoder.")
    with torch.inference_mode():
        got = pm(t(feats), t(mask), t(duration))
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == cfg.num_feature_levels
        for g, w in zip(g_list, w_list):
            if g.dtype == torch.bool:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                close(g, w)
    assert not got[1][-1][1].all()        # the padding reached the top level
    level_embed = np.zeros((cfg.num_feature_levels, cfg.hidden_dim), np.float32)
    vr_j = jtr.flatten_levels(*want, jnp.asarray(level_embed))[-1]
    vr_p = ptr.flatten_levels(*got, t(level_embed))[-1]
    close(vr_p, vr_j)
