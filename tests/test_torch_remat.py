"""remat_trunk in the port: each deformable encoder and decoder layer runs
under torch.utils.checkpoint (gvl_tpu_torch/models/transformer.py
run_layer), the counterpart of the JAX package's nn.remat
(gvl_tpu/models/gvl.py:209-214, gvl_tpu/models/transformer.py:128-139).

At the widths of tests/test_remat.py (hidden 64, 2+2 layers, 3 levels, 32
frames, the exact dense op), on the CPU (the kernels' plain versions):
- the port's gradients with remat_trunk equal its gradients without it bit
  for bit, in eval mode and in train mode with dropout (the checkpoint
  restores the forward's random state, so the recompute draws the same
  masks);
- both equal the JAX package's remat_trunk gradients (jitted jax.grad of
  the same loss on the same weights) within 1e-5 of each tensor's max abs;
- every encoder and decoder layer goes through the checkpoint, and none
  does without remat_trunk or without autograd.
Cost: one JAX init and one jitted gradient, ~10 s in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.config import Config
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.models import transformer as ptransformer
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from tests.test_torch_train_loop import computed_once

T = 32
GRAD_TOL = 1e-5


def remat_cfg(remat: bool) -> Config:
    cfg = Config()
    cfg.update(dict(
        hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
        transformer_ff_dim=128, num_feature_levels=3, num_queries=8,
        feature_dim=16, frame_embedding_num=T, vocab_size=50,
        input_encoding_size=32, rnn_size=32, att_hid_size=32,
        max_caption_len=5, cap_nheads=1, cap_num_feature_levels=3,
        with_box_refine=1, enable_contrastive=False,
        caption_decoder_type="none", msda_impl="ref", remat_trunk=remat))
    return cfg


def inputs():
    rs = np.random.RandomState(0)
    feats = rs.randn(2, T, 16).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[1, 24:] = False
    dur = np.asarray([30.0, 60.0], np.float32)
    return feats, mask, dur


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX params with seeded noise, JAX remat_trunk gradients mapped onto
    the port's names), computed once per test run (computed_once)."""
    return computed_once(tmp_path_factory, "torch_remat_world",
                         compute_world)


def compute_world():
    cfg = remat_cfg(True)
    model = jax_build_model(cfg, text_hidden_dim=32)
    feats, mask, dur = (jnp.asarray(x) for x in inputs())
    params = jax.jit(model.init)(jax.random.PRNGKey(0), feats, mask, dur)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rs.randn(*np.shape(x)).astype(
            np.float32), params)

    def loss(p):
        out = model.apply(p, feats, mask, dur, deterministic=True)
        return (jnp.sum(out["pred_logits"] ** 2)
                + jnp.sum(out["pred_boxes"] ** 2))

    grads = jax.device_get(jax.jit(jax.grad(loss))(params))
    return params, jax_grads_to_named(grads, GVLArch.from_config(cfg))


def port_grads(params, remat: bool, train: bool):
    cfg = remat_cfg(remat)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params,
                                                   GVLArch.from_config(cfg)))
    model.train(train)
    torch.manual_seed(0)
    out = model(*(torch.from_numpy(x) for x in inputs()))
    loss = (out["pred_logits"] ** 2).sum() + (out["pred_boxes"] ** 2).sum()
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("mode", ["eval", "train_dropout"])
def test_remat_gradients_equal_without_remat_bit_for_bit(world, mode):
    params, _ = world
    train = mode == "train_dropout"
    a = port_grads(params, False, train)
    b = port_grads(params, True, train)
    assert set(a) == set(b) and len(a) > 40
    for n in a:
        assert torch.equal(a[n], b[n]), n


def test_remat_gradients_match_jax_remat(world):
    params, want = world
    got = port_grads(params, True, False)
    # the loss reads no count head: autograd leaves its gradient None, JAX
    # gives zeros
    for n in set(want) - set(got):
        assert n.startswith("count_head.") and not want[n].any(), n
    for n, w in want.items():
        if n not in got:
            continue
        g, w = got[n].numpy(), w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=n)


@pytest.mark.parametrize("remat,grad", [(True, True), (False, True),
                                        (True, False)])
def test_remat_engages_every_layer(world, monkeypatch, remat, grad):
    """The counterpart of tests/test_remat.py::test_remat_engages_every_layer:
    with remat_trunk and autograd on, each of the 2 encoder and 2 decoder
    layers is called through the checkpoint once per forward; otherwise
    none is."""
    params, _ = world
    seen = []
    real = ptransformer.checkpoint

    def counting(fn, *args, **kw):
        seen.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(ptransformer, "checkpoint", counting)
    cfg = remat_cfg(remat)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params,
                                                   GVLArch.from_config(cfg)))
    with torch.set_grad_enabled(grad):
        model(*(torch.from_numpy(x) for x in inputs()))
    layers = (list(model.transformer.encoder.layers)
              + list(model.transformer.decoder.layers))
    if remat and grad:
        assert seen == layers
    else:
        assert seen == []
