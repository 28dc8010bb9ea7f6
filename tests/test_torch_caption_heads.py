"""The port's caption heads and head layouts against the JAX package's, at a
tiny config: the 'light', 'transformer' and 'none' caption heads, MLP class
heads and the class, count and bbox heads shared across decoder layers
(with_box_refine=0).

Three worlds, each one JAX model and the port with the same weights:
'light' (light caption head, MLP class heads, shared heads), 'transformer'
(two transformer layers) and 'none' (localization only). The JAX
parameters are drawn by shape (the JAX init traced with eval_shape, never
compiled) from seeded numpy and go through gvl_tpu_torch.convert. For each
world: the trunk, the teacher-forced NLL, the greedy decode and its early
exit, one jitted JAX train step (losses, named gradients), and the round
trip through the JAX importer. Tolerances are stated where they are used;
dropout is 0 on both sides.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models.transformer import pyramid_shapes
from gvl_tpu.train import state as jstate
from gvl_tpu.train.checkpoint import import_pytorch_state_dict
from gvl_tpu.train.criterion import LossSpec as JLossSpec
from gvl_tpu.train.criterion import make_weight_dict as j_weight_dict
from gvl_tpu_torch.convert import jax_grads_to_named, jax_params_to_state_dict
from gvl_tpu_torch.models import captioner as pcap
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.train import state as pstate
from gvl_tpu_torch.train.criterion import LossSpec, make_weight_dict
from tests.test_model import tiny_cfg
from tests.test_torch_model import make_inputs
from tests.test_torch_train_step import LOSS_SIDE, adam_mu, make_batch, \
    statics_kw

TOL = dict(rtol=2e-4, atol=2e-5)          # f32, as the trunk parity tests

WORLDS = {
    "light": dict(caption_decoder_type="light", support_mlp_class_head=1,
                  with_box_refine=0),
    "transformer": dict(caption_decoder_type="transformer",
                        input_encoding_size=64, num_layers=2),
    "none": dict(caption_decoder_type="none", caption_loss_coef=0.0),
}


def draw_params(tree, seed=0):
    """Parameters for a tree of shapes: LayerNorm/GroupNorm scales 1 + 0.1 x
    N(0, 1), every other leaf 0.1 x N(0, 1), from a seeded numpy stream."""
    rs = np.random.RandomState(seed)

    def draw(path, s):
        x = rs.randn(*s.shape).astype(np.float32)
        return 1.0 + 0.1 * x if path[-1].key == "scale" else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, tree)


def fast_world(seed=0, **cfg_kw):
    """(cfg, JAX model, JAX params, port with the same weights, the inputs)
    at the tiny test config with one encoder layer, dropout 0."""
    cfg = tiny_cfg(**dict(dict(
        enable_contrastive=False, feature_dim=32, enc_layers=1,
        max_caption_len=6), **dict(LOSS_SIDE, **cfg_kw)))
    model = jax_build_model(cfg, text_hidden_dim=48)
    feats, mask, duration = make_inputs(cfg)
    tree = jax.eval_shape(
        functools.partial(model.init, method=model.init_all),
        jax.random.PRNGKey(0), feats, mask, duration,
        captions=jnp.zeros((2, 3, cfg.max_caption_len), jnp.int32))
    params = draw_params(tree, seed)
    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg)), strict=True)
    return cfg, model, params, port, (feats, mask, duration)


def head_inputs(model, params, inputs, cfg):
    """The last decoder layer's caption inputs from the JAX trunk, as numpy:
    (query, reference, memory, mask_flat, valid_ratios) and the shapes. The
    JAX calls here are jitted: eagerly XLA compiles every op on its own,
    ten times slower at these sizes."""
    out = jax.jit(model.apply)(params, *map(jnp.asarray, inputs))
    shapes = pyramid_shapes(inputs[0].shape[1], cfg.num_feature_levels)
    arrs = [np.asarray(x) for x in (out["hs"][-1], out["layer_refs"][-1],
                                    out["memory"], out["mask_flat"],
                                    out["valid_ratios"])]
    return arrs, shapes, out


def jax_sample(model, params, arrs, shapes, **kw):
    fn = jax.jit(lambda p, *a: model.apply(p, 1, *a[:4], shapes, a[4],
                                           method=model.caption_sample, **kw))
    seq, lps = fn(params, *map(jnp.asarray, arrs))
    return np.asarray(seq), np.asarray(lps)


def port_sample(port, arrs, shapes, **kw):
    q, ref, mem, mflat, vr = map(torch.from_numpy, arrs)
    with torch.no_grad():
        seq, lps = port.caption_sample(1, q, ref, mem, mflat, shapes, vr, **kw)
    return seq.numpy(), lps.numpy()


def captions(cfg, B=2, Ne=4, seed=3):
    rs = np.random.RandomState(seed)
    Lc = cfg.max_caption_len
    seq = rs.randint(1, cfg.vocab_size, (B, Ne, Lc)).astype(np.int32)
    seq[..., 0] = 0
    mask = np.arange(Lc)[None, None] < rs.randint(3, Lc + 1, (B, Ne, 1))
    return seq, mask


def eos_biased(model_params, port, bias):
    """Both models' logit layers with `bias` added to EOS's (token 0) logit:
    (JAX params, a context restoring the port's)."""
    import copy
    p = copy.deepcopy(jax.tree_util.tree_map(np.asarray, model_params))
    head = p["params"]["caption_head_0"]
    key = "logits" if "logits" in head else "logit"
    head[key]["bias"] = head[key]["bias"].copy()
    head[key]["bias"][0] += bias
    lin = getattr(port.caption_head[0], key)
    with torch.no_grad():
        lin.bias[0] += bias
    return p


@functools.lru_cache(maxsize=None)
def get_world(name):
    """The world `name`, built once per test process."""
    cfg, model, params, port, inputs = fast_world(**WORLDS[name])
    arrs, shapes, jout = head_inputs(model, params, inputs, cfg)
    return dict(name=name, cfg=cfg, model=model, params=params, port=port,
                inputs=inputs, arrs=arrs, shapes=shapes, jout=jout)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_trunk_matches_jax(name):
    """Class logits, boxes and counts of every layer (the MLP class heads and
    the shared heads in the 'light' world), f32 tolerance."""
    world = get_world(name)
    with torch.no_grad():
        got = world["port"](*map(torch.from_numpy, world["inputs"]))
    for k in ("pred_logits", "pred_boxes", "pred_count"):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(world["jout"][k]), **TOL,
                                   err_msg=k)
    if world["name"] == "light":
        port = world["port"]
        assert port.class_head[0] is port.class_head[1]
        assert port.bbox_head[0] is port.bbox_head[1]
        assert len(port.class_head[0].layers) == 3


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_teacher_forced_nll_matches_jax(name):
    """caption_train_nll of the last layer on 4 events with random
    captions, f32 tolerance (the 'none' head gives 0)."""
    world = get_world(name)
    cfg, model, params = world["cfg"], world["model"], world["params"]
    q, ref, mem, mflat, vr = world["arrs"]
    seq, mask = captions(cfg)
    shapes = world["shapes"]
    want = jax.jit(lambda p, *a: model.apply(
        p, 1, *a[:4], shapes, *a[4:], method=model.caption_train_nll))(
        params, *map(jnp.asarray, (q[:, :4], ref[:, :4], mem, mflat, vr,
                                   seq, mask)))
    with torch.no_grad():
        got = world["port"].caption_train_nll(
            1, *(torch.from_numpy(x) for x in (q[:, :4], ref[:, :4], mem,
                                                mflat)),
            world["shapes"], torch.from_numpy(vr), torch.from_numpy(seq),
            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (np.asarray(want) != 0).any() == (world["name"] != "none")


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_greedy_decode_matches_jax(name):
    """Greedy tokens exactly, chosen logprobs 2e-5 (f32)."""
    world = get_world(name)
    want = jax_sample(world["model"], world["params"], world["arrs"],
                      world["shapes"])
    got = port_sample(world["port"], world["arrs"], world["shapes"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-5)


def test_transformer_cached_decode_equals_reforward_oracle():
    """The KV-cached decode gives the re-forward loop's tokens, and logprobs
    within 2e-5 (the same function summed in another order)."""
    world = get_world("transformer")
    cached = port_sample(world["port"], world["arrs"], world["shapes"])
    q, ref, mem, mflat, vr = map(torch.from_numpy, world["arrs"])
    with torch.no_grad():
        oracle = world["port"].caption_head[1].sample(
            q, ref, mem, mflat, world["shapes"], vr, use_cache=False)
    np.testing.assert_array_equal(cached[0], oracle[0].numpy())
    np.testing.assert_allclose(cached[1], oracle[1].numpy(), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("bias", [0.0, 3.0])
@pytest.mark.parametrize("name", ["light", "transformer"])
def test_early_exit_matches_jax_and_the_fixed_loop(name, bias):
    """eval_decode_early_exit: the tokens of the fixed loop, for the port
    and for JAX; the logprobs equal JAX's while_loop's (the steps it does
    not run are 0) within 2e-5. With EOS's logit raised by 3 the loop stops
    before max_caption_len (JAX's too: its trailing logprobs are 0). The
    LSTM-DSA head's case is in tests/test_torch_decode_options.py."""
    world = get_world(name)
    params = world["params"]
    port = world["port"]
    head = port.caption_head[1]
    saved = {k: v.clone() for k, v in head.state_dict().items()}
    try:
        if bias:
            params = eos_biased(params, port, bias)
        fixed = port_sample(port, world["arrs"], world["shapes"])
        steps = []
        real = pcap.decode_loop

        def counting(step, *a, **kw):
            def counted(it, t):
                steps.append(t)
                return step(it, t)
            return real(counted, *a, **kw)

        pcap.decode_loop = counting
        try:
            got = port_sample(port, world["arrs"], world["shapes"],
                              early_exit=True)
        finally:
            pcap.decode_loop = real
        want = jax_sample(world["model"], params, world["arrs"],
                          world["shapes"], early_exit=True)
    finally:
        head.load_state_dict(saved)
    np.testing.assert_array_equal(got[0], fixed[0])
    np.testing.assert_array_equal(want[0], fixed[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-5)
    Lc = world["cfg"].max_caption_len
    if bias:
        assert len(steps) < Lc and (want[1][..., len(steps):] == 0).all()
        assert (got[1][..., len(steps):] == 0).all()


@functools.lru_cache(maxsize=None)
def trained(name):
    """One jitted JAX train step and one port step on the same batch: their
    losses and named gradients (the JAX side read from Adam's first moment,
    as tests/test_torch_train_step.py does)."""
    world = get_world(name)
    cfg, model, params, port = (world[k] for k in ("cfg", "model", "params",
                                                   "port"))
    batch = make_batch(cfg)
    skw = dict(statics_kw(cfg), caption_loss=cfg.caption_loss_coef > 0)
    jst = jstate.StepStatics(spec=JLossSpec.from_config(cfg), **skw)
    state = jstate.create_train_state(cfg, model, params, None, 100, jst)
    step_fn, _, _ = jstate.make_train_step(model, None, cfg, jst)
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    jw = {k: jnp.asarray(v, jnp.float32) for k, v in j_weight_dict(cfg).items()}
    state, jl = jax.jit(step_fn)(state, db, jw, jax.random.PRNGKey(0))
    arch = GVLArch.from_config(cfg)
    jg = jax_grads_to_named(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, adam_mu(state.opt_state)), arch)

    saved = {k: v.clone() for k, v in port.state_dict().items()}
    pst = pstate.StepStatics(spec=LossSpec.from_config(cfg), **skw)
    step = pstate.make_train_step(port, cfg, pst)
    try:
        pl = step(pstate.create_train_state(cfg, port, 100, pst), batch,
                  make_weight_dict(cfg))
        pg = {n: p.grad.clone() for n, p in port.named_parameters()
              if p.grad is not None}
    finally:
        port.load_state_dict(saved)
        port.eval()
    return ({k: float(v) for k, v in jl.items()},
            {k: float(v) for k, v in pl.items()}, jg, pg)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_train_step_losses_match_jax(name):
    """Every loss of the step, rtol 2e-4 / atol 2e-5; the caption losses of
    both layers where the head captions."""
    want, got = trained(name)[:2]
    assert set(got) == set(want)
    assert ("loss_caption" in got) == (name != "none")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_train_step_named_gradients_match_jax(name):
    """Every named gradient within 1e-3 x its max abs + 1e-7 (one f32
    rounding through Adam's moment on the JAX side); a shared head is one
    module, its gradient the sum over the layers in both packages."""
    want, got = trained(name)[2:]
    assert set(got) <= set(want)
    for name in want:
        w = want[name].numpy()
        g = got[name].numpy() if name in got else np.zeros_like(w)
        err = np.abs(g - w).max()
        assert err <= 1e-3 * np.abs(w).max() + 1e-7, (name, err)
    if name == "light":
        assert not any(k.startswith(("class_head.1.", "bbox_head.1."))
                       for k in want)
        assert np.abs(got["class_head.0.layers.2.weight"].numpy()).max() > 0


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_round_trip_through_the_jax_importer(name):
    """The port's state_dict into the JAX package's importer. It maps Linear
    class heads and the LSTM-DSA caption head only (checkpoint.py:263-264,
    326-352): with the light or transformer head's keys it raises KeyError
    (it looks for `core.rnn` / `logit`), so those keys go to
    gvl_tpu_torch.convert alone. Named here: the keys the importer leaves
    unused (the MLP class heads and, since its head loop stops at the
    missing Linear `class_head.0.weight`, the count and bbox heads; the
    shared heads' second index) and the flax keys it leaves unfilled (the
    caption head, and the heads of the 'light' world). Every key it fills
    is the JAX parameter's value."""
    world = get_world(name)
    cfg, params, port = world["cfg"], world["params"], world["port"]
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    if name != "none":
        with pytest.raises(KeyError):
            import_pytorch_state_dict(sd, params, cfg.nheads)
    rest = {k: v for k, v in sd.items() if not k.startswith("caption_head.")}
    new, unused, unfilled = import_pytorch_state_dict(rest, params, cfg.nheads)
    heads = ("class_head.", "count_head.", "bbox_head.")
    want_unused = sorted(k for k in rest if name == "light"
                         and k.startswith(heads))
    assert unused == want_unused
    flat = {"/".join(p.key for p in path): v for path, v in
            jax.tree_util.tree_leaves_with_path(params["params"])}
    want_unfilled = sorted(k for k in flat if k.startswith("caption_head_") or
                           (name == "light" and k.startswith(
                               ("class_head_", "count_head_", "bbox_head_"))))
    assert unfilled == want_unfilled
    got = {"/".join(p.key for p in path): v for path, v in
           jax.tree_util.tree_leaves_with_path(new["params"])}
    for k in set(flat) - set(unfilled):
        np.testing.assert_array_equal(np.asarray(got[k]), flat[k], err_msg=k)
