"""Teacher forcing in the port's LSTM-DSA caption head against the JAX
package's, at the tiny test config with the weights of
tests/test_torch_model.py: the fused per-event NLL, the teacher-forced
logprobs, the input-side hoist against the serial recurrence, and prepared
references.

Both sides run without dropout (JAX deterministic, the port in eval mode) on
the same numpy inputs: the JAX trunk's outputs and seeded captions.
Tolerance: rtol 2e-4 / atol 5e-5 in f32 (the logprobs pass through a
6-step recurrence and a logsumexp over the vocabulary).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models import captioner as jcap
from gvl_tpu_torch.models import captioner as pcap
from tests.test_torch_model import jax_world, make_inputs

TOL = dict(rtol=2e-4, atol=5e-5)
G = 3


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def world():
    cfg, model, params, port, _ = jax_world()
    feats, mask, duration = make_inputs(cfg)
    out = jax.jit(model.apply)(params, jnp.asarray(feats), jnp.asarray(mask),
                               jnp.asarray(duration))
    rs = np.random.RandomState(5)
    B, Lc = feats.shape[0], cfg.max_caption_len
    seq = rs.randint(1, cfg.vocab_size, (B, G, Lc)).astype(np.int32)
    seq[..., 0] = 0
    seq_mask = np.arange(Lc)[None, None, :] < rs.randint(2, Lc + 1, (B, G, 1))
    jit = lambda method: jax.jit(  # noqa: E731
        functools.partial(model.apply, method=method), static_argnums=(1, 6),
        static_argnames=("ref_prepared",))
    return dict(cfg=cfg, model=model, params=params, port=port, out=out,
                seq=seq, seq_mask=seq_mask,
                shapes=tuple(cfg.temporal_shapes()),
                nll=jit(model.caption_train_nll), lp=jit(model.caption_train))


def head_inputs(w, layer):
    """(query, reference) of the first G queries of a decoder layer: layer
    0's reference is the centre only, the last layer's (centre, length)."""
    return (np.asarray(w["out"]["hs"][layer][:, :G]),
            np.asarray(w["out"]["layer_refs"][layer][:, :G]))


def common(w, conv):
    o = w["out"]
    return (conv(np.asarray(o["memory"])), conv(np.asarray(o["mask_flat"])),
            w["shapes"], conv(np.asarray(o["valid_ratios"])))


@pytest.mark.parametrize("layer", [0, 1])
def test_teacher_forced_nll_matches_jax(world, layer):
    w = world
    query, ref = head_inputs(w, layer)
    assert ref.shape[-1] == 1 + layer
    want = w["nll"](w["params"], layer, jnp.asarray(query), jnp.asarray(ref),
                    *common(w, jnp.asarray), jnp.asarray(w["seq"]),
                    jnp.asarray(w["seq_mask"]))
    with torch.no_grad():
        got = w["port"].caption_train_nll(
            layer, t(query), t(ref), *common(w, t), t(w["seq"]),
            t(w["seq_mask"]))
    assert got.shape == (query.shape[0], G)
    close(got, want)


@pytest.mark.parametrize("layer", [0, 1])
def test_teacher_forced_logprobs_match_jax(world, layer):
    w = world
    query, ref = head_inputs(w, layer)
    want = w["lp"](w["params"], layer, jnp.asarray(query), jnp.asarray(ref),
                   *common(w, jnp.asarray), jnp.asarray(w["seq"]))
    with torch.no_grad():
        got = w["port"].caption_train(layer, t(query), t(ref), *common(w, t),
                                      t(w["seq"]))
    assert got.shape == want.shape
    close(got, want)


def test_nll_is_caption_nll_of_the_logprobs(world):
    w = world
    query, ref = head_inputs(w, 1)
    with torch.no_grad():
        lp = w["port"].caption_train(1, t(query), t(ref), *common(w, t),
                                     t(w["seq"]))
        nll = w["port"].caption_train_nll(1, t(query), t(ref), *common(w, t),
                                          t(w["seq"]), t(w["seq_mask"]))
    N = lp.shape[0] * G
    got = pcap.caption_nll(lp.reshape(N, *lp.shape[2:]),
                           t(w["seq"])[:, :, 1:].reshape(N, -1),
                           t(w["seq_mask"])[:, :, 1:].reshape(N, -1))
    want = jcap.caption_nll(jnp.asarray(lp.numpy()).reshape(N, *lp.shape[2:]),
                            jnp.asarray(w["seq"])[:, :, 1:].reshape(N, -1),
                            jnp.asarray(w["seq_mask"])[:, :, 1:].reshape(N, -1))
    close(got, want)
    close(got.reshape(-1, G), nll.numpy())


def test_hoisted_recurrence_matches_serial(world):
    """teacher_forced_nll hoists the token and query parts of the LSTM input
    out of the token chain; here the chain is rebuilt one `_step_core` (the
    decode path's concat + matmul) at a time."""
    w = world
    head = w["port"].caption_head[1]
    query, ref = head_inputs(w, 1)
    memory, mask, shapes, vr = common(w, t)
    seq, seq_mask = t(w["seq"]).long(), t(w["seq_mask"])
    with torch.no_grad():
        hoisted = head.teacher_forced_nll(t(query), t(ref), memory, mask,
                                          shapes, vr, seq, seq_mask)
        pref, value, lv = head._prepare(t(ref), vr, shapes, memory, mask)
        zeros = torch.zeros(*query.shape[:2], head.rnn_size)
        carry, hs = (zeros, zeros), []
        for step in range(seq.shape[2] - 1):
            carry, out = head._step_core(seq[:, :, step], carry, t(query),
                                         pref, value, lv)
            hs.append(out)
        lp = torch.log_softmax(head.logit(torch.stack(hs, dim=2)), dim=-1)
        N = lp.shape[0] * G
        serial = pcap.caption_nll(lp.reshape(N, *lp.shape[2:]),
                                  seq[:, :, 1:].reshape(N, -1),
                                  seq_mask[:, :, 1:].reshape(N, -1))
    close(hoisted, serial.reshape(-1, G).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layer", [0, 1])
def test_prepared_reference_both_ways(world, layer):
    w = world
    cfg = w["cfg"]
    query, ref = head_inputs(w, layer)
    vr = np.asarray(w["out"]["valid_ratios"])
    prepared = pcap.prepare_dsa_reference(
        t(ref), t(vr), w["shapes"], cfg.cap_num_feature_levels,
        cfg.cap_dec_n_points)
    close(prepared, jcap.prepare_dsa_reference(
        jnp.asarray(ref), jnp.asarray(vr), w["shapes"],
        cfg.cap_num_feature_levels, cfg.cap_dec_n_points))
    tail = (*common(w, t), t(w["seq"]), t(w["seq_mask"]))
    with torch.no_grad():
        plain = w["port"].caption_train_nll(layer, t(query), t(ref), *tail)
        pre = w["port"].caption_train_nll(layer, t(query), prepared, *tail,
                                          ref_prepared=True)
    np.testing.assert_array_equal(pre.numpy(), plain.numpy())
    want = w["nll"](w["params"], layer, jnp.asarray(query),
                    jnp.asarray(prepared.numpy()), *common(w, jnp.asarray),
                    jnp.asarray(w["seq"]), jnp.asarray(w["seq_mask"]),
                    ref_prepared=True)
    close(pre, want)


def test_train_mode_dropout_is_seeded_and_scheduled_sampling_refused(world):
    """Train-mode dropout repeats under the same seed and is off in eval
    mode. Scheduled sampling, refused until it was ported, runs in train
    mode: its logprobs repeat under the same seeds (its parity
    with the JAX package: tests/test_torch_train_options.py)."""
    w = world
    port = w["port"]
    query, ref = head_inputs(w, 1)
    args = (1, t(query), t(ref), *common(w, t), t(w["seq"]), t(w["seq_mask"]))
    with torch.no_grad():
        eval_nll = port.caption_train_nll(*args)
        port.train()
        try:
            torch.manual_seed(7)
            a = port.caption_train_nll(*args)
            torch.manual_seed(7)
            b = port.caption_train_nll(*args)
            ss = []
            for _ in range(2):
                torch.manual_seed(7)
                ss.append(port.caption_train(
                    *args[:-1], ss_prob=0.25,
                    generator=torch.Generator().manual_seed(3)))
        finally:
            port.eval()
        again = port.caption_train_nll(*args)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(ss[0].numpy(), ss[1].numpy())
    assert ss[0].shape[2] == w["seq"].shape[-1] - 1
    assert not np.allclose(a.numpy(), eval_nll.numpy())
    np.testing.assert_array_equal(again.numpy(), eval_nll.numpy())
