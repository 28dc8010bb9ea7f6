"""The port's contrastive criterion and grounding (gvl_tpu_torch.train
.criterion, gvl_tpu_torch.eval.postprocess) against the JAX package's, on
seeded numpy inputs: the cosine match matrix, the gated contrastive cost of
the matcher, `contrastive_loss` in every branch (cross-video negatives on and
off x the event-to-text direction on and off x the background average on and
off, with and without a row mask), the criterion with text embeddings, the
contrastive weight's schedule, and `grounding_outputs` with the Hungarian
solve and with maximum matching.

Tolerance: rtol 2e-4 / atol 2e-5 in f32, as the other criterion tests;
assignments and chosen events must be equal (the costs are tie-free).
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.eval import postprocess as jpp
from gvl_tpu.train import criterion as jc
from gvl_tpu_torch.eval import postprocess as ppp
from gvl_tpu_torch.train import criterion as pc
from tests.test_torch_criterion import rand_boxes, trunk_outputs

TOL = dict(rtol=2e-4, atol=2e-5)
B, NQ, G, D = 3, 8, 4, 16


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def embeds(seed=4):
    rs = np.random.RandomState(seed)
    text = rs.randn(B, G, D).astype(np.float32)
    event = rs.randn(B, NQ, D).astype(np.float32)
    bg = rs.randn(1, D).astype(np.float32)
    gt_mask = np.arange(G)[None, :] < np.array([G, 2, 1])[:, None]
    match_q = np.stack([rs.permutation(NQ)[:G] for _ in range(B)])
    match_q = np.where(gt_mask, match_q, 0)
    return text, event, bg, gt_mask, match_q


@pytest.mark.parametrize("with_bg", [False, True])
def test_cl_match_matrix_matches_jax(with_bg):
    text, event, bg, *_ = embeds()
    want = jc.cl_match_matrix(jnp.asarray(event), jnp.asarray(text),
                              jnp.asarray(bg) if with_bg else None)
    got = pc.cl_match_matrix(t(event), t(text), t(bg) if with_bg else None)
    assert got.shape == (B, NQ, G + with_bg)
    close(got, want)


@pytest.mark.parametrize("cl_gate", [0.0, 1.0])
def test_match_cost_with_contrastive_term_matches_jax(cl_gate):
    """set_cost_cl 2.0, the flagship's; gate 0 leaves the detection cost
    alone, gate 1 adds 2 x (-cosine)."""
    rng = np.random.RandomState(6)
    out, gt_boxes, gt_labels, gt_mask = trunk_outputs(rng, B=B, Nq=NQ, G=G)
    text, event, *_ = embeds()
    kw = dict(set_cost_class=2.0, set_cost_bbox=0.0, set_cost_giou=4.0,
              set_cost_cl=2.0)
    cl = jc.cl_match_matrix(jnp.asarray(event), jnp.asarray(text))
    want = jc.build_match_cost(
        jnp.asarray(out["pred_logits"][0]), jnp.asarray(out["pred_boxes"][0]),
        jnp.asarray(gt_boxes), jnp.asarray(gt_labels), jnp.asarray(gt_mask),
        cl, jc.LossSpec(**kw), cl_gate)
    got = pc.build_match_cost(
        t(out["pred_logits"][0]), t(out["pred_boxes"][0]), t(gt_boxes),
        t(gt_labels), t(gt_mask), pc.LossSpec(**kw), t(np.asarray(cl)),
        cl_gate)
    close(got, want)
    plain = pc.build_match_cost(
        t(out["pred_logits"][0]), t(out["pred_boxes"][0]), t(gt_boxes),
        t(gt_labels), t(gt_mask), pc.LossSpec(**kw))
    assert torch.equal(got, plain) == (cl_gate == 0.0)


BRANCHES = list(itertools.product([True, False], repeat=4))


@pytest.mark.parametrize("cross, e2t, bg, rows", BRANCHES, ids=[
    "-".join(n for n, on in zip(("cross", "e2t", "bg", "rowmask"), b) if on)
    or "plain" for b in BRANCHES])
def test_contrastive_loss_matches_jax(cross, e2t, bg, rows):
    """Every branch, value and gradients of both embeddings (and of the
    background embedding with e2t). The row mask drops the last video."""
    text, event, bg_embed, gt_mask, match_q = embeds()
    kw = dict(temperature=0.1, enable_cross_video_cl=cross, enable_e2t_cl=e2t,
              enable_bg_for_cl=bg)
    row_mask = np.array([1.0, 1.0, 0.0], np.float32) if rows else None
    gm = gt_mask & (row_mask > 0)[:, None] if rows else gt_mask

    def jloss(tx, ev, b):
        return jc.contrastive_loss(tx, ev, jnp.asarray(match_q),
                                   jnp.asarray(gm), jc.LossSpec(**kw), b,
                                   None if row_mask is None
                                   else jnp.asarray(row_mask))

    want, wgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(text), jnp.asarray(event), jnp.asarray(bg_embed))
    args = [t(text).requires_grad_(), t(event).requires_grad_(),
            t(bg_embed).requires_grad_()]
    got = pc.contrastive_loss(args[0], args[1], t(match_q), t(gm),
                              pc.LossSpec(**kw), args[2],
                              None if row_mask is None else t(row_mask))
    got.backward()
    close(got, want)
    assert float(got.detach()) > 0
    for a, w in zip(args, wgrads):
        close(a.grad if a.grad is not None else torch.zeros(a.shape), w)


def test_criterion_with_text_embeddings_matches_jax():
    """compute_criterion with a text embedding per layer (aux, final),
    set_cost_cl 2.0 at cl_gate 1 and 0, and a row mask: every loss,
    contrastive_loss and contrastive_loss_0 included, and the matches."""
    rng = np.random.RandomState(8)
    out, gt_boxes, gt_labels, gt_mask = trunk_outputs(rng, B=B, Nq=NQ, G=G)
    rs = np.random.RandomState(2)
    out["event_embed"] = rs.randn(2, B, NQ, D).astype(np.float32)
    texts = [rs.randn(B, G, D).astype(np.float32) for _ in range(2)]
    kw = dict(set_cost_class=2.0, set_cost_bbox=0.0, set_cost_giou=4.0,
              set_cost_cl=2.0)
    row = np.array([True, True, False])
    for gate in (1.0, 0.0):
        want, wq = jc.compute_criterion(
            {k: jnp.asarray(v) for k, v in out.items()},
            jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
            jnp.asarray(gt_mask), [jnp.asarray(x) for x in texts],
            jc.LossSpec(**kw), cl_gate=gate, row_mask=jnp.asarray(row))
        got, gq = pc.compute_criterion(
            {k: t(v) for k, v in out.items()}, t(gt_boxes), t(gt_labels),
            t(gt_mask), [t(x) for x in texts], pc.LossSpec(**kw),
            row_mask=t(row), cl_gate=gate)
        assert set(got) == set(want)
        assert {"contrastive_loss", "contrastive_loss_0"} <= set(got)
        np.testing.assert_array_equal(
            np.where(gt_mask & row[:, None], gq.numpy(), 0),
            np.where(gt_mask & row[:, None], np.asarray(wq), 0))
        for k in want:
            close(got[k], want[k])


def test_cl_weight_schedule_matches_jax():
    for times, vals in (([0, 2], [0, 0.1]), ([1, 3, 5], [0.2, 0.5, 1.0]),
                        ([], [])):
        cfg = types.SimpleNamespace(cl_schedule_time=times,
                                    cl_schedule_val=vals)
        for epoch in range(7):
            assert pc.cl_weight_at_epoch(cfg, epoch) == \
                jc.cl_weight_at_epoch(cfg, epoch)


def grounding_inputs(seed=12):
    rs = np.random.RandomState(seed)
    out = dict(pred_logits=rs.randn(2, B, NQ, 1).astype(np.float32),
               pred_boxes=np.stack([rand_boxes(rs, B, NQ) for _ in range(2)]),
               event_embed=rs.randn(2, B, NQ, D).astype(np.float32))
    text = rs.randn(B, G, D).astype(np.float32)
    durations = rs.uniform(10, 100, (B,)).astype(np.float32)
    gt_mask = np.arange(G)[None, :] < np.array([G, 2, 0])[:, None]
    return out, text, durations, gt_mask


@pytest.mark.parametrize("maximum_matching, cost_class, layer", [
    (False, 0.0, -1), (False, 1.0, -2), (True, 0.0, -1), (True, 1.0, -2)])
def test_grounding_outputs_match_jax(maximum_matching, cost_class, layer):
    """Boxes in seconds, confidences and cl_scores per sentence, with a
    video of 2 sentences and one of none (its columns take their argmin);
    the Hungarian solve gives distinct events to a video's sentences."""
    out, text, durations, gt_mask = grounding_inputs()
    kw = dict(cost_cl=1.0, cost_class=cost_class,
              maximum_matching=maximum_matching)
    want = jpp.grounding_outputs(
        dict({k: jnp.asarray(v) for k, v in out.items()},
             _grounding_text=jnp.asarray(text)),
        jnp.asarray(durations), jnp.asarray(gt_mask),
        jpp.GroundingSpec(**kw), layer)
    got = ppp.grounding_outputs({k: t(v) for k, v in out.items()}, t(text),
                                t(durations), t(gt_mask),
                                ppp.GroundingSpec(**kw), layer)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    if not maximum_matching:
        assert len({tuple(b) for b in got["boxes"][0].tolist()}) == G


def test_grounding_spec_reads_the_config():
    from gvl_tpu.config import Config
    cfg = Config()
    cfg.update(dict(eval_set_cost_cl=1.0, eval_set_cost_class=0.0,
                    eval_enable_maximum_matching_for_grounding=True,
                    eval_grounding_cost_alpha=0.3))
    got = ppp.GroundingSpec.from_config(cfg)
    assert got == ppp.GroundingSpec(cost_cl=1.0, cost_class=0.0, alpha=0.3,
                                    maximum_matching=True)
    assert ppp.GroundingSpec.from_config(types.SimpleNamespace()) == \
        ppp.GroundingSpec()
