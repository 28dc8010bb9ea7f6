"""The port's matcher and detection losses (gvl_tpu_torch.train.criterion,
.lap, utils.boxes) against the JAX package's, on seeded numpy inputs.

Tolerance: rtol 2e-4 / atol 2e-5 in f32 for losses and box ops; assignments
must be equal on tie-free costs and of equal total cost with ties.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.train import criterion as jc
from gvl_tpu.train import lap as jlap
from gvl_tpu.utils import boxes as jboxes
from gvl_tpu_torch.train import criterion as pc
from gvl_tpu_torch.train.lap import batched_lap
from gvl_tpu_torch.utils import boxes as pboxes
from tests.test_torch_train_loop import computed_once

TOL = dict(rtol=2e-4, atol=2e-5)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def rand_boxes(rng, *shape):
    """(center, length) boxes whose start/end stay ordered."""
    return np.stack([rng.uniform(0.2, 0.8, shape),
                     rng.uniform(0.05, 0.4, shape)], -1).astype(np.float32)


# ------------------------------------------------------------------- boxes

@pytest.mark.parametrize("name", ["box_cl_to_xy", "box_xy_to_cl"])
def test_box_layout_ops_match_jax(rng, name):
    x = rand_boxes(rng, 3, 5)
    close(getattr(pboxes, name)(t(x)), getattr(jboxes, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["pairwise_iou", "pairwise_giou",
                                  "elementwise_iou", "elementwise_giou"])
def test_box_overlap_ops_match_jax(rng, name):
    a = jboxes.box_cl_to_xy(jnp.asarray(rand_boxes(rng, 3, 5)))
    n2 = 5 if name.startswith("elementwise") else 4
    b = jboxes.box_cl_to_xy(jnp.asarray(rand_boxes(rng, 3, n2)))
    want = getattr(jboxes, name)(a, b)
    got = getattr(pboxes, name)(t(a), t(b))
    if name == "pairwise_iou":
        for g, w in zip(got, want):
            close(g, w)
    else:
        close(got, want)


# --------------------------------------------------------------------- lap

def lap_world(rng, N=6, R=8, C=5, ties=False):
    cost = rng.randn(N, R, C).astype(np.float32)
    if ties:
        cost = np.round(cost * 2) / 2       # many equal entries
    sizes = rng.randint(0, C + 1, N)
    sizes[0], sizes[1] = C, 0               # a full and an empty problem
    valid = np.arange(C)[None, :] < sizes[:, None]
    cost = np.where(valid[:, None, :], cost, 0.0).astype(np.float32)
    return cost, valid


def test_batched_lap_matches_jax_on_tie_free_costs(rng):
    cost, valid = lap_world(rng)
    want = np.asarray(jlap.batched_lap(jnp.asarray(cost), jnp.asarray(valid)))
    got = batched_lap(t(cost), t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all() and (got[valid] >= 0).all()


def test_batched_lap_without_mask_matches_jax(rng):
    cost, _ = lap_world(rng)
    want = np.asarray(jlap.batched_lap(jnp.asarray(cost)))
    np.testing.assert_array_equal(batched_lap(t(cost)).numpy(), want)


def test_batched_lap_with_ties_has_the_jax_total_cost(rng):
    cost, valid = lap_world(rng, ties=True)
    want = np.asarray(jlap.batched_lap(jnp.asarray(cost), jnp.asarray(valid)))
    got = batched_lap(t(cost), t(valid)).numpy()
    for n in range(len(cost)):
        cols = np.nonzero(valid[n])[0]
        assert len(set(got[n, cols])) == len(cols)       # one-to-one
        np.testing.assert_allclose(cost[n, got[n, cols], cols].sum(),
                                   cost[n, want[n, cols], cols].sum(),
                                   rtol=1e-6, atol=1e-6)


def test_batched_lap_refuses_more_columns_than_rows_and_holes(rng):
    """More valid columns than rows is refused; columns masked out anywhere
    (holes, as the SCST matcher's tiled GT mask has) are left out of the
    solve as the JAX solver leaves them, on tie-free costs."""
    with pytest.raises(ValueError, match="cols <= rows"):
        batched_lap(torch.zeros(1, 2, 3))
    with pytest.raises(ValueError, match="cols <= rows"):
        batched_lap(torch.zeros(1, 2, 4),
                    torch.tensor([[True, False, True, True]]))
    cost = rng.standard_normal((3, 7, 6)).astype(np.float32)
    holes = np.array([[True, False, True] * 2, [False, True] * 3,
                      [True] * 5 + [False]])
    want = np.asarray(jlap.batched_lap(jnp.asarray(cost), jnp.asarray(holes)))
    got = batched_lap(t(cost), t(holes)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~holes] == -1).all() and (got[holes] >= 0).all()


# ------------------------------------------------------------------ losses

def trunk_outputs(rng, Ld=2, B=3, Nq=8, G=4, K=1, E1=7):
    out = dict(
        pred_logits=rng.randn(Ld, B, Nq, K).astype(np.float32),
        pred_boxes=np.stack([rand_boxes(rng, B, Nq) for _ in range(Ld)]),
        pred_count=rng.randn(Ld, B, E1).astype(np.float32))
    gt_boxes = rand_boxes(rng, B, G)
    gt_labels = np.zeros((B, G), np.int32)
    gt_mask = np.arange(G)[None, :] < np.array([G, 2, 1])[:, None]
    return out, gt_boxes, gt_labels, gt_mask


SPEC_KW = dict(set_cost_class=2.0, set_cost_bbox=0.5, set_cost_giou=4.0)


@pytest.fixture(scope="module")
def crit(tmp_path_factory):
    """Computed once per test run (computed_once)."""
    return computed_once(tmp_path_factory, "torch_criterion_crit",
                         compute_crit)


def compute_crit():
    rng = np.random.RandomState(3)
    out, gt_boxes, gt_labels, gt_mask = trunk_outputs(rng)
    jspec, pspec = jc.LossSpec(**SPEC_KW), pc.LossSpec(**SPEC_KW)
    args = (gt_boxes, gt_labels, gt_mask)
    want = jc.compute_criterion({k: jnp.asarray(v) for k, v in out.items()},
                                *map(jnp.asarray, args), None, jspec)
    got = pc.compute_criterion({k: t(v) for k, v in out.items()},
                               *map(t, args), None, pspec)
    return (out, args, jspec, pspec, jax.tree_util.tree_map(np.asarray, want),
            got)


def test_loss_spec_from_config_reads_the_jax_config():
    from gvl_tpu.config import Config
    cfg = Config()
    cfg.update(dict(set_cost_class=2.0, set_cost_giou=4.0, set_cost_bbox=0.0,
                    matcher_impl="scipy"))
    want, got = jc.LossSpec.from_config(cfg), pc.LossSpec.from_config(cfg)
    for f in pc.LossSpec.__dataclass_fields__:
        assert getattr(got, f) == getattr(want, f), f
    assert pc.LossSpec.from_config(types.SimpleNamespace()) == pc.LossSpec()


def test_match_cost_matches_jax(crit):
    out, (gt_boxes, gt_labels, gt_mask), jspec, pspec, _, _ = crit
    want = jc.build_match_cost(
        jnp.asarray(out["pred_logits"][0]), jnp.asarray(out["pred_boxes"][0]),
        jnp.asarray(gt_boxes), jnp.asarray(gt_labels), jnp.asarray(gt_mask),
        None, jspec)
    got = pc.build_match_cost(t(out["pred_logits"][0]), t(out["pred_boxes"][0]),
                              t(gt_boxes), t(gt_labels), t(gt_mask), pspec)
    close(got, want)


@pytest.mark.parametrize("impl", ["jax", "scipy"])
def test_match_layer_matches_jax(crit, impl):
    out, (gt_boxes, gt_labels, gt_mask), jspec, pspec, _, _ = crit
    cost = pc.build_match_cost(t(out["pred_logits"][1]), t(out["pred_boxes"][1]),
                               t(gt_boxes), t(gt_labels), t(gt_mask), pspec)
    want = jc.match_layer(jnp.asarray(cost.numpy()), jnp.asarray(gt_mask), impl)
    got = pc.match_layer(cost, t(gt_mask), impl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_criterion_matches_and_keys(crit):
    *_, (want, want_mq), (got, got_mq) = crit
    np.testing.assert_array_equal(got_mq.numpy(), np.asarray(want_mq))
    assert set(got) == set(want)
    assert {"loss_ce", "loss_counter", "loss_bbox", "loss_giou",
            "loss_self_iou", "cardinality_error", "loss_ce_0"} <= set(got)


@pytest.mark.parametrize("key", [
    f"{k}{s}" for k in ("loss_ce", "loss_counter", "loss_bbox", "loss_giou",
                        "loss_self_iou", "cardinality_error")
    for s in ("", "_0")])
def test_criterion_loss_matches_jax(crit, key):
    *_, (want, _), (got, _) = crit
    close(got[key], want[key])


def test_criterion_row_mask_matches_jax(crit):
    out, args, jspec, pspec, _, _ = crit
    row = np.array([True, False, True])
    want, _ = jc.compute_criterion(
        {k: jnp.asarray(v) for k, v in out.items()}, *map(jnp.asarray, args),
        None, jspec, row_mask=jnp.asarray(row))
    got, _ = pc.compute_criterion({k: t(v) for k, v in out.items()},
                                  *map(t, args), None, pspec, row_mask=t(row))
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("alpha,gau", [(0.25, 1), (-1.0, 0)])
def test_focal_and_counter_options_match_jax(rng, alpha, gau):
    logits = rng.randn(3, 8, 2).astype(np.float32)
    targets = (rng.rand(3, 8, 2) < 0.3).astype(np.float32)
    close(pc.sigmoid_focal_loss_sum(t(logits), t(targets), alpha, 2.0),
          jc.sigmoid_focal_loss_sum(jnp.asarray(logits), jnp.asarray(targets),
                                    alpha, 2.0), rtol=2e-4, atol=1e-4)
    count = rng.randn(3, 7).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 2, 0])[:, None]
    close(pc.counter_loss(t(count), t(mask), pc.LossSpec(lloss_gau_mask=gau)),
          jc.counter_loss(jnp.asarray(count), jnp.asarray(mask),
                          jc.LossSpec(lloss_gau_mask=gau)))


def test_weight_dict_matches_jax():
    from gvl_tpu.config import Config
    cfg = Config()
    cfg.update(dict(dec_layers=3, caption_loss_coef=2.0, count_loss_coef=0.5))
    assert pc.make_weight_dict(cfg) == jc.make_weight_dict(cfg)
    cfg.aux_loss = False
    assert pc.make_weight_dict(cfg) == jc.make_weight_dict(cfg)


def caption_cost_world(crit, weight):
    """Both criteria given the same per-layer (B, Nq, G) caption costs at
    set_cost_caption `weight`: (JAX losses and matches, the port's)."""
    out, args, jspec, pspec, _, _ = crit
    B, Nq = out["pred_logits"].shape[1:3]
    G = args[2].shape[1]
    rs = np.random.RandomState(8)
    caps = [rs.uniform(0.5, 6.0, (B, Nq, G)).astype(np.float32)
            for _ in range(out["pred_logits"].shape[0])]
    jspec = dataclasses.replace(jspec, set_cost_caption=weight)
    pspec = dataclasses.replace(pspec, set_cost_caption=weight)
    want = jc.compute_criterion(
        {k: jnp.asarray(v) for k, v in out.items()},
        *map(jnp.asarray, args), None, jspec,
        cap_costs=[jnp.asarray(c) for c in caps])
    got = pc.compute_criterion({k: t(v) for k, v in out.items()},
                               *map(t, args), None, pspec,
                               cap_costs=[t(c) for c in caps])
    return want, got


@pytest.mark.parametrize("name", ["set_cost_caption"])
def test_unported_criterion_parts_raise_by_name(crit, name):
    """The caption cost, refused by name until it was ported: given caption
    costs at set_cost_caption 3 (large enough to move the assignment), the
    matches equal the JAX package's and every loss, loss_caption of each
    layer among them, is within the module's tolerance."""
    (jl, jq), (pl, pq) = caption_cost_world(crit, 3.0)
    _, _, _, _, (_, q0), _ = crit
    assert not np.array_equal(np.asarray(jq), np.asarray(q0))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    assert set(pl) == set(jl)
    assert {"loss_caption", "loss_caption_0"} <= set(pl)
    for k in jl:
        close(pl[k], jl[k])


def test_criterion_refuses_text_embeds_and_caption_costs(crit):
    """Text embeddings are refused without event embeddings. Caption costs
    at set_cost_caption 0 leave the matching alone and still give the
    caption loss of the matched entries, as in the JAX package."""
    out, args, _, pspec, _, _ = crit
    outs = {k: t(v) for k, v in out.items()}
    # text embeddings need the trunk's event embeddings (contrastive on)
    with pytest.raises(ValueError, match="event_embed"):
        pc.compute_criterion(outs, *map(t, args), [None, None], pspec)
    (jl, jq), (pl, pq) = caption_cost_world(crit, 0.0)
    np.testing.assert_array_equal(pq.numpy(), crit[5][1].numpy())
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    for k in ("loss_caption", "loss_caption_0"):
        close(pl[k], jl[k])
