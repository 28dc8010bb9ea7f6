"""Sequence parallelism of the port (gvl_tpu_torch/ops/ms_deform_attn_sp.py,
gvl_tpu_torch/parallel/sp.py and their callers) against the JAX package.

- The op, one for one against tests/test_msda_sp.py's cases (its worlds,
  its tolerances): the port's pure local functions driven for both sp
  indices in one process (the neighbours' halos cut from the global value,
  as the all_gather hands them over) against JAX's `ms_deform_attn_1d_sp`
  on the 8-device CPU mesh (dp 4 x sp 2, impl 'ref'): outputs at rtol 2e-5
  / atol 2e-6, the gradients of value, loc and attn at rtol 5e-4 / atol
  1e-5, the clamp count (0 on local offsets; JAX's count on drifted ones,
  the outputs then JAX's sp outputs, not dp's; 0 in decoder mode), and the
  fallbacks at sp 1.
- The host side of the from-taps forms of kernels 1 and 2 (what their
  wrapper refuses, their launch plan); their kernels are held against
  `weighted_tap_sum` and `taps_grads` on the card (chip_smoke.py phase 30).
- The 2 dp x 2 sp gloo world (tests/torch_parallel_world.py `SP_RANKS`,
  computed once per test run and ahead under xdist): the trunk under an sp
  context against JAX's (tests/test_msda_sp.py:129-165, 206-241, at its
  trunk tolerance 5e-4 / 5e-5), the contrastive step's losses, gradients
  and weights against the one-process port and JAX's one-device step, the
  step under remat and without a context (sp_msda off), the train loop and
  its validation against one process.
"""

import functools
import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gvl_tpu.ops.ms_deform_attn import ms_deform_attn_1d as jax_msda
from gvl_tpu.ops.ms_deform_attn_sp import ms_deform_attn_1d_sp as jax_sp
from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from gvl_tpu_torch.ops import ms_deform_attn as pmsda
from gvl_tpu_torch.ops.ms_deform_attn_sp import (chunk_rows, gather_levels,
                                                 ms_deform_attn_1d_sp, plan,
                                                 replicated_local,
                                                 tokens_local)
from gvl_tpu_torch.parallel.mesh import World
from gvl_tpu_torch.parallel.sp import (SpContext, get_sp_context,
                                       set_sp_context, sp_context)
from tests import torch_parallel_world as tw
from tests.test_msda_sp import SHAPES, _decoder_world, _encoder_world, _mesh
from tests.test_torch_train_loop import adam_bound, loop_cfg, once_per_test_run

SP = 2
OUT_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _chunks(value, sidx):
    """sp rank sidx's chunks of a global value (level padding zeroed)."""
    rows, real = chunk_rows(SHAPES, SP, sidx)
    return value[:, rows] * real[None, :, None, None]


def port_tokens(value, loc, attn, halo_frac, count=False):
    """Encoder mode over both sp ranks in one process: (B, S, H*Dh) and the
    summed clamp count."""
    _, chunks, halos = plan(SHAPES, SP, halo_frac)
    outs, n = [], 0
    for sidx in range(SP):
        before = _chunks(value, (sidx - 1) % SP)
        after = _chunks(value, (sidx + 1) % SP)
        left, right, q0 = [], [], 0
        for chunk, hl in zip(chunks, halos):
            left.append(before[:, q0 + chunk - hl:q0 + chunk])
            right.append(after[:, q0:q0 + hl])
            q0 += chunk
        rows, _ = chunk_rows(SHAPES, SP, sidx)
        out, c = tokens_local(sidx, SP, SHAPES, halo_frac,
                              _chunks(value, sidx), left, right,
                              loc[:, rows], attn[:, rows], count=count)
        outs.append(out)
        n += int(c) if count else 0
    return gather_levels(torch.stack(outs), SHAPES, SP), n


def port_replicated(value, loc, attn):
    return sum(replicated_local(s, SP, SHAPES, _chunks(value, s), loc, attn)
               for s in range(SP))


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("halo_frac", "count"))
def jax_run(mode, value, loc, attn, halo_frac=0.25, count=True):
    """JAX's sp op (its count beside its output by default: one compile
    serves the cases of a mode)."""
    return jax_sp(value, SHAPES, loc, attn, mesh=_mesh(), queries=mode,
                  halo_frac=halo_frac, impl="ref", return_clamp_count=count)


# ------------------------------------------------------------------ the op

def test_encoder_mode_matches_jax(rng):
    value, loc, attn = _encoder_world(rng)
    want, _ = jax_run("tokens", value, loc, attn)
    got, _ = port_tokens(_t(value), _t(loc), _t(attn), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_decoder_mode_matches_jax(rng):
    value, loc, attn = _decoder_world(rng)
    want, _ = jax_run("replicated", value, loc, attn)
    got = port_replicated(_t(value), _t(loc), _t(attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("mode", ["tokens", "replicated"])
def test_sp_gradients_match_jax(rng, mode):
    world = _encoder_world if mode == "tokens" else _decoder_world
    value, loc, attn = world(rng)

    def loss_sp(v, l, a):
        out = jax_run(mode, v, l, a, count=False)
        return (out * out).sum()

    want = jax.jit(jax.grad(loss_sp, argnums=(0, 1, 2)))(value, loc, attn)
    args = [_t(x).requires_grad_() for x in (value, loc, attn)]
    if mode == "tokens":
        out, _ = port_tokens(*args, 0.25)
    else:
        out = port_replicated(*args)
    (out * out).sum().backward()
    for a, w, name in zip(args, want, ["value", "loc", "attn"]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_clamp_counter_zero_when_local(rng):
    value, loc, attn = _encoder_world(rng)
    want, n_jax = jax_run("tokens", value, loc, attn)
    got, n = port_tokens(_t(value), _t(loc), _t(attn), 0.25, count=True)
    assert n == int(n_jax) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    dense = jax_msda(value, SHAPES, loc, attn, impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), **OUT_TOL)


def test_clamp_counter_counts_drifted_offsets_as_jax(rng):
    """Taps pushed half a level away: the port moves and counts the same
    taps as JAX (> 0), and its outputs are JAX's sp outputs, which differ
    from the dense op's."""
    value, loc, attn = _encoder_world(rng)
    loc = jnp.clip(loc + 0.5, 0.0, 1.0)
    want, n_jax = jax_run("tokens", value, loc, attn)
    got, n = port_tokens(_t(value), _t(loc), _t(attn), 0.25, count=True)
    assert n == int(n_jax) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    dense = jax_msda(value, SHAPES, loc, attn, impl="ref")
    assert not np.allclose(got.numpy(), np.asarray(dense), atol=1e-3)


def test_clamp_counter_decoder_always_zero(rng):
    """The decoder mode moves no tap: the op reports a count of 0 at sp 1
    and on every rank of a world (the context's monitor on)."""
    value, loc, attn = _decoder_world(rng)
    _, n_jax = jax_run("replicated", value, loc, attn)
    assert int(n_jax) == 0
    ctx = SpContext(World(), clamp_monitor=True)
    _, n = ms_deform_attn_1d_sp(_t(value), SHAPES, _t(loc), _t(attn), ctx,
                                queries="replicated")
    assert int(n) == 0


def test_sp1_falls_back(rng):
    """A world without an sp axis sets no context (JAX's test_sp1_falls_
    back); a context of sp 1 runs ms_deform_attn_1d on the whole levels."""
    assert set_sp_context(World()) is None and get_sp_context() is None
    assert set_sp_context(None) is None
    with sp_context(World(), halo_frac=0.5) as ctx:
        assert ctx is None and get_sp_context() is None
    value, loc, attn = (_t(x) for x in _decoder_world(rng))
    want = pmsda.ms_deform_attn_1d(value, SHAPES, loc, attn)
    for mode in ("tokens", "replicated"):
        got, n = ms_deform_attn_1d_sp(value, SHAPES, loc, attn,
                                      SpContext(World()), queries=mode)
        assert torch.equal(got, want) and n is None


def test_plan_and_chunks_are_jax_layout():
    """JAX's _plan at the long-video pyramid and sp 2 (chunks 400/200/100/
    50, halos 100/50/25/13: S_loc 1126); odd levels pad at their end."""
    from gvl_tpu.ops.ms_deform_attn_sp import _plan
    for shapes, frac in (((800, 400, 200, 100), 0.125), (SHAPES, 0.25),
                         ((25, 13, 7), 0.02), ((25, 13, 7), 0.5)):
        assert plan(shapes, SP, frac) == tuple(
            tuple(x) for x in _plan(shapes, SP, frac))
    _, chunks, halos = plan((800, 400, 200, 100), 2, 0.125)
    assert chunks == (400, 200, 100, 50) and halos == (100, 50, 25, 13)
    assert sum(c + 2 * h for c, h in zip(chunks, halos)) == 1126
    rows, real = chunk_rows((5, 3), 2, 1)
    assert rows.tolist() == [3, 4, 4, 7, 7] and \
        real.tolist() == [True, True, False, True, False]
    blocks = torch.stack([torch.arange(5) + 10 * s for s in range(2)])
    assert gather_levels(blocks[:, None], (5, 3), 2)[0].tolist() == \
        [0, 1, 2, 10, 11, 3, 4, 13]


# -------------------------------------------------- the from-taps forms' host

def _taps(B=2, S=40, Lq=6, H=2, L=2, P=3, Dh=8):
    g = torch.Generator().manual_seed(0)
    value = torch.randn(B, S, H, Dh, generator=g)
    g0 = torch.randint(0, S, (B, Lq, H, L, P), generator=g, dtype=torch.int32)
    g1 = torch.randint(0, S, (B, Lq, H, L, P), generator=g, dtype=torch.int32)
    w0, w1 = (torch.rand(B, Lq, H, L, P, generator=g) for _ in range(2))
    return value, g0, g1, w0, w1


def test_from_taps_plain_version_and_its_gradients():
    """On the CPU the from-taps op is weighted_tap_sum under autograd; its
    gradients are taps_grads's (index_add_ for value, the per-tap dots for
    the weights), which the card's kernel 2 form is held to; the dense op's
    tap_grads is taps_grads over the lerp-folded weights."""
    value, g0, g1, w0, w1 = _taps()
    v, a, b = (x.clone().requires_grad_() for x in (value, w0, w1))
    out = pmsda.ms_deform_attn_from_taps(v, g0, g1, a, b)
    assert torch.equal(out.detach(), pmsda.weighted_tap_sum(
        value, g0.long(), g1.long(), w0, w1))
    go = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    out.backward(go)
    gv, d0, d1 = pmsda.taps_grads(go, value, g0.long(), g1.long(), w0, w1)
    for got, want in ((v.grad, gv), (a.grad, d0), (b.grad, d1)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert pmsda.ms_deform_attn_1d.taps_launches == 0


def test_from_taps_wrapper_refuses_what_the_kernels_do_not_take():
    """The checks run before any launch (a CPU tensor is refused by
    name, so every case reaches its own message first). A row outside
    [0, S) is the kernels' own check, on the card (GivenTaps)."""
    value, g0, g1, w0, w1 = _taps()
    cases = [
        ((value, g0, g1, w0[:, :-1], w1), ValueError, "want value"),
        ((value[:, :, :1], g0, g1, w0, w1), ValueError, "do not match"),
        ((value[..., :6], g0, g1, w0, w1), ValueError, "head width 6"),
        ((value, g0, g1, w0, w1), ValueError, "value is on cpu"),
    ]
    for args, exc, msg in cases:
        with pytest.raises(exc, match=msg):
            pmsda.check_taps_inputs(*args)
    big = torch.zeros(1, 1, 1, 2, 300, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 512"):
        pmsda.check_taps_inputs(value[:1, :, :1], big, big, big.float(),
                                big.float())



def test_from_taps_launch_plan_is_kernel_twos():
    """The from-taps backward takes kernel 2's plan at the sp path's
    shapes: the long-video encoder's local (S_loc 1126, Lq 750) and its
    decoder's (chunks of 750, Lq 100), B = 2 per dp rank."""
    for S, Lq in ((1126, 750), (750, 100)):
        p = pmsda.bwd_plan(2, S, 8, 64, Lq, 16)
        assert p.rows <= pmsda.BWD_RANGE_ROWS and p.chunk >= 1
        assert p.shared <= pmsda.MAX_SHARED_BYTES
        assert p.value_blocks == 2 * 8 * -(-S // pmsda.BWD_RANGE_ROWS)
        assert p.dot_blocks == -(-2 * Lq * 8 // pmsda.BWD_DOT_WARPS)


# ------------------------------------------------------- the 2 x 2 gloo world

def write_sp_cli_inputs(root: pathlib.Path) -> dict:
    """train_cli's inputs: the tiny loop config over 12 synthetic videos in
    global batches of 4 (3 debug steps) and a validation in batches of 4,
    mesh_shape 'dp,sp' at sp_halo_frac SP_HALO; 160 frames, so that the
    default halo of the validation (JAX's run_validation sets its eval
    context at 0.125) spans 5 rows of every level, past the initial
    offsets' reach of 4. The ranks' (sp_inputs.pt) and the one-process
    reference's (returned)."""
    data = make_synthetic_dataset(str(root / "data"), num_videos=12,
                                  feat_dim=16)
    base = dict(loop_cfg(root, data), id="sp_run", epoch=1, batch_size=4,
                eval_batch_size=4, min_epoch_when_save=0,
                frame_embedding_num=160, mesh_shape="dp,sp",
                sp_halo_frac=tw.SP_HALO)
    inputs = {}
    for which in ("sp", "ref"):
        cfg = dict(base, save_dir=str(root / f"{which}_save"))
        yml = root / f"{which}.yml"
        yml.write_text(yaml.safe_dump(cfg))
        inputs[which] = dict(cfg=cfg, yml=str(yml))
    torch.save(dict(train=inputs["sp"]), root / "sp_inputs.pt")
    return inputs["ref"]


def jax_trunk_refs(model, params, db) -> dict:
    """JAX's trunk under sp_context, its clamp monitor on, on the dp 2 x
    sp 2 CPU mesh at each of SP_TRUNK_HALOS: (logits, boxes, memory, the
    sum of its sown clamp counts) (tests/test_msda_sp.py:129-165,
    206-241)."""
    from gvl_tpu.parallel import replicate_tree, shard_batch
    from gvl_tpu.parallel.mesh import make_mesh
    from gvl_tpu.parallel.sp import sp_context as jax_sp_context
    mesh = make_mesh(4, "dp,sp")
    params_r = replicate_tree(params, mesh)
    db_s = shard_batch({k: np.asarray(db[k]) for k in
                        ("video_feats", "video_mask", "duration")}, mesh)
    args = (params_r, db_s["video_feats"], db_s["video_mask"],
            db_s["duration"])
    refs = {}
    for h in tw.SP_TRUNK_HALOS:
        def trunk(p, f, m, d):
            out, dbg = model.apply(p, f, m, d, mutable=["sp_debug"])
            return (out["pred_logits"], out["pred_boxes"], out["memory"],
                    jax.tree_util.tree_leaves(dbg))
        with jax_sp_context(mesh, halo_frac=h, clamp_monitor=True):
            *outs, leaves = jax.jit(trunk)(*args)
        refs[h] = [np.asarray(x) for x in outs] + [
            sum(int(x) for x in leaves)]
    return refs


def compute_sp(root: pathlib.Path) -> None:
    """Spawn the 2 x 2 ranks on their CLI inputs, then write the step
    cases' inputs (the contrastive world's initial weights, its JAX init)
    and, while the ranks run, JAX's trunk references and the one-process
    train_cli run."""
    from tests.test_torch_contrastive_train import initial, port_initial
    from tests.test_torch_train_step import LOSS_SIDE
    ref_inputs = write_sp_cli_inputs(root)
    ctx = tw.start_world(root, sp=True)
    try:
        cfg, bundle, model, batch, _, db, params = initial(**LOSS_SIDE)
        port, text, pbatch = port_initial(cfg, bundle, params, batch)
        torch.save(dict(contrastive=dict(
            cfg=cfg.to_dict(), port0=port.state_dict(),
            text=text.state_dict(), batch=pbatch)),
            root / "sp_step_inputs.tmp")
        (root / "sp_step_inputs.tmp").rename(root / "sp_step_inputs.pt")
        ref = dict(trunk=jax_trunk_refs(model, params, db))
        with tw.no_tensorboard():
            ref["train"] = tw.train_run(ref_inputs, root / "sp_ref")
        torch.save(ref, root / "sp_ref.pt")
    except BaseException:
        tw.kill_world(ctx)
        raise
    tw.join_world(ctx)


def load_sp(root: pathlib.Path) -> dict:
    return dict(ranks=[torch.load(root / f"sp_rank{r}.pt",
                                  weights_only=False)
                       for r in range(tw.SP_RANKS)],
                ref=torch.load(root / "sp_ref.pt", weights_only=False))


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory):
    return once_per_test_run(tmp_path_factory, "torch_sp_world", compute_sp,
                             load_sp)


@pytest.fixture(scope="module")
def contrastive_world(tmp_path_factory):
    """tests/test_torch_contrastive_train.py's world: JAX's one-device
    steps and the one-process port's on the global batch."""
    from tests.test_torch_contrastive_train import compute_world
    root = once_per_test_run(tmp_path_factory, "torch_contrastive_world",
                             compute_world, lambda root: root)
    return torch.load(root / "world.pt", weights_only=False)


def test_a_world_of_four_splits_into_two_dp_by_two_sp(sp_world):
    """Asked for 'dp' the 4 ranks stay plain dp; asked for 'dp,sp' rank r
    is JAX's device r of reshape(2, 2): dp index r // 2, sp index r % 2.
    The rows, the dp gather and global_sum follow the dp index (each row
    counted once), gather_sp and sum_sp the sp group; asked again, the
    world stays as it is."""
    for r, res in enumerate(sp_world["ranks"]):
        m = res["mesh"]
        d, s = divmod(r, 2)
        assert m["plain"] == (4, 1)
        assert m["indices"] == (d, 2, s, 2) and m["again"]
        assert m["rows"] == slice(4 * d, 4 * d + 4)
        assert m["dp_gather"].tolist() == [float(s), float(s + 2)]
        assert m["sp_gather"].tolist() == [[2.0 * d], [2.0 * d + 1]]
        assert m["sp_sum"].tolist() == [4.0 * d + 1]
        assert m["count"] == 2
        assert f"dp {d}/2, sp {s}/2" in m["repr"]


@pytest.mark.parametrize("halo", tw.SP_TRUNK_HALOS)
def test_trunk_under_sp_matches_jax(sp_world, halo):
    """The trunk's logits, boxes and memory on each rank's dp row against
    JAX's trunk under sp_context on its dp 2 x sp 2 mesh, at JAX's trunk
    tolerance (rtol 5e-4, atol 5e-5): at 0.5 no tap is clamped; at the
    default 0.125 the 24-frame levels' halos (3, 2, 2 rows) clamp the
    initial offsets' taps as JAX's do."""
    want = sp_world["ref"]["trunk"][halo]
    for r, res in enumerate(sp_world["ranks"]):
        d = r // 2
        for got, w, name in zip(res["trunk"][halo][:3], want[:3],
                                ("logits", "boxes", "memory")):
            w = w[:, d:d + 1] if name != "memory" else w[d:d + 1]
            np.testing.assert_allclose(got.numpy(), w, rtol=5e-4, atol=5e-5,
                                       err_msg=name)


def test_clamp_monitor_through_the_trunk_counts_as_jax(sp_world):
    """The taps the halo clamp moved, summed over the world: JAX's count
    on the tiny levels at the default halo (0.125: > 0) and 0 at the full
    one (0.5)."""
    ref = sp_world["ref"]["trunk"]
    assert ref[0.125][3] > 0 and ref[0.5][3] == 0
    for res in sp_world["ranks"]:
        assert res["trunk"][0.125][3] == ref[0.125][3]
        assert res["trunk"][0.5][3] == 0


def test_sp_contrastive_step_matches_one_process_and_jax(sp_world,
                                                         contrastive_world):
    """The contrastive world (B = 2: one video a dp rank, its frames over
    2 sp ranks) at halo 0.5 (the clamp counter reads 0 each step): the
    ranks agree bit for bit; against the one-process port, 5 steps' losses
    within 1e-5 (relative), the first step's gradients within 1e-5 of each
    tensor's max abs + 1e-7 (a softmax-invariant bias's gradient is 0 but
    for rounding, ~1e-9, and its terms are summed in another order over
    the chunks), the weights after the steps within the distance two
    Adam trajectories can part (`adam_bound`) and 99% of their entries
    within 1e-4 x lr; against JAX's one-device step, the tolerances of
    tests/test_torch_contrastive_train.py (first step rtol 2e-4 / atol
    2e-5, the total's trajectory rtol 1e-3, gradients 1e-3 x max abs +
    1e-7)."""
    cw = contrastive_world
    ranks = [r["contrastive"] for r in sp_world["ranks"]]
    for got in ranks[1:]:
        assert got["losses"] == ranks[0]["losses"]
        for name, g in got["grads"].items():
            assert torch.equal(g, ranks[0]["grads"][name]), name
    lr = PConfig().update(dict(cw["cfg"])).lr
    for got in ranks:
        assert got["rows"] == 1 and got["clamped"] == [0] * tw.N_STEPS
        for g, w in zip(got["losses"], cw["port_losses"]):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-9,
                                           err_msg=k)
        for name, w in cw["port_grads"].items():
            err = (got["grads"][name] - w).abs().max()
            assert err <= 1e-5 * w.abs().max() + 1e-7, (name, err)
        errs = torch.cat([(got["weights"][k] - w).abs().flatten()
                          for k, w in cw["port"].items()])
        assert float(errs.max()) <= adam_bound(tw.N_STEPS) * lr
        assert float(errs.quantile(0.99)) <= 1e-4 * lr
        want = cw["jax_losses"]
        for k in want[0]:
            np.testing.assert_allclose(got["losses"][0][k], want[0][k],
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose([l["total_loss"] for l in got["losses"]],
                                   [l["total_loss"] for l in want],
                                   rtol=1e-3)
        for name, g in got["grads"].items():
            w = cw["jax_grads"][name].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-7, (name, err)


def test_remat_under_sp_equals_the_step_without(sp_world):
    """remat_trunk under sp: the checkpointed layers replay the halo
    exchange in the backward in the same order on every rank; the step's
    losses and gradients equal the first step without remat (losses bit
    for bit, gradients within 1e-6 of each tensor's max abs)."""
    for res in sp_world["ranks"]:
        a, b = res["remat"], res["contrastive"]
        assert a["losses"] == b["losses"][:1] and a["clamped"] == [0]
        for name, g in b["grads"].items():
            err = (a["grads"][name] - g).abs().max()
            assert err <= 1e-6 * g.abs().max() + 1e-12, (name, err)


def test_split_world_without_a_context_equals_one_process(sp_world,
                                                         contrastive_world):
    """sp_msda off on the 2 x 2 world: no sp op runs, both ranks of an sp
    group compute their row block's whole step and backpropagate half of
    its loss each, so the summed gradients are the one-process step's: the
    step's losses within 1e-5 (relative), its gradients within 1e-5 of
    each tensor's max abs + 1e-7."""
    cw = contrastive_world
    for res in sp_world["ranks"]:
        got = res["no_context"]
        assert got["clamped"] == []
        for g, w in zip(got["losses"], cw["port_losses"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-9,
                                           err_msg=k)
        for name, w in cw["port_grads"].items():
            err = (got["grads"][name] - w).abs().max()
            assert err <= 1e-5 * w.abs().max() + 1e-7, (name, err)


def test_train_cli_dp_sp_on_four_ranks_equals_one_process(sp_world):
    """train_cli with mesh_shape 'dp,sp' on the 2 x 2 world: 3 debug steps
    of 4 videos and a validation under the eval context (dp rows, default
    halo), against the same yml in one process (plain dp of 1): info.json's
    train losses within 1e-5 and val scores within 1e-4, the same bests;
    model-last within `adam_bound(3)` x lr and 99% of its entries within
    1e-4 x lr (the ranks' weights bit for bit equal); rank 0 alone
    writes."""
    want = sp_world["ref"]["train"]
    wi = json.loads(want["info"])
    ranks = [r["train"] for r in sp_world["ranks"]]
    lr = PConfig().lr
    for got in ranks:
        gi = json.loads(got["info"])
        assert gi["opt"]["mesh_shape"] == "dp,sp"
        assert set(gi["history"]["train_loss"]) == {"0"}
        for k, v in wi["history"]["train_loss"]["0"].items():
            np.testing.assert_allclose(gi["history"]["train_loss"]["0"][k],
                                       v, rtol=1e-5, atol=1e-9, err_msg=k)
        gv, wv = gi["history"]["val_scores"]["0"], \
            wi["history"]["val_scores"]["0"]
        assert set(gv) == set(wv)
        for k, v in wv.items():
            if isinstance(v, float):
                assert abs(gv[k] - v) <= 1e-4, (k, gv[k], v)
        assert gi["best"] == pytest.approx(wi["best"], abs=1e-4)
        errs = torch.cat([(got["model"][k] - w).abs().flatten()
                          for k, w in want["model"].items()])
        assert float(errs.max()) <= adam_bound(3) * lr
        assert float(errs.quantile(0.99)) <= 1e-4 * lr
        for k in ranks[0]["model"]:
            assert torch.equal(got["model"][k], ranks[0]["model"][k]), k
    assert ranks[0]["writes"]
    assert all(r["writes"] == [] for r in ranks[1:])
