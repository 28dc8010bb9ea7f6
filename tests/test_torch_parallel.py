"""Data parallelism of the port (gvl_tpu_torch.parallel and its callers) in a
gloo world of 2 ranks on the CPU, against the port in one process and, for
the contrastive step, against JAX's one-device step on the global batch.

One world per test run (`once_per_test_run`): the test process writes the
CLI cases' inputs, spawns the ranks (tests/torch_parallel_world.py, spawn
start method, every collective under a 60 s timeout, the world joined
within 300 s and killed past it, a rank's error raised with its
traceback), then writes the step cases' inputs (the contrastive world's
JAX init, which the ranks wait for after the CLI cases) and computes the
one-process references while the ranks run. Each case below reads the
results; only the contrastive case reads the JAX steps of
tests/test_torch_contrastive_train.py's world.

The cases and their tolerances:
- the gather Function against a one-process `cat` and its gradient (exact,
  float64); `sum_gradients` with a gradient missing on one rank and on
  both; each rank's rows against `np.split`; each rank's own seed;
- the contrastive world of tests/test_torch_contrastive_train.py (B = 2
  with 3 and 2 GT: one video a rank, cross-video negatives) from its
  initial weights: the 5 steps' global losses and the first step's
  gradients against that world's JAX step, at that file's tolerances (no
  new JAX compile);
- a global batch whose second rank's rows hold no valid GT (the caption
  cost on): losses and gradients of 2 steps within 1e-5 of the one-process
  step (relative; a gradient to 1e-5 of its tensor's max abs);
- eval_cli --eval_data_parallel (EvalRunner over 6 videos in batches of 4,
  the last one padded): the DVC and grounding JSONs equal the one-process
  run's (keys, tokens and sentences exactly, numbers to 1e-6) and so do
  each batch's eval losses (1e-6 relative);
- a SCST step on forced tokens (each event's second most likely token),
  CIDEr-D and METEOR rewards: rewards equal, losses within 1e-6;
- train_cli, 1 debug epoch of 3 steps and a validation: info.json's
  histories and model-last within the bounds stated in the test, and rank
  1 writes no file;
- a batch that 2 ranks do not divide is refused by name, before any run
  dir exists; the sequence-parallel mesh on 2 ranks is plain dp, as in
  JAX below 4 devices, and trains.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from tests import torch_parallel_world as tw
from tests.test_torch_contrastive_train import (compute_world, initial,
                                               port_initial)
from tests.test_torch_train_loop import adam_bound, loop_cfg, once_per_test_run
from tests.test_torch_train_step import LOSS_SIDE


def write_step_inputs(root: pathlib.Path) -> dict:
    """The step cases' inputs (step_inputs.pt, written whole). The
    contrastive case starts from the initial weights of
    tests/test_torch_contrastive_train.py's world (its JAX init, seeded)."""
    cfg, bundle, _, batch, _, _, params = initial(**LOSS_SIDE)
    port, text, pbatch = port_initial(cfg, bundle, params, batch)
    cfg = cfg.to_dict()
    contrastive = dict(cfg=cfg, port0=port.state_dict(),
                       text=text.state_dict(), batch=pbatch)
    batch = {k: (v.copy() if isinstance(v, np.ndarray) else list(v))
             for k, v in pbatch.items()}
    batch["gt_mask"][1] = False
    batch["captions_raw"][1] = []
    steps = dict(
        contrastive=contrastive,
        no_gt=dict(contrastive, batch=batch,
                   cfg=dict(cfg, set_cost_caption=1.0)),
        scst=dict(batch=pbatch, cfg=dict(
            cfg, enable_contrastive=False, caption_loss_type="rl",
            rl_scorer_types=["Meteor", "CiderD"],
            rl_scorer_weights=[1.0, 1.0], cached_tokens="",
            cl_para_ratio=0.5)))
    torch.save(steps, root / "step_inputs.tmp")
    (root / "step_inputs.tmp").rename(root / "step_inputs.pt")
    return steps


def write_cli_inputs(root: pathlib.Path) -> dict:
    """The CLI cases' inputs of the ranks (inputs.pt) and of the reference
    (returned)."""
    data = make_synthetic_dataset(str(root / "data"), num_videos=6,
                                  feat_dim=16)
    base = dict(loop_cfg(root, data), id="dp_run", epoch=1, batch_size=2,
                eval_batch_size=4, min_epoch_when_save=0)
    inputs = {}
    for which in ("dp", "ref"):
        eval_run_dir(root / f"eval_{which}", base)
        cfg = dict(base, save_dir=str(root / f"{which}_save"))
        yml = root / f"{which}.yml"
        yml.write_text(yaml.safe_dump(cfg))
        inputs[which] = dict(
            train=dict(cfg=cfg, yml=str(yml)),
            eval=dict(argv=["--eval_save_dir", str(root / f"eval_{which}"),
                            "--eval_folder", "run", "--eval_checkpoint",
                            "model-last", "--eval_device", "cpu",
                            "--eval_batch_size", "4",
                            "--eval_gt_file_for_grounding",
                            base["eval_gt_file_for_grounding"]]))
    torch.save(inputs["dp"], root / "inputs.pt")
    return inputs["ref"]


def eval_run_dir(save: pathlib.Path, base: dict) -> None:
    """A run dir `save/run` of the tiny loop config: opts.json and a
    model-last of seeded weights."""
    from gvl_tpu_torch.models.gvl import build_model
    from gvl_tpu_torch.models.layers import init_params
    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from gvl_tpu_torch.train.checkpoint import CheckpointManager
    cfg = PConfig().update(base)
    folder = save / "run"
    folder.mkdir(parents=True)
    text = load_text_encoder(cfg, device="cpu")
    model = build_model(cfg, text.hidden_size, device="cpu")
    init_params(model, torch.Generator().manual_seed(3))
    CheckpointManager(str(folder)).save("model-last", model, text, 0)
    cfg.dump_json(str(folder / "opts.json"))


def compute(root: pathlib.Path) -> None:
    """Spawn the ranks on the CLI cases, then write the step cases' inputs
    and compute the one-process references while the ranks run."""
    ref_inputs = write_cli_inputs(root)
    ctx = tw.start_world(root)
    try:
        steps = write_step_inputs(root)
        ref = tw.step_cases(steps)
        ref.update(tw.cli_cases(ref_inputs, root / "ref"))
        torch.save(ref, root / "ref.pt")
    except BaseException:
        tw.kill_world(ctx)
        raise
    tw.join_world(ctx)


def load(root: pathlib.Path) -> dict:
    return dict(ranks=[torch.load(root / f"rank{r}.pt", weights_only=False)
                       for r in range(tw.RANKS)],
                ref=torch.load(root / "ref.pt", weights_only=False),
                root=root)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return once_per_test_run(tmp_path_factory, "torch_parallel_world",
                             compute, load)


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """tests/test_torch_contrastive_train.py's world: JAX's one-device
    steps on the global batch (computed once per test run)."""
    root = once_per_test_run(tmp_path_factory, "torch_contrastive_world",
                             compute_world, lambda root: root)
    return torch.load(root / "world.pt", weights_only=False)


# -------------------------------------------------------------- collectives

def test_gather_rows_and_its_gradient_equal_a_one_process_cat(world):
    """gather_rows gives X in rank order on every rank; the gradient that
    reaches rank r's rows is that of sum_s sum(W_s * X) there."""
    for r, res in enumerate(world["ranks"]):
        g = res["gather"]
        assert torch.equal(g["y"], g["X"])
        block = slice(3 * r, 3 * r + 3)
        assert torch.equal(g["grad"], g["W"].sum(0)[block])
        mask = torch.tensor([[True, False], [False, True], [True, True]])
        assert torch.equal(g["bools"], torch.cat([mask, ~mask]))


def test_sum_gradients_with_a_gradient_missing_on_one_rank(world):
    """a: 1 + 2 on both ranks; b: rank 0's 5 (rank 1 entered zeros); c:
    no gradient on either rank stays None."""
    for res in world["ranks"]:
        g = res["sum_gradients"]
        assert torch.equal(g["a"], torch.full((3,), 3.0))
        assert torch.equal(g["b"], torch.full((2,), 5.0))
        assert g["c"] is None


def test_each_rank_draws_its_own_dropout_masks(world):
    """The step's seed is folded with the rank, so the ranks' masks
    differ; a world of one keeps the step's seed."""
    from gvl_tpu_torch.train.state import fold_seed, rank_seed
    a, b = (r["seeds"] for r in world["ranks"])
    assert (a["seed"], b["seed"]) == (fold_seed(7, 0), fold_seed(7, 1))
    assert not torch.equal(a["mask"], b["mask"])
    assert rank_seed(7) == 7


def test_each_rank_takes_its_block_of_rows_as_np_split(world):
    feats = np.arange(6 * 4).reshape(6, 4)
    for r, res in enumerate(world["ranks"]):
        b = res["blocks"]
        np.testing.assert_array_equal(b["feats"], np.split(feats, 2)[r])
        np.testing.assert_array_equal(b["mask"],
                                      np.split(np.arange(6) % 2 == 0, 2)[r])
        assert torch.equal(b["t"], torch.arange(12).reshape(6, 2)[3 * r:
                                                                3 * r + 3])
        assert b["keys"] == [f"v{i}" for i in range(3 * r, 3 * r + 3)]
        assert b["raw"] == [[str(i)] * i for i in range(3 * r, 3 * r + 3)]


def test_a_batch_the_world_does_not_divide_is_refused_by_name(world):
    """The global batch of 3 over 2 ranks, directly and through the
    train loop, naming the world sizes that divide it; no run dir."""
    for res in world["ranks"]:
        ref = res["refusals"]
        for case in ("batch_3", "train_batch_3"):
            kind, msg = ref[case]
            assert kind == "ValueError", ref[case]
            assert "batch of 3 rows does not divide over 2 ranks" in msg
            assert "[1, 3]" in msg
        assert res["refusals"]["run_dirs"][0] is False


def test_sequence_parallel_mesh_is_refused_by_name(world):
    """Once refused, the sequence-parallel mesh now runs; on 2 ranks, as
    JAX's make_mesh below 4 devices, it is plain dp: the world stays 2 dp
    ranks of sp 1 and the train loop takes it (0 epochs: its run dir made,
    the same on both ranks)."""
    for res in world["ranks"]:
        ref = res["refusals"]
        assert ref["dp_sp"] == (2, 1), ref["dp_sp"]
        assert isinstance(ref["train_dp_sp"], str), ref["train_dp_sp"]
        assert ref["train_dp_sp"] == world["ranks"][0]["refusals"][
            "train_dp_sp"]
        assert ref["run_dirs"][1] is True


# --------------------------------------------------------------- the step

def test_two_ranks_of_the_contrastive_step_match_jax_on_the_global_batch(
        world, jax_world):
    """Each rank takes one of the two videos; the global losses of 5 steps
    (first step rtol 2e-4 / atol 2e-5, the total's trajectory rtol 1e-3)
    and the first step's summed, clipped gradients (max abs difference <=
    1e-3 x the tensor's max abs + 1e-7) against JAX's one-device step, as
    tests/test_torch_contrastive_train.py holds the one-process port."""
    jw = jax_world
    for res in world["ranks"]:
        got = res["contrastive"]
        assert got["rows"] == 1
        want = jw["jax_losses"]
        assert set(got["losses"][0]) == set(want[0])
        for k in want[0]:
            np.testing.assert_allclose(got["losses"][0][k], want[0][k],
                                       rtol=2e-4, atol=2e-5, err_msg=k)
        np.testing.assert_allclose([l["total_loss"] for l in got["losses"]],
                                   [l["total_loss"] for l in want],
                                   rtol=1e-3)
        assert set(got["grads"]) == set(jw["jax_grads"])
        for name, g in got["grads"].items():
            w = jw["jax_grads"][name].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max() + 1e-7, (name, err)
    a, b = (r["contrastive"] for r in world["ranks"])
    assert a["losses"] == b["losses"]
    for name in a["grads"]:
        assert torch.equal(a["grads"][name], b["grads"][name]), name


def _close(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-9,
                                   err_msg=k)


def test_a_rank_without_valid_gt_matches_one_process(world):
    """Rank 1's video has no valid GT (has_any, num_boxes and the caption
    cost's counts are global sums): 2 steps' losses within 1e-5, the
    first step's gradients within 1e-5 of each tensor's max abs."""
    want = world["ref"]["no_gt"]
    for res in world["ranks"]:
        got = res["no_gt"]
        for g, w in zip(got["losses"], want["losses"]):
            assert set(g) == set(w)
            _close(g, w, 1e-5)
        for name, w in want["grads"].items():
            g = got["grads"][name]
            assert (g is None) == (w is None), name
            if w is not None:
                err = (g - w).abs().max()
                assert err <= 1e-5 * w.abs().max() + 1e-9, (name, err)


def test_scst_rewards_and_loss_of_two_ranks_equal_one_process(world):
    """CIDEr-D's document frequencies over the global batch, so each
    rank's rewards are the one-process rewards of its rows, exactly; the
    global losses within 1e-6 and the caption head's gradients within
    1e-5 of their max abs."""
    want = world["ref"]["scst"]
    got = [r["scst"] for r in world["ranks"]]
    assert len(want["rewards"]) == len(got[0]["rewards"]) > 0
    for i, w in enumerate(want["rewards"]):
        np.testing.assert_array_equal(
            np.concatenate([g["rewards"][i] for g in got]), w)
    assert np.abs(want["rewards"][0]).max() > 0
    for g in got:
        _close(g["losses"], want["losses"], 1e-6)
        for name, w in want["grads"].items():
            err = (g["grads"][name] - w).abs().max()
            assert err <= 1e-5 * w.abs().max() + 1e-9, (name, err)


# ------------------------------------------------------------------ the CLIs

def _same_json(got, want, path="$"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6 + 1e-6 * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_eval_cli_data_parallel_equals_one_process(world):
    """EvalRunner over the ranks (6 videos, batches of 4, the last one
    padded: rank 1 holds only padded rows there): the DVC JSON and both
    grounding JSONs rank 0 wrote equal the one-process run's, and so do
    the eval losses of each batch; rank 1 writes no file."""
    want = world["ref"]["eval"]
    assert want["videos"] == 6 and len(want["losses"]) == 2
    for r, res in enumerate(world["ranks"]):
        got = res["eval"]
        for name, text in want["files"].items():
            _same_json(json.loads(got["files"][name]), json.loads(text))
        for g, w in zip(got["losses"], want["losses"]):
            _close(g, w, 1e-6)
        assert got["videos"] == 6
        assert got["scores"] == world["ranks"][0]["eval"]["scores"]
    assert world["ranks"][0]["eval"]["writes"]
    assert world["ranks"][1]["eval"]["writes"] == []


def test_train_cli_on_two_ranks_equals_one_process(world):
    """1 debug epoch of 3 steps of 2 videos (one a rank) and a validation
    with 4 + 2 padded videos: info.json's train losses within 1e-5 and its
    val scores within 1e-4 of the one-process run's, the same best
    checkpoints; model-last within the distance two Adam trajectories can
    part in 3 steps (`adam_bound`: Adam scales a gradient that is 0 up to
    rounding, as the softmax-invariant biases', to a step of up to lr) and
    99% of its entries within 1e-4 x lr of the one-process weights (the
    ranks' weights bit for bit equal); rank 1 writes no file."""
    want = world["ref"]["train"]
    wi = json.loads(want["info"])
    ranks = [r["train"] for r in world["ranks"]]
    assert ranks[0]["folder"] == ranks[1]["folder"]
    for got in ranks:
        gi = json.loads(got["info"])
        assert set(gi["history"]["train_loss"]) == {"0"}
        _close(gi["history"]["train_loss"]["0"],
               wi["history"]["train_loss"]["0"], 1e-5)
        gv, wv = gi["history"]["val_scores"]["0"], \
            wi["history"]["val_scores"]["0"]
        assert set(gv) == set(wv)
        for k, v in wv.items():
            if isinstance(v, float):
                assert abs(gv[k] - v) <= 1e-4, (k, gv[k], v)
        assert gi["best"] == pytest.approx(wi["best"], abs=1e-4)
        lr = PConfig().lr
        errs = torch.cat([(got["model"][k] - w).abs().flatten()
                          for k, w in want["model"].items()])
        assert float(errs.max()) <= adam_bound(3) * lr
        assert float(errs.quantile(0.99)) <= 1e-4 * lr
    for k in ranks[0]["model"]:
        assert torch.equal(ranks[0]["model"][k], ranks[1]["model"][k]), k
    assert ranks[0]["writes"] and ranks[0]["cwd_files"] == [".tmp"]
    assert ranks[1]["writes"] == [] and ranks[1]["cwd_files"] == []
