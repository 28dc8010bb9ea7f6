"""The port's train loop, resume, load_pretrained and train CLI
(gvl_tpu_torch.train.loop, .checkpoint, gvl_tpu_torch.train_cli) against the
JAX package's, on the CPU.

Both packages train tests/test_train_loop.py's tiny config (every dropout
rate 0) on the same make_synthetic_dataset world: 2 debug epochs, then a
resume of that run to 3 epochs with contrary flags. The JAX loop runs on
one CPU device, as the port does. The port starts from the JAX loop's own
init (its init_params, jitted here for speed, and the offline text
bundle), converted by gvl_tpu_torch.convert and put in through the port
loop's `init_weights` seam. Compared: the per-epoch train losses (the
train-step trajectory's tolerances), the val scores (1e-4), the epochs at
which each best checkpoint was saved (equal), and the final model-last
weights, model and text encoder, against JAX's orbax model-last, converted
(in units of the learning rate, within the distance two Adam trajectories
can part: `adam_bound`).
"""

import fcntl
import json
import os
import pathlib
import subprocess
import sys
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import gvl_tpu.models.text_encoder as jte
import gvl_tpu.train.loop as jloop
from gvl_tpu.config import Config as JConfig
from gvl_tpu.parallel.mesh import make_mesh
from gvl_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from gvl_tpu.train.checkpoint import load_pretrained as j_load_pretrained
from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.train import checkpoint as pckpt
from gvl_tpu_torch.train import loop as ploop

REPO = pathlib.Path(__file__).resolve().parents[1]
EPOCHS, RESUMED_EPOCHS, STEPS_PER_EPOCH = 2, 3, 2


def loop_cfg(root: pathlib.Path, data) -> dict:
    """tests/test_train_loop.py's config, dropout off; 6 videos in batches
    of 3: 2 steps an epoch."""
    anno, feats, vocab, vsize = data
    return dict(
        id="loop_run", train_caption_file=anno, val_caption_file=anno,
        gt_file_for_eval=[anno], gt_file_for_para_eval=[],
        eval_gt_file_for_grounding=anno.replace("anno.json",
                                                "grounding.json"),
        visual_feature_folder=feats, visual_feature_type="npy",
        dict_file=vocab, vocab_size=vsize, feature_dim=16,
        frame_embedding_num=24, hidden_dim=64, nheads=4, enc_layers=1,
        dec_layers=2, transformer_ff_dim=64, num_feature_levels=3,
        num_queries=8, gt_proposal_sample_num=4, max_caption_len=8,
        input_encoding_size=32, rnn_size=32, att_hid_size=32, cap_nheads=1,
        cap_num_feature_levels=3, with_box_refine=1, enable_contrastive=True,
        contrastive_hidden_size=16, caption_decoder_type="standard",
        caption_loss_coef=1.0, count_loss_coef=0.5, set_cost_cl=1.0,
        contrastive_loss_start_coef=0.1, max_eseq_length=6, batch_size=3,
        eval_batch_size=3, epoch=EPOCHS, msda_impl="ref",
        max_text_input_len=12,
        load_pretrained_language_model_from_config="offline",
        offline_text_encoder_hidden=32, offline_text_encoder_layers=1,
        criteria_for_best_ckpt="grounding", debug=True,
        eval_tool_version="2018", drop_prob=0.0,
        transformer_dropout_prob=0.0, num_workers=1)


RESUME = dict(start_from="loop_run", start_from_mode="last",
              epoch=RESUMED_EPOCHS, lr=0.5, weight_decay=0.3)


def jitted_init_params(model, cfg, bundle, probe_batch):
    """gvl_tpu.train.loop.init_params under jax.jit: the same init (its
    eager form compiles each op alone, ~30 s here)."""
    db = {k: jnp.asarray(v) for k, v in probe_batch.items()
          if isinstance(v, np.ndarray)}
    G = cfg.effective_max_gt_events

    def init(db):
        B = db["captions"].shape[0]
        return model.init(
            jax.random.PRNGKey(cfg.seed), db["video_feats"], db["video_mask"],
            db["duration"], method=model.init_all, captions=db["captions"],
            word_embed=jnp.zeros((B, G, cfg.max_text_input_len,
                                  bundle.hidden_size)),
            token_mask=jnp.ones((B, G, cfg.max_text_input_len), bool),
            gt_mask=db["gt_mask"])
    return jax.jit(init)(db)


def once_per_test_run(tmp_path_factory, name: str, compute, load):
    """`load(root)` of what `compute(root)` wrote into the directory
    `root`, computed once per test run: under pytest-xdist every worker
    shares `<basetemp's parent>/<name>` and the first to take its lock
    computes (pytest-xdist's documented pattern, with a stdlib flock); in
    one process, a fresh directory. Each computation appends a line to
    `<root>/computations.log`."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        root = tmp_path_factory.mktemp(name)
        compute(root)
        with open(root / "computations.log", "a") as f:
            f.write("main\n")
        return load(root)
    root = tmp_path_factory.getbasetemp().parent / name
    root.mkdir(exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (root / "done").exists():
                compute(root)
                with open(root / "computations.log", "a") as f:
                    f.write(os.environ["PYTEST_XDIST_WORKER"] + "\n")
                (root / "done").touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return load(root)


def jax_loop_init(base: dict):
    """The JAX loop's init of the run `base` configures, as
    gvl_tpu.train.loop.train makes it before its first step (the seeded
    first train batch as the probe): (its parameters as numpy, the text
    bundle)."""
    from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
    from gvl_tpu.models import build_model as jax_build_model
    from gvl_tpu.utils.logging import set_seed
    cfg = JConfig().update(base)
    set_seed(cfg.seed)
    rng_data = np.random.RandomState(cfg.seed)
    train_ds = DenseVideoDataset(cfg.train_caption_file,
                                 cfg.visual_feature_folder, cfg.dict_file,
                                 True, cfg, rng_data)
    batcher = Batcher(train_ds, cfg, cfg.batch_size, shuffle=True,
                      rng=rng_data, drop_last=True)
    bundle = jloop.load_text_encoder(cfg)
    model = jax_build_model(cfg, text_hidden_dim=bundle.hidden_size)
    probe = jloop.add_text_inputs(next(iter(batcher)), bundle, cfg)
    return (jax.tree_util.tree_map(
        np.asarray, jitted_init_params(model, cfg, bundle, probe)), bundle)


def run_package(pkg: str, root: pathlib.Path, base: dict, patches) -> tuple:
    """One package's 2-epoch run and its resume, under `patches`
    (attribute, value) pairs: (the summary runs.json keeps, the first
    run's checkpoints)."""
    cls, train = (JConfig, jloop.train) if pkg == "jax" else \
        (PConfig, ploop.train)
    mp = pytest.MonkeyPatch()
    try:
        for target, name, value in patches:
            mp.setattr(target, name, value)
        cfg = cls().update(dict(base, save_dir=str(root / pkg)))
        if pkg == "port":
            cfg.device = "cpu"
        first = train(cfg)
        # the resumed run writes into the same run dir: keep what the first
        # run left
        read = jax_checkpoint if pkg == "jax" else port_checkpoint
        ckpts = {n: read(first, n, cfg) for n in CKPTS}
        info = json.loads(pathlib.Path(first, "info.json").read_text())
        # the JAX package pins its params after the run: a fresh init for
        # the resumed one, as a new process makes
        resumed_cfg = cls().update(dict(base, save_dir=str(root / pkg),
                                        **RESUME))
        if pkg == "port":
            resumed_cfg.device = "cpu"
        resumed = train(resumed_cfg)
    finally:
        mp.undo()
    return dict(folder=first, resumed_folder=resumed, info=info,
                resumed_info=json.loads(pathlib.Path(
                    resumed, "info.json").read_text()),
                resumed_cfg=dict(lr=resumed_cfg.lr,
                                 weight_decay=resumed_cfg.weight_decay,
                                 epoch=resumed_cfg.epoch)), ckpts


def compute_jax_runs(root: pathlib.Path) -> None:
    """The JAX package's 2-epoch run and its resume, in `root`: run.json
    (the info, folders and config), ckpts.pt (the 2-epoch run's
    checkpoints, read before the resume replaces them) and init.npz (the
    JAX init's parameters)."""
    data = make_synthetic_dataset(str(root), num_videos=6, feat_dim=16)
    base = loop_cfg(root, data)
    init = {}

    def capture_init(*a):
        # the resumed run asks again for the same init (same seed and
        # widths) to have its structure: hand it fresh arrays of the first
        # one's values rather than trace and compile the init again
        if "values" not in init:
            init["values"] = jax.tree_util.tree_map(
                np.asarray, jitted_init_params(*a))
        return jax.tree_util.tree_map(jnp.asarray, init["values"])

    # the port trains on one device: so does the JAX loop here
    # (tests/conftest.py makes 8 CPU devices, on which it would shard
    # batches of 3 over a dp=3 mesh)
    out, ckpts = run_package("jax", root, base, [
        (jloop, "make_mesh_for_batch",
         lambda batch_size, shape="dp": make_mesh(1, shape)),
        (jloop, "init_params", capture_init)])
    (root / "run.json").write_text(json.dumps(dict(out, base=base)))
    torch.save(ckpts, root / "ckpts.pt")
    np.savez(root / "init.npz", **{
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(
            init["values"])[0]})


def compute_port_runs(root: pathlib.Path) -> None:
    """The port's 2-epoch run and its resume, in `root`, from the JAX
    loop's init (`jax_loop_init`, computed here, so that the two halves of
    the runs run in two workers at once): run.json and ckpts.pt."""
    data = make_synthetic_dataset(str(root), num_videos=6, feat_dim=16)
    base = loop_cfg(root, data)
    values, bundle = jax_loop_init(base)

    def port_init(cfg, model, text, probe):
        model.load_state_dict(jax_params_to_state_dict(
            values, GVLArch.from_config(cfg)), strict=True)
        text.load_state_dict(flax_roberta_to_state_dict(
            jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)

    out, ckpts = run_package("port", root, base,
                             [(ploop, "init_weights", port_init)])
    (root / "run.json").write_text(json.dumps(dict(out, base=base)))
    torch.save(ckpts, root / "ckpts.pt")


def load_run(root: pathlib.Path) -> dict:
    """One package's summary, checkpoints and computations log."""
    r = json.loads((root / "run.json").read_text())
    ckpts = torch.load(root / "ckpts.pt", weights_only=True)
    return dict(r, ckpts={n: tuple(v) for n, v in ckpts.items()},
                resumed_cfg=types.SimpleNamespace(**r["resumed_cfg"]),
                computations=(root / "computations.log").read_text().split())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 2-epoch runs and their resumes, each computed once per
    test run (once_per_test_run), by whichever worker asks first: under
    pytest-xdist the even workers ask for the JAX half first and the odd
    ones for the port half, so that two workers compute the halves at
    once. The base config is the port half's (both halves write the same
    seeded synthetic data)."""
    halves = [("jax", compute_jax_runs), ("port", compute_port_runs)]
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")
    if int(worker[2:]) % 2:
        halves.reverse()
    out = {}
    for pkg, compute in halves:
        out[pkg] = once_per_test_run(tmp_path_factory,
                                     f"torch_train_loop_{pkg}_run", compute,
                                     load_run)
    jax_root = pathlib.Path(out["jax"]["folder"]).parent.parent
    with np.load(jax_root / "init.npz") as z:
        init = {"params": flax.traverse_util.unflatten_dict(
            {k: z[k] for k in z.files}, sep="/")}
    out["jax"].pop("base")
    return dict(out, base=out["port"].pop("base"), init=init,
                computations={pkg: out[pkg].pop("computations")
                              for pkg in ("jax", "port")})


def test_the_runs_are_computed_once_per_test_run(runs):
    """The 2-epoch runs and their resume, which every test of this module
    reads, are computed once per test run: each package's by one worker."""
    assert all(len(c) == 1 for c in runs["computations"].values()), \
        runs["computations"]


CKPTS = ("model-best", "model-best-dvc", "model-best-pc",
         "model-best-grounding", "model-last")


def jax_checkpoint(folder, name, cfg):
    """A JAX checkpoint's model and text encoder weights under the port's
    names, its epoch and update count."""
    raw = JCheckpoints(folder).restore_raw(name)
    st = raw["state"]
    sd = jax_params_to_state_dict(st["params"], GVLArch.from_config(cfg))
    sd.update(flax_roberta_to_state_dict(st["text_params"]))
    return sd, int(raw["epoch"]), int(st["step"])


def port_checkpoint(folder, name, cfg=None):
    raw = pckpt.CheckpointManager(folder).restore_raw(name)
    sd = dict(raw["model"])
    sd.update(raw["text_encoder"])
    return sd, int(raw["epoch"]), int(raw["step"])


def adam_bound(steps: int) -> float:
    """The furthest two Adam trajectories (betas 0.9, 0.999) from the same
    point can part after `steps` updates, in units of lr: each update moves
    an entry by at most |m_hat| / sqrt(v_hat) <= sqrt(sum a_i^2 / b_i),
    a_i and b_i the moments' weights of the i-th gradient (1.0 at the first
    update, 1.0068 at the fourth)."""
    total = 0.0
    for t in range(1, steps + 1):
        i = np.arange(1, t + 1)
        a = 0.1 * 0.9 ** (t - i) / (1 - 0.9 ** t)
        b = 0.001 * 0.999 ** (t - i) / (1 - 0.999 ** t)
        total += 2 * np.sqrt((a * a / b).sum())
    return float(total)


def assert_losses_close(got: dict, want: dict):
    """The train-step trajectory's tolerances (tests/test_torch_train_step
    .py): total rtol 1e-3, each loss rtol 2e-3 / atol 1e-4."""
    assert sorted(got) == sorted(want)
    for epoch in want:
        assert set(got[epoch]) == set(want[epoch])
        for k, v in want[epoch].items():
            tol = dict(rtol=1e-3) if k == "total_loss" else \
                dict(rtol=2e-3, atol=1e-4)
            np.testing.assert_allclose(got[epoch][k], v, err_msg=(epoch, k),
                                       **tol)


def assert_scores_close(got: dict, want: dict, weights: dict):
    """Every numeric val score within 1e-4; the approximation flags equal.
    The eval losses ('val_*') are rounded to 3 places by both packages, so
    one may sit a rounding step (1e-3) apart, and their weighted total
    (`weights`) the weight of one loss's step."""
    assert sorted(got) == sorted(want)
    for epoch in want:
        g, w = got[epoch], want[epoch]
        assert set(g) == set(w), set(g) ^ set(w)
        for k, v in w.items():
            if k == "val_loss_total":
                tol = 1e-3 * max(weights.values()) + 1e-4
            elif k.startswith("val_"):
                tol = 1e-3 + 1e-4
            else:
                tol = 1e-4
            if isinstance(v, (int, float)):
                assert abs(g[k] - v) <= tol, (epoch, k, g[k], v)
            else:
                assert g[k] == v, k


def val_weights(runs) -> dict:
    from gvl_tpu_torch.train.criterion import make_weight_dict
    return make_weight_dict(PConfig().update(runs["base"]))


def assert_weights_close(got: dict, want: dict, lr: float, steps: int):
    """In units of the model's lr (the text encoder's own is 10x smaller):
    no entry further from JAX's than two Adam trajectories can part
    (adam_bound; the encoder's sampling offsets come near it, their
    gradient jumps where a tap crosses a row), 99% within 0.5 (tests/
    test_torch_train_step.py's trajectory test)."""
    assert set(got) == set(want)
    diffs = np.concatenate([(got[k] - want[k]).abs().numpy().ravel() / lr
                            for k in want])
    assert diffs.max() <= adam_bound(steps)
    assert np.quantile(diffs, 0.99) <= 0.5


def test_loop_train_losses_match_jax(runs):
    assert_losses_close(runs["port"]["info"]["history"]["train_loss"],
                        runs["jax"]["info"]["history"]["train_loss"])
    assert sorted(runs["port"]["info"]["history"]["train_loss"]) == \
        [str(e) for e in range(EPOCHS)]


def test_loop_val_scores_match_jax(runs):
    want = runs["jax"]["info"]["history"]["val_scores"]
    assert_scores_close(runs["port"]["info"]["history"]["val_scores"], want,
                        val_weights(runs))
    for key in ("grounding_R@1IOU0.5", "METEOR", "soda_c", "val_loss_ce",
                "val_loss_total"):
        assert key in want[str(EPOCHS - 1)]


@pytest.mark.parametrize("name", ["model-best", "model-best-dvc",
                                  "model-best-pc", "model-best-grounding",
                                  "model-last"])
def test_loop_checkpoint_epochs_match_jax(runs, name):
    """Each checkpoint of the 2-epoch run exists in both packages and was
    saved at the same epoch, after as many updates."""
    _, *want = runs["jax"]["ckpts"][name]
    _, *got = runs["port"]["ckpts"][name]
    assert got == want
    assert runs["port"]["info"]["best"] == pytest.approx(
        runs["jax"]["info"]["best"], abs=1e-4)


def test_loop_final_weights_match_jax(runs):
    cfg = PConfig().update(runs["base"])
    want, _, steps = runs["jax"]["ckpts"]["model-last"]
    got, *_ = runs["port"]["ckpts"]["model-last"]
    assert steps == EPOCHS * STEPS_PER_EPOCH
    assert_weights_close(got, want, cfg.lr, steps)


def test_resume_matches_jax(runs):
    """--start_from the 2-epoch run to 3 epochs: both packages continue in
    the same run dir from the epoch model-last was saved at (they run it
    again), with the optimizer state restored; their histories, val
    scores and final weights agree as the straight run's do."""
    p, j = runs["port"], runs["jax"]
    assert p["resumed_folder"] == p["folder"]
    assert p["resumed_info"]["epoch"] == j["resumed_info"]["epoch"] == \
        RESUMED_EPOCHS - 1
    assert_losses_close(p["resumed_info"]["history"]["train_loss"],
                        j["resumed_info"]["history"]["train_loss"])
    assert_scores_close(p["resumed_info"]["history"]["val_scores"],
                        j["resumed_info"]["history"]["val_scores"],
                        val_weights(runs))
    cfg = PConfig().update(runs["base"])
    want, _, jsteps = jax_checkpoint(j["resumed_folder"], "model-last",
                                     JConfig().update(runs["base"]))
    got, _, steps = port_checkpoint(p["resumed_folder"], "model-last")
    assert steps == jsteps == (EPOCHS + RESUMED_EPOCHS - 1) * STEPS_PER_EPOCH
    assert_weights_close(got, want, cfg.lr, steps)


def test_resume_restores_saved_opts(runs):
    """The port's test_resume.py::test_resume_restores_saved_opts: resume
    continues with the run's original hyperparameters, the given lr and
    weight_decay overridden by the saved ones, except the resume controls
    and epoch/id/save_dir."""
    for pkg in ("port", "jax"):
        cfg2 = runs[pkg]["resumed_cfg"]
        assert cfg2.lr == runs["base"].get("lr", 1e-4)
        assert cfg2.weight_decay == 0.0
        assert cfg2.epoch == RESUMED_EPOCHS
        assert runs[pkg]["resumed_info"]["opt"]["lr"] == cfg2.lr


# ----------------------------------------------------------- load_pretrained

LOAD_CASES = {
    "full": ("full", {}),
    "encoder": ("encoder", {}),
    "decoder": ("decoder", {}),
    "remove_class_head": ("full", dict(remove_class_head_weight=True)),
    "remove_bbox_head": ("full", dict(remove_bbox_head_weight=True)),
    "remove_caption_head": ("full", dict(remove_caption_head_weight=True)),
    "ft_captioner_from_scratch": ("full",
                                  dict(ft_captioner_from_scratch=True)),
    "remove_contrastive_projection": (
        "full", dict(remove_contrastive_projection_weight=True)),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_pretrained_key_set_is_the_image_of_jax(runs, case):
    """JAX's load_pretrained of its run's model-best.ckpt and the port's of
    its model-best.pth: the port loads exactly the entries that are the
    image under jax_params_to_state_dict of the flax leaves JAX loads (each
    leaf found loaded by the value it takes over a fresh tree moved by
    1000)."""
    mode, flags = LOAD_CASES[case]
    jcfg = JConfig().update(dict(runs["base"], **flags))
    pcfg = PConfig().update(dict(runs["base"], **flags))
    arch = GVLArch.from_config(pcfg)
    fresh = jax.tree_util.tree_map(lambda x: np.asarray(x) + 1000.0,
                                   runs["init"]["params"])
    merged = j_load_pretrained(fresh, runs["jax"]["folder"], mode, jcfg)
    loaded = jax.tree_util.tree_map(
        lambda a, b: np.full(np.shape(a), float(np.all(
            np.asarray(a) != np.asarray(b))), np.float32),
        merged, fresh)
    image = jax_params_to_state_dict(loaded, arch)
    want = sorted(k for k, v in image.items() if bool((v == 1).all()))
    assert all(bool(((v == 0) | (v == 1)).all()) for v in image.values())

    model = build_model(pcfg, 32, device="cpu")
    got = pckpt.load_pretrained(model, runs["port"]["folder"], mode, pcfg)
    assert got == want
    src = pckpt.CheckpointManager(runs["port"]["folder"]).restore_raw(
        "model-best")["model"]
    sd = model.state_dict()
    assert all(torch.equal(sd[k], src[k]) for k in got)
    if case == "full":
        assert got == sorted(sd)


def test_load_pretrained_refuses_a_checkpoint_that_matches_nothing(tmp_path):
    pcfg = PConfig().update(dict(
        loop_cfg(tmp_path, ("anno.json", "feats", "vocab.json", 20)),
        enable_contrastive=False))
    model = build_model(pcfg, device="cpu")
    torch.save({"model": {"no.such.key": torch.zeros(3)},
                "text_encoder": None, "epoch": 0}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="matched"):
        pckpt.load_pretrained(model, str(tmp_path / "x.pth"), "full", pcfg)
    with pytest.raises(FileNotFoundError):
        pckpt.load_pretrained(model, str(tmp_path), "full", pcfg)


# ------------------------------------------------------------------ the CLI

def run_cli(tmp_path, *flags):
    data = make_synthetic_dataset(str(tmp_path), num_videos=6, feat_dim=16)
    cfg = dict(loop_cfg(tmp_path, data), save_dir=str(tmp_path / "save"),
               epoch=1)
    cfg.pop("debug")
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "gvl_tpu_torch.train_cli", "--cfg_path",
         str(tmp_path / "cfg.yml"), *flags], capture_output=True, text=True,
        cwd=tmp_path, env=env, timeout=600)


def test_train_cli_debug_run_on_the_cpu(tmp_path):
    res = run_cli(tmp_path, "--device", "cpu", "--debug", "true")
    assert res.returncode == 0, res.stderr[-3000:]
    assert "run id: debug_" in res.stdout
    saved = os.listdir(tmp_path / "save")
    assert len(saved) == 1 and saved[0].startswith("debug_"), saved
    info = json.loads((tmp_path / "save" / saved[0] / "info.json")
                      .read_text())
    assert "0" in info["history"]["val_scores"]


def test_train_cli_needs_the_card_unless_told_otherwise(tmp_path):
    res = run_cli(tmp_path)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and "--device cpu" in res.stderr


REFUSED = {
    # the gpt2 head runs with the offline spec or gpt_model's local files;
    # files that are not there are refused by name, with the paths searched
    "gpt2": (dict(caption_decoder_type="gpt2",
                  load_pretrained_language_model_from_config=""),
             "pretrained GPT-2.*'gpt2'.*refs/main", FileNotFoundError),
    "several_devices": (dict(gpu_id=["0", "1"]), "more than one device"),
    "sp_mesh": (dict(mesh_shape="dp,sp"), "sequence-parallel"),
    # an option the eval side refuses (eval_cli.check_config); the TAL
    # probe, once refused there, trains (test_once_refused_options_train)
    "eval_side": (dict(eval_data_parallel=True), "eval_data_parallel"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_train_options_are_refused_before_any_work(tmp_path, case):
    """Each option the port does not train yet raises NotImplementedError
    naming it (files it cannot find, FileNotFoundError), before a run
    directory or a model exists."""
    flags, name, *exc = REFUSED[case]
    cfg = PConfig().update(dict(
        loop_cfg(tmp_path, ("anno.json", "feats", "vocab.json", 20)),
        save_dir=str(tmp_path / "save"), device="cpu", **flags))
    with pytest.raises(exc[0] if exc else NotImplementedError, match=name):
        ploop.train(cfg)
    assert not (tmp_path / "save").exists()


def tal_probe_data(root: pathlib.Path, data) -> dict:
    """Action labels of three classes on every event of `data`'s
    annotations, the class file and the TAL ground truth: the probe's
    config keys."""
    anno = data[0]
    classes = ["run", "jump", "cook"]
    ann = json.load(open(anno))
    gt = {"database": {}, "taxonomy": [], "version": "1.3"}
    rs = np.random.RandomState(0)
    for vid, v in ann.items():
        v["action_labels"] = [classes[rs.randint(3)] for _ in v["timestamps"]]
        gt["database"][vid[2:]] = {"subset": "validation", "annotations": [
            {"segment": ts, "label": lab}
            for ts, lab in zip(v["timestamps"], v["action_labels"])]}
    json.dump(ann, open(anno, "w"))
    (root / "classes.txt").write_text("\n".join(classes))
    (root / "tal_gt.json").write_text(json.dumps(gt))
    return dict(only_ft_class_head=True, num_classes=3,
                action_classes_path=str(root / "classes.txt"),
                tal_gt_file=str(root / "tal_gt.json"))


ONCE_REFUSED = {
    "two_stage": dict(transformer_input_type="gt_proposals"),
    "caption_cost": dict(set_cost_caption=1.0),
    # ss_prob is 0.1 from the second epoch on (epoch > start)
    "scheduled_sampling": dict(scheduled_sampling_start=0, basic_ss_prob=0.1,
                               epoch=2),
}


@pytest.mark.parametrize("case", ["gpt2", "tal_probe", "two_stage",
                                  "caption_cost", "scheduled_sampling"])
def test_once_refused_options_train(tmp_path, case):
    """The gpt2 caption head (offline spec), the TAL linear probe,
    two-stage queries, the caption cost and scheduled sampling, refused
    until they were ported, train a debug epoch on the CPU and validate it:
    the gpt2 run's captions are scored, the probe's TAL JSON gets its mAP
    (their parity with the JAX package: tests/test_torch_gpt_pipeline.py,
    tests/test_torch_tal.py and tests/test_torch_train_options.py)."""
    data = make_synthetic_dataset(str(tmp_path), num_videos=6, feat_dim=16)
    if case == "gpt2":
        extra = dict(caption_decoder_type="gpt2", prefix_length=4,
                     prefix_size=64)
    elif case == "tal_probe":
        extra = tal_probe_data(tmp_path, data)
    else:
        extra = ONCE_REFUSED[case]
        if case == "scheduled_sampling":
            assert ploop.ss_prob_at_epoch(PConfig().update(extra), 1) == 0.1
    cfg = PConfig().update(dict(dict(loop_cfg(tmp_path, data), epoch=1,
                                     device="cpu",
                                     save_dir=str(tmp_path / "save")),
                                **extra))
    folder = pathlib.Path(ploop.train(cfg))
    info = json.loads((folder / "info.json").read_text())
    scores = info["history"]["val_scores"]["0"]
    assert np.isfinite(info["history"]["train_loss"]["0"]["total_loss"])
    if case in ONCE_REFUSED:
        assert "METEOR" in scores
        assert info["history"]["train_loss"]["0"]["loss_caption"] > 0
        if case == "scheduled_sampling":
            # the second epoch is the one that samples (ss_prob 0.1)
            ss_epoch = info["history"]["train_loss"]["1"]
            assert np.isfinite(ss_epoch["total_loss"])
            assert ss_epoch["loss_caption"] > 0
        if case == "two_stage":
            # the eval CLI evaluates the two-stage run (GT segments as
            # queries)
            from gvl_tpu_torch import eval_cli
            res = eval_cli.main(["--eval_save_dir", str(folder.parent),
                                 "--eval_folder", folder.name,
                                 "--eval_device", "cpu",
                                 "--eval_batch_size", "3"])
            assert res["videos"] == 6 and "METEOR" in res["scores"]
    elif case == "gpt2":
        assert "METEOR" in scores
        assert info["history"]["train_loss"]["0"]["loss_caption"] > 0
        pred = json.loads((folder / "pred_epoch0.json").read_text())
        words = [w for v in pred["results"].values() for p in v
                 for w in p["sentence"].split()]
        assert words and all(w[0] == "w" and int(w[1:]) > 2 for w in words)
    else:
        assert np.isfinite(scores["TAL_Average_mAP"])
        tal = json.loads((folder / "pred_epoch0.tal.json").read_text())
        assert {p["label"] for v in tal["results"].values() for p in v} <= \
            {"run", "jump", "cook"}


def test_profile_steps_write_a_trace(tmp_path):
    """profile_steps > 0 records the first epoch's first steps with
    torch.profiler into <run>/trace; the run goes on to its end."""
    data = make_synthetic_dataset(str(tmp_path), num_videos=6, feat_dim=16)
    cfg = PConfig().update(dict(loop_cfg(tmp_path, data), epoch=1,
                                profile_steps=1, device="cpu",
                                save_dir=str(tmp_path / "save")))
    folder = pathlib.Path(ploop.train(cfg))
    traces = list((folder / "trace").iterdir())
    assert traces and traces[0].stat().st_size > 0
    assert json.loads((folder / "info.json").read_text())["epoch"] == 0


def test_eval_cli_reads_a_checkpoint_with_train_state(runs):
    """The eval CLI evaluates the train loop's model-best.pth, which holds
    the optimizers, schedules and step beside the weights."""
    from gvl_tpu_torch import eval_cli
    folder = pathlib.Path(runs["port"]["resumed_folder"])
    raw = pckpt.CheckpointManager(str(folder)).restore_raw("model-best")
    assert {"optimizer", "scheduler", "step"} <= set(raw)
    res = eval_cli.main(["--eval_save_dir", str(folder.parent),
                         "--eval_folder", folder.name, "--eval_device", "cpu",
                         "--eval_batch_size", "3"])
    assert res["videos"] == 6
    assert "METEOR" in res["scores"]
