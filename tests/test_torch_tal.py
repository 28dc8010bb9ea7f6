"""Temporal action localization (TAL) in the port against the JAX package:
the linear probe's TAL JSON (only_ft_class_head) and zero-shot TAL.

One world, tests/test_torch_grounding_eval.py's (the flagship's text side
at tiny widths, a frozen offline RoBERTa, grounding eval on, five videos at
eval batch 2), whose events carry action labels of three classes, with a
class file and a TAL ground-truth file, under only_ft_class_head with three
classes and no caption head (as tests/test_tal_probe.py); the same noisy
weights on both sides.
- In process: both EvalRunners with the class names embedded
  (`enable_zeroshot_tal`), through each package's `run_validation`. The DVC
  JSON equal (floats to 1e-4) with every prediction's tal_cl_scores and
  aux_tal_cl_scores within 1e-5 and in [-1, 1]; the TAL JSON equal; the
  validation scores equal (TAL_Average_mAP from eval_tal among them, to
  1e-6); `convert_dvc_to_zeroshot_tal` on the same DVC JSON writes the same
  file as the JAX converter.
- The CLIs: the root eval.py in a subprocess and `eval_cli.main` in this
  process, both with --eval_enable_zeroshot_tal (and --eval_enable_grounding
  0) on run directories with the same weights: the DVC JSON (class scores
  within 1e-5) and the probe's TAL JSON equal.
Cost: ~70 s in one process, beside which the JAX CLI's subprocess runs
(~45 s), once per test run (once_per_test_run); the CLIs run without
grounding, which tests/test_torch_eval_cli.py covers.
"""

import functools
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvl_tpu.data.dataset import Batcher, DenseVideoDataset
from gvl_tpu.eval.evaluate import EvalRunner as JaxEvalRunner
from gvl_tpu.eval.zeroshot_tal import \
    convert_dvc_to_zeroshot_tal as jax_convert
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models.text_encoder import load_text_encoder as jax_text_encoder
from gvl_tpu.train import loop as jloop
from gvl_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from gvl_tpu_torch import eval_cli
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.eval.zeroshot_tal import convert_dvc_to_zeroshot_tal
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.models.text_encoder import load_text_encoder
from gvl_tpu_torch.train import loop as ploop
from gvl_tpu_torch.train.checkpoint import CheckpointManager
from gvl_tpu_torch.utils.logging import create_logger
from tests.test_torch_eval import assert_same_json
from tests.test_torch_grounding_eval import EVAL_BS, G, grounding_cfg
from tests.test_torch_model import add_noise
from tests.test_torch_train_loop import once_per_test_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("running", "jumping", "cooking")
PROMPTED = [f"a video of {c}" for c in CLASSES]
SCORE_TOL = 1e-5


def tal_world(tmp):
    """(cfg, dataset, eval batcher, JAX text bundle, JAX model, noisy JAX
    params, port model, port text encoder): the grounding world with action
    labels and only_ft_class_head."""
    cls_path = tmp / "classes.txt"
    cls_path.write_text("\n".join(CLASSES))
    cfg, anno = grounding_cfg(
        tmp, only_ft_class_head=True, num_classes=len(CLASSES),
        action_classes_path=str(cls_path),
        tal_gt_file=str(tmp / "tal_gt.json"), caption_decoder_type="none",
        caption_loss_coef=0.0, gt_file_for_eval=[], gt_file_for_para_eval=[],
        eval_gt_file_for_grounding=str(tmp / "grounding.json"))
    data = json.load(open(anno))
    gt = {"database": {}, "taxonomy": [], "version": "1.3"}
    rs = np.random.RandomState(0)
    for vid, v in data.items():
        labels = [CLASSES[rs.randint(len(CLASSES))] for _ in v["timestamps"]]
        v["action_labels"] = labels
        gt["database"][vid[2:]] = {
            "subset": "validation",
            "annotations": [{"segment": ts, "label": lab}
                            for ts, lab in zip(v["timestamps"], labels)]}
    json.dump(data, open(anno, "w"))
    (tmp / "tal_gt.json").write_text(json.dumps(gt))
    ds = DenseVideoDataset(anno, cfg.visual_feature_folder, cfg.dict_file,
                           False, cfg)
    batcher = Batcher(ds, cfg, cfg.eval_batch_size, shuffle=False)
    bundle = jax_text_encoder(cfg)
    Dt = bundle.hidden_size
    model = jax_build_model(cfg, text_hidden_dim=Dt)
    batch = next(iter(batcher))
    ids, tmask = bundle.tokenize(batch["captions_raw"], G,
                                 cfg.max_text_input_len)
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), jnp.asarray(batch["video_feats"]),
        jnp.asarray(batch["video_mask"]), jnp.asarray(batch["duration"]),
        word_embed=jnp.zeros((EVAL_BS, G, cfg.max_text_input_len, Dt)),
        token_mask=jnp.asarray(tmask) > 0,
        gt_mask=jnp.asarray(batch["gt_mask"]),
        captions=jnp.asarray(batch["captions"])))
    port = build_model(cfg, text_hidden_dim=Dt, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, Dt)), strict=True)
    text = load_text_encoder(cfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)
    return cfg, ds, batcher, bundle, model, params, port, text


CLI_FLAGS = ("--eval_batch_size", str(EVAL_BS), "--eval_device", "cpu",
             "--eval_enable_grounding", "0",
             "--eval_enable_zeroshot_tal", "--show_all_results", "0")


def compute_tal(tmp):
    """Everything the tests read, in `tmp`: eval.py starts on its run
    directory in a subprocess, both packages' run_validation with zero-shot
    TAL on run beside it, then eval_cli.main. Returns the validation scores,
    the runners' class embeddings and TAL JSON paths, and the folders."""
    w = tal_world(tmp)
    cfg, ds, batcher, bundle, model, params, port, text = w
    for name in ("jax", "port"):
        d = tmp / "save" / name
        d.mkdir(parents=True)
        (d / "opts.json").write_text(json.dumps(cfg.to_dict(), default=str))
    JaxCheckpoints(str(tmp / "save" / "jax")).save(
        "model-best", {"params": params, "text_params": bundle.params}, 1)
    CheckpointManager(str(tmp / "save" / "port")).save("model-best", port,
                                                      text, 1)
    env = dict(os.environ, JAX_PLATFORMS="cpu", GVL_XLA_CACHE_DIR="0",
               HF_HUB_OFFLINE="1", PYTHONPATH=ROOT)
    with open(tmp / "jax_cli.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "eval.py"), "--eval_folder",
             "jax", "--eval_save_dir", str(tmp / "save"),
             "--eval_gt_file_for_grounding", str(tmp / "grounding.json"),
             *CLI_FLAGS], cwd=str(tmp), env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        assert ds.name_map is not None and batcher.ds is ds
        jr = JaxEvalRunner(cfg, model, bundle, ds.translator)
        jr.set_params(params, bundle.params)
        jr.enable_zeroshot_tal(PROMPTED)
        pr = EvalRunner(cfg, port, ds.translator, text)
        pr.enable_zeroshot_tal(PROMPTED)
        scores, folders = {}, {}
        for name in ("jax", "port"):
            folders[name] = tmp / name
            folders[name].mkdir()
            logger = create_logger(str(folders[name]), "val.log")
            if name == "jax":
                state = types.SimpleNamespace(params=params,
                                              text_params=bundle.params)
                scores[name] = jloop.run_validation(
                    cfg, jr, state, bundle, batcher, str(folders[name]), 0,
                    logger)
            else:
                scores[name] = ploop.run_validation(
                    cfg, pr, batcher, str(folders[name]), 0, logger)
        eval_cli.main(["--eval_folder", "port", "--eval_save_dir",
                       str(tmp / "save"), "--eval_gt_file_for_grounding",
                       str(tmp / "grounding.json"), *CLI_FLAGS])
        assert proc.wait(timeout=600) == 0, \
            (tmp / "jax_cli.log").read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    runners = {"jax": dict(class_embeds=np.asarray(jr.class_embeds),
                           last_tal_json=jr.last_tal_json),
               "port": dict(class_embeds=pr.class_embeds.numpy(),
                            last_tal_json=pr.last_tal_json)}
    return dict(scores=scores, runners=runners, folders=folders,
                cli={name: tmp / "save" / name for name in ("jax", "port")})


def write_tal(root):
    """compute_tal's result, pickled into `root`."""
    with open(root / "result.pkl", "wb") as f:
        pickle.dump(compute_tal(root), f)


@pytest.fixture(scope="module")
def tal(tmp_path_factory):
    """compute_tal's result, computed once per test run."""
    def load(root):
        with open(root / "result.pkl", "rb") as f:
            return pickle.load(f)

    return once_per_test_run(tmp_path_factory, "torch_tal", write_tal, load)


@pytest.fixture(scope="module")
def validated(tal):
    """Both packages' run_validation with zero-shot TAL on: (their scores,
    their runners' class embeddings and TAL JSONs, the run directories)."""
    runners = {k: types.SimpleNamespace(**v)
               for k, v in tal["runners"].items()}
    return tal["scores"], runners, tal["folders"]


def read(path):
    with open(path) as f:
        return json.load(f)


def assert_same_tal_json(got, want):
    """DVC JSONs equal, the class scores within SCORE_TOL."""
    def strip(d):
        return {vid: [{k: v for k, v in p.items() if "tal_cl" not in k}
                      for p in items] for vid, items in d["results"].items()}

    assert_same_json(strip(got), strip(want))
    n = 0
    for vid, items in want["results"].items():
        for g, w in zip(got["results"][vid], items):
            for k in ("tal_cl_scores", "aux_tal_cl_scores"):
                assert len(g[k]) == len(CLASSES)
                assert np.all(np.abs(g[k]) <= 1 + 1e-6)
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=SCORE_TOL)
                n += 1
    assert n > 0


def test_validation_dvc_json_carries_jax_class_scores(validated):
    _, _, folders = validated
    got = read(folders["port"] / "pred_epoch0.json")
    want = read(folders["jax"] / "pred_epoch0.json")
    assert len(got["results"]) == 5
    assert_same_tal_json(got, want)


def test_probe_tal_json_matches_jax(validated):
    """The TAL submission of the probe: every video without its `v_`, each
    prediction's class index named, its segment and proposal score."""
    _, runners, folders = validated
    assert runners["port"].last_tal_json == str(
        folders["port"] / "pred_epoch0.tal.json")
    got, want = (read(runners[k].last_tal_json) for k in ("port", "jax"))
    assert got["version"] == "VERSION 1.3"
    assert set(got["results"]) == {k[2:] for k in read(
        folders["port"] / "pred_epoch0.json")["results"]}
    labels = {p["label"] for v in got["results"].values() for p in v}
    assert labels and labels <= set(CLASSES)
    assert_same_json(got, want)


def test_validation_scores_match_jax_with_the_tal_map(validated):
    scores, *_ = validated
    got, want = scores["port"], scores["jax"]
    assert "TAL_Average_mAP" in got and np.isfinite(got["TAL_Average_mAP"])
    assert set(got) == set(want)
    np.testing.assert_allclose(got["TAL_Average_mAP"],
                               want["TAL_Average_mAP"], rtol=0, atol=1e-6)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_class_embeddings_match_jax(validated):
    _, runners, _ = validated
    got = runners["port"].class_embeds
    want = np.asarray(runners["jax"].class_embeds)
    assert got.shape == (len(CLASSES), 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bg", [False, True])
def test_zeroshot_converter_writes_the_jax_file(validated, tmp_path, bg):
    """Both converters on the port's DVC JSON (with the background class
    allowed or not): the same submission, labels among the class names."""
    _, _, folders = validated
    src = str(folders["port"] / "pred_epoch0.json")
    names = list(CLASSES)
    got = read(convert_dvc_to_zeroshot_tal(src, names, str(tmp_path / "p"),
                                           alpha=0.5, enable_bg_class=bg))
    want = read(jax_convert(src, names, str(tmp_path / "j"), alpha=0.5,
                            enable_bg_class=bg))
    assert got == want
    items = [p for v in got["results"].values() for p in v]
    assert items and {p["label"] for p in items} <= set(CLASSES)
    assert convert_dvc_to_zeroshot_tal(src, names).endswith(
        "pred_epoch0.json.tal_proc.json")


@pytest.fixture(scope="module")
def cli_runs(tal):
    """eval.py (JAX, a subprocess) and eval_cli.main (in process) with
    --eval_enable_zeroshot_tal on run directories holding the same opts and
    weights. Returns {"jax" | "port": run directory}."""
    return tal["cli"]


def test_cli_zeroshot_json_matches_jax(cli_runs):
    got, want = (read(cli_runs[k] / "eval_model-best.json")
                 for k in ("port", "jax"))
    assert len(got["results"]) == 5
    assert_same_tal_json(got, want)


def test_cli_probe_tal_json_matches_jax(cli_runs):
    got, want = (read(cli_runs[k] / "eval_model-best.tal.json")
                 for k in ("port", "jax"))
    assert got["results"]
    assert_same_json(got, want)
