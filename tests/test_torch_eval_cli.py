"""The port's framework-free modules and its eval CLI against the JAX
package, on the CPU.

- Configs: every cfgs/*.yml loads to the same Config in both packages (but
  `device`, "cuda" in the port); `parse_opts` agrees on three command lines;
  chip_smoke.py's workloads are their ymls but for the keys CUTS names.
- Data: `make_synthetic_dataset` writes the same files; `load_video_features`
  gives the same arrays (the port's numpy path against the JAX package's
  C++ loader); DenseVideoDataset + Batcher yield the same batches, every
  array exact, in eval and train mode, with 1 and 3 workers.
- Metrics: the same numbers, exactly, from the same JSONs; the port's copy
  of the English Snowball stemmer equals nltk's.
- Checkpoint: a save / restore_raw round trip is exact.
- The CLI end to end: the root eval.py (JAX) and `python -m
  gvl_tpu_torch.eval_cli --eval_device cpu`, each in a subprocess, on the
  synthetic world of tests/test_torch_grounding_eval.py with the same noisy
  weights (an orbax checkpoint for JAX, model-best.pth through convert.py
  for the port): the DVC, reranked and both grounding JSONs equal
  (structure exact, floats to rtol 1e-4 / atol 1e-4) and the scores JSON
  equal (same keys and approx, numbers within 1e-4).
- Which configs the CLI takes: each yml with the offline text encoder, and
  each refused as published (its pretrained text weights); the options the
  CLI refuses by name.
"""

import glob
import json
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gvl_tpu import cli as jax_cli
from gvl_tpu import config as jax_config
from gvl_tpu.data import dataset as jax_dataset
from gvl_tpu.data import features as jax_features
from gvl_tpu.data import synthetic as jax_synthetic
from gvl_tpu.eval import metrics as jax_metrics
from gvl_tpu_torch import cli, config, eval_cli
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.data import dataset, features, synthetic
from gvl_tpu_torch.eval import metrics
from gvl_tpu_torch.eval.metrics.meteor import FUNCTION_WORDS
from gvl_tpu_torch.eval.metrics.snowball import EnglishStemmer
from gvl_tpu_torch.models.gvl import GVLArch, GVLModel, build_model
from gvl_tpu_torch.models.text_encoder import load_text_encoder
from gvl_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_eval import assert_same_json
from tests.test_torch_grounding_eval import EVAL_BS, noisy_world
from tests.test_torch_train_loop import once_per_test_run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YMLS = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yml")))
OFFLINE = dict(load_pretrained_language_model_from_config="offline",
               offline_text_encoder_hidden=32, offline_text_encoder_layers=1)


def without_device(d):
    return {k: v for k, v in d.items() if k != "device"}


# ------------------------------------------------------------------ configs
def test_there_are_eleven_configs():
    assert len(YMLS) == 11


@pytest.mark.parametrize("yml", YMLS, ids=os.path.basename)
def test_config_loads_as_in_jax(yml):
    got = config.load_config(yml)
    assert got.device == "cuda" and jax_config.Config().device == "tpu"
    assert without_device(got.to_dict()) == \
        without_device(jax_config.load_config(yml).to_dict())
    assert got.effective_max_gt_events == \
        jax_config.load_config(yml).effective_max_gt_events


ARGVS = {
    "base_cfg_path": ["--cfg_path", os.path.join(ROOT, "cfgs",
                                                 "anet_tsp_dvc_rl.yml")],
    "lists": ["--gt_file_for_eval", "a.json", "b.json", "--cl_schedule_val",
              "0", "1", "--cl_schedule_time", "0", "3",
              "--rl_scorer_weights", "1", "2", "--lr", "3e-4",
              "--with_box_refine", "true"],
    "no_aux_loss": ["--no_aux_loss", "--id", "x", "--epoch", "4"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parse_opts_as_in_jax(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)         # parse_opts writes .tmp/opts.json
    got = cli.parse_opts(ARGVS[name])
    with open(".tmp/opts.json") as f:
        got_json = json.load(f)
    want = jax_cli.parse_opts(ARGVS[name])
    assert without_device(got.to_dict()) == without_device(want.to_dict())
    with open(".tmp/opts.json") as f:
        assert without_device(got_json) == without_device(json.load(f))
    assert got.device == "cuda"
    if name == "no_aux_loss":
        assert got.aux_loss is False
    if name == "base_cfg_path":
        assert got.only_ft_captioner and got.enable_contrastive


def test_chip_smoke_workloads_are_their_ymls_but_the_cuts():
    """Each workload's cfg equals its yml as the JAX package loads it, but
    for the keys its CUTS entry names (every one of which changes the
    value); the flagship trains with the published L2 1e-4 and 25
    epochs."""
    import chip_smoke
    for name, cuts in chip_smoke.CUTS.items():
        want = without_device(jax_config.load_config(
            os.path.join(ROOT, "cfgs", chip_smoke.YMLS[name])).to_dict())
        got = without_device(chip_smoke.workload_cfg(name))
        assert set(got) == set(want) | set(cuts), name
        assert {k for k in got if got[k] != want.get(k)} == set(cuts), name
    assert chip_smoke.ANET.cfg == chip_smoke.FLAGSHIP
    assert chip_smoke.LONG.cfg == chip_smoke.LONGVIDEO
    assert chip_smoke.FLAGSHIP["weight_decay"] == 1e-4
    assert chip_smoke.FLAGSHIP["epoch"] == 25
    assert not chip_smoke.FLAGSHIP_DVC["enable_contrastive"]
    assert chip_smoke.LONGVIDEO["eval_batch_size"] == 8


# --------------------------------------------------------------------- data
def test_synthetic_dataset_writes_the_same_files(tmp_path):
    got = synthetic.make_synthetic_dataset(str(tmp_path / "port"),
                                           num_videos=6, seed=5)
    want = jax_synthetic.make_synthetic_dataset(str(tmp_path / "jax"),
                                                num_videos=6, seed=5)
    assert got[3] == want[3]
    for name in ("anno.json", "grounding.json", "vocab.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    names = sorted(os.listdir(tmp_path / "jax" / "features"))
    assert sorted(os.listdir(tmp_path / "port" / "features")) == names
    assert len(names) == 6
    for n in names:
        assert (tmp_path / "port" / "features" / n).read_bytes() == \
            (tmp_path / "jax" / "features" / n).read_bytes(), n


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    """.npy features of 1, 5, 24 (the target length), 37 and 250 frames of
    16 floats, one of them float64, and c3d-named files of 500 floats."""
    d = tmp_path_factory.mktemp("feats")
    rs = np.random.RandomState(0)
    for i, t in enumerate((1, 5, 24, 37, 250)):
        np.save(d / f"v_{i:011d}.npy", rs.randn(t, 16).astype(np.float32))
    np.save(d / "v_00000000009.npy", rs.randn(11, 16))
    for i, t in enumerate((7, 30)):
        np.save(d / f"v_c3d{i:08d}.npy", rs.randn(t, 500).astype(np.float32))
    return str(d)


FEATURE_CASES = [dict(vf_types="npy", data_rescale=r, sample_method=m)
                 for r in (0, 1) for m in ("nearest", "linear")] + [
    dict(vf_types=["npy"], data_rescale=1, sample_method="linear"),
    dict(vf_types="c3d", data_rescale=1, sample_method="linear",
         data_norm=True)]


@pytest.mark.parametrize("case", FEATURE_CASES, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_load_video_features_as_in_jax(feature_dir, case):
    """Every array exact, with its dtype and shape, and the padding flag;
    a missing file too where the layout allows it (data_rescale 1)."""
    case = dict(case)
    kind = case.pop("vf_types")
    c3d = kind == "c3d"
    keys = ([f"v_c3d{i:08d}" for i in range(2)] if c3d else
            [f"v_{i:011d}" for i in (0, 1, 2, 3, 4, 9)])
    if case["data_rescale"]:
        keys.append("v_missing0000")
    folder = [feature_dir] if isinstance(kind, list) else feature_dir
    for key in keys:
        args = (key, kind, folder, 500 if c3d else 16)
        kw = dict(case, frame_embedding_num=24)
        got = features.load_video_features(*args, **kw)
        want = jax_features.load_video_features(*args, **kw)
        assert got[1] == want[1], key
        assert got[0].dtype == want[0].dtype == np.float32, key
        assert got[0].shape == want[0].shape, key
        assert np.array_equal(got[0], want[0]), key


def batch_world(tmp_path, **kw):
    anno, feats, vocab, vsize = jax_synthetic.make_synthetic_dataset(
        str(tmp_path), num_videos=7, feat_dim=16, min_events=1,
        max_events=8, seed=2)
    d = dict(val_caption_file=anno, visual_feature_folder=feats,
             visual_feature_type="npy", dict_file=vocab, vocab_size=vsize,
             feature_dim=16, frame_embedding_num=24, gt_proposal_sample_num=4,
             max_caption_len=6, seed=11, **kw)
    return anno, d


BATCH_MODES = {"eval": {}, "train": {},
               "train_cropped": dict(enable_video_cropping=True, crop_num=2)}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("mode", sorted(BATCH_MODES))
def test_batches_as_in_jax(tmp_path, mode, workers):
    """Two epochs of batches of 3: every array equal with its dtype, every
    list equal; train mode samples the GT events (gt_proposal_sample_num 4
    of up to 8) and shuffles with the same seed."""
    anno, d = batch_world(tmp_path, num_workers=workers, **BATCH_MODES[mode])
    train = mode != "eval"
    runs = []
    for pkg_config, pkg_dataset in ((config, dataset),
                                    (jax_config, jax_dataset)):
        cfg = pkg_config.Config().update(d)
        ds = pkg_dataset.DenseVideoDataset(anno, d["visual_feature_folder"],
                                           d["dict_file"], train, cfg)
        batcher = pkg_dataset.Batcher(ds, cfg, 3, shuffle=train)
        runs.append([b for _ in range(2) for b in batcher])
    got, want = runs
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and \
                    np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k
    if train:
        assert [b["keys"] for b in got[:3]] != [b["keys"] for b in got[3:]]


# ------------------------------------------------------------------ metrics
@pytest.fixture(scope="module")
def metric_files(tmp_path_factory):
    """The synthetic GT, its paragraphs, its grounding GT and a TAL GT, and
    predictions perturbed from the GT: boxes moved, a word of most
    sentences replaced, a few sentences dropped or empty."""
    tmp = tmp_path_factory.mktemp("metrics")
    anno, _, _, _ = jax_synthetic.make_synthetic_dataset(
        str(tmp), num_videos=8, feat_dim=4, min_events=1, max_events=6,
        seed=4)
    gt = json.load(open(anno))
    rs = np.random.RandomState(1)
    words = ["person", "cat", "quickly", "table", "jumps"]
    dvc, ground, tal_gt, tal = {}, {}, {}, {}
    for vid, v in gt.items():
        items = []
        for i, ((s, e), sent) in enumerate(zip(v["timestamps"],
                                               v["sentences"])):
            shift = rs.uniform(-0.2, 0.2) * (e - s)
            box = [max(0.0, s + shift), min(v["duration"], e + shift)]
            toks = sent.split()
            if rs.rand() < 0.7:
                toks[rs.randint(len(toks))] = words[rs.randint(len(words))]
            sent = "" if rs.rand() < 0.1 else " ".join(toks)
            if rs.rand() > 0.1:
                items.append({"timestamp": box, "sentence": sent,
                              "proposal_score": float(rs.rand())})
            ground[f"{vid[2:]}-{i}"] = [{"timestamp": box}]
        dvc[vid] = items
        labels = ["run", "jump"]
        tal_gt[vid] = {"subset": "validation", "annotations": [
            {"segment": ts, "label": labels[i % 2]}
            for i, ts in enumerate(v["timestamps"])]}
        tal[vid] = [{"segment": p["timestamp"], "label": labels[i % 2],
                     "score": p["proposal_score"]}
                    for i, p in enumerate(items)]
    files = {"gt": anno, "grounding_gt": str(tmp / "grounding.json")}
    for name, obj in (("dvc", {"results": dvc}),
                      ("grounding", {"results": ground}),
                      ("para", {k: " ".join(v["sentences"])
                                for k, v in gt.items()}),
                      ("tal_gt", {"database": tal_gt}),
                      ("tal", {"results": tal})):
        files[name] = str(tmp / f"pred_{name}.json")
        with open(files[name], "w") as f:
            json.dump(obj, f)
    return files


METRIC_CASES = {
    "eval_metrics_2018": lambda m, f: m.eval_metrics(
        f["dvc"], [f["gt"]], [f["para"]], "2018", verbose=True),
    "eval_metrics_2018_cider": lambda m, f: m.eval_metrics(
        f["dvc"], [f["gt"], f["gt"]], [], "2018_cider", verbose=True),
    "eval_metrics_2021": lambda m, f: m.eval_metrics(
        f["dvc"], [f["gt"]], [], "2021", verbose=False),
    "eval_metrics_grounding": lambda m, f: m.eval_metrics_grounding(
        f["grounding"], f["grounding_gt"]),
    "eval_soda": lambda m, f: m.eval_soda(f["dvc"], [f["gt"], f["gt"]]),
    "eval_para": lambda m, f: m.eval_para(f["dvc"], [f["para"]]),
    "eval_tal": lambda m, f: m.eval_tal(f["tal_gt"], f["tal"]),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_as_in_jax(metric_files, name):
    """The same keys and exactly the same numbers (the 2021 toolkit's
    random garbage captions from the same seed)."""
    random.seed(0)
    got = dict(METRIC_CASES[name](metrics, metric_files))
    random.seed(0)
    want = dict(METRIC_CASES[name](jax_metrics, metric_files))
    assert got == want
    assert len(got) >= 1 and any(
        isinstance(v, float) and v > 0 for v in got.values())


def test_stemmer_copy_equals_nltk(tmp_path):
    """The port's English Snowball stemmer equals nltk's on every word of
    the synthetic sentences, of the synthetic vocabulary, of chip_smoke's
    sentences and of METEOR's function words, and on words that reach
    each step of the algorithm."""
    from nltk.stem.snowball import SnowballStemmer
    import chip_smoke
    anno, _, vocab, _ = synthetic.make_synthetic_dataset(
        str(tmp_path), num_videos=8, feat_dim=4, seed=0)
    words = set(json.load(open(vocab))["word_to_ix"])
    for v in json.load(open(anno)).values():
        for s in v["sentences"]:
            words.update(s.split())
    words.update(chip_smoke.WORDS)
    words.update(FUNCTION_WORDS)
    words.update("generously communication arsenal skies dying proceeded "
                 "hopefulness rationalization Yelling ugly happily national "
                 "running hopping feed agreed sensibility skiing's "
                 "formalize electrical callousness conditional".split())
    ours, theirs = EnglishStemmer(), SnowballStemmer("english")
    assert len(words) > 200
    for w in sorted(words):
        assert ours.stem(w) == theirs.stem(w), w


# --------------------------------------------------------------- checkpoint
def tiny_port_cfg(**kw):
    return config.Config().update(dict(
        hidden_dim=32, nheads=2, enc_layers=1, dec_layers=2,
        transformer_ff_dim=32, num_feature_levels=2, num_queries=4,
        feature_dim=8, vocab_size=20, input_encoding_size=16, rnn_size=16,
        att_hid_size=16, max_caption_len=4, cap_nheads=1,
        cap_num_feature_levels=2, max_eseq_length=3, enable_contrastive=True,
        contrastive_hidden_size=8, caption_decoder_type="standard",
        with_box_refine=1, **OFFLINE, **kw))


def test_checkpoint_round_trip_is_exact(tmp_path):
    cfg = tiny_port_cfg()
    text = load_text_encoder(cfg, device="cpu")
    model = build_model(cfg, text.hidden_size, device="cpu",
                        generator=torch.Generator().manual_seed(3))
    ckpt = CheckpointManager(str(tmp_path / "run"))
    assert not ckpt.exists("model-best") and \
        ckpt.restore_raw("model-best") is None
    path = ckpt.save("model-best", model, text, 7)
    assert path.endswith("model-best.pth") and ckpt.exists("model-best")
    ckpt.save("model-last", model, None, 8)
    got = ckpt.restore_raw("model-best")
    assert got["epoch"] == 7 and set(got) == {"model", "text_encoder",
                                               "epoch"}
    for sd, module in ((got["model"], model), (got["text_encoder"], text)):
        want = module.state_dict()
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)
    other = build_model(cfg, text.hidden_size, device="cpu")
    other.load_state_dict(got["model"], strict=True)
    assert all(torch.equal(a, b) for a, b in zip(
        other.state_dict().values(), model.state_dict().values()))
    last = ckpt.restore_raw("model-last")
    assert last["text_encoder"] is None and last["epoch"] == 8


# ------------------------------------------------------------ CLI end to end
CLI_JSONS = {"dvc": "", "reranked": "_rerank_alpha0.3_temp2.0.json",
             "grounding": "_rerank_alpha0.3_temp2.0.json.grounding.json",
             "aux_grounding":
                 "_rerank_alpha0.3_temp2.0.json_aux.grounding.json"}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX eval.py and the port's CLI, in two subprocesses at once, on
    run directories holding the same opts.json and the same weights, once
    per test run (once_per_test_run). Returns {"jax" | "port": run
    directory}."""
    return once_per_test_run(
        tmp_path_factory, "torch_eval_cli_runs", run_both_clis,
        lambda root: {name: root / "save" / name for name in ("jax", "port")})


def run_both_clis(tmp):
    """cli_runs' work, in the directory `tmp`."""
    from gvl_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
    cfg, anno, _, _, bundle, _, params = noisy_world(tmp)
    gt = json.load(open(anno))
    para = tmp / "para.json"
    para.write_text(json.dumps({k: " ".join(v["sentences"])
                                for k, v in gt.items()}))
    cfg.update(dict(gt_file_for_eval=[anno], gt_file_for_para_eval=[str(para)]))
    runs = {name: tmp / "save" / name for name in ("jax", "port")}
    for d in runs.values():
        d.mkdir(parents=True)
        (d / "opts.json").write_text(json.dumps(cfg.to_dict(), default=str))
    JaxCheckpoints(str(runs["jax"])).save(
        "model-best", {"params": params, "text_params": bundle.params}, 1)
    Dt = bundle.hidden_size
    model = build_model(cfg, text_hidden_dim=Dt, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, Dt)), strict=True)
    text = load_text_encoder(cfg, device="cpu")
    text.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)
    CheckpointManager(str(runs["port"])).save("model-best", model, text, 1)

    common = ["--eval_save_dir", str(tmp / "save"), "--eval_checkpoint",
              "model-best", "--eval_batch_size", str(EVAL_BS),
              "--eval_gt_file_for_grounding", str(tmp / "grounding.json"),
              "--eval_device", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", GVL_XLA_CACHE_DIR="0",
               HF_HUB_OFFLINE="1", PYTHONPATH=ROOT)
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "eval.py"), "--eval_folder",
             "jax"] + common, cwd=str(tmp), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "gvl_tpu_torch.eval_cli", "--eval_folder",
             "port"] + common, cwd=str(tmp), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (name, err[-3000:])


@pytest.mark.parametrize("which", sorted(CLI_JSONS))
def test_cli_jsons_match_jax(cli_runs, which):
    got, want = (json.loads((cli_runs[k] / (
        "eval_model-best.json" + CLI_JSONS[which])).read_text())
        for k in ("port", "jax"))
    assert len(got["results"]) >= 5
    assert_same_json(got, want)


def test_cli_scores_match_jax(cli_runs):
    got, want = (json.loads((cli_runs[k] / "eval_model-best_scores.json")
                            .read_text()) for k in ("port", "jax"))
    assert set(got) == set(want)
    assert {"METEOR", "CIDEr", "Bleu_4", "soda_c", "MetaScore",
            "para_METEOR", "grounding_mIOU"} <= set(got)
    assert got.pop("approx") == want.pop("approx")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert got["grounding_mIOU"] > 0


# ------------------------------------------------- configs the CLI takes
def write_run(tmp_path, cfg_dict):
    run = tmp_path / "save" / "run"
    run.mkdir(parents=True)
    (run / "opts.json").write_text(json.dumps(cfg_dict, default=str))
    return ["--eval_save_dir", str(tmp_path / "save"), "--eval_folder", "run",
            "--eval_device", "cpu"]


@pytest.mark.parametrize("route", ["published", "offline_text_encoder"])
@pytest.mark.parametrize("yml", YMLS, ids=os.path.basename)
def test_cli_takes_or_refuses_each_config(tmp_path, yml, route):
    """As published, every config asks for the pretrained roberta-base
    files under huggingface_cache_dir (.cache); where they are not, the
    port refuses by name, naming the paths searched, before it reads any
    data (tests/test_torch_import_reference.py runs the flagship from a
    written cache); with the offline text encoder every config passes the
    CLI's checks and its model builds (on the meta device, at the config's
    widths)."""
    cfg = config.load_config(yml)
    if route == "offline_text_encoder":
        cfg.update(OFFLINE)
    argv = write_run(tmp_path, cfg.to_dict())
    if route == "published":
        assert cfg.huggingface_cache_dir == ".cache"
        with pytest.raises(FileNotFoundError,
                           match="pretrained_language_model='roberta-base'.*"
                           "models--roberta-base"):
            eval_cli.main(argv)
        assert os.listdir(tmp_path / "save" / "run") == ["opts.json"]
        return
    restored = eval_cli.restore_config(eval_cli.eval_parser().parse_args(
        argv))
    eval_cli.check_config(restored)
    with torch.device("meta"):
        GVLModel(GVLArch.from_config(restored, 32), device="meta")


# options the CLI refused until the ROADMAP Queue 1 item named ported them
REFUSED = {"--eval_data_parallel": "item 10"}


@pytest.mark.parametrize("option", ["--eval_enable_zeroshot_tal",
                                    "only_ft_class_head"])
def test_cli_takes_the_tal_options_once_refused(tmp_path, option):
    """Zero-shot TAL and the TAL probe's JSON, refused until they were
    ported, pass the CLI's checks on the flagship config (their runs
    against eval.py: tests/test_torch_tal.py)."""
    cfg = config.load_config(os.path.join(ROOT, "cfgs",
                                          "anet_tsp_msvg_dvc.yml"))
    cfg.update(OFFLINE)
    flags = []
    if option.startswith("--"):
        flags = [option]
    else:
        cfg.set(option, True)
    args = eval_cli.eval_parser().parse_args(write_run(tmp_path,
                                                       cfg.to_dict()) + flags)
    restored = eval_cli.restore_config(args)
    assert restored.get(option.lstrip("-")) is True
    eval_cli.check_config(restored)
    assert "refused" not in eval_cli.eval_parser().format_help().split(
        "--eval_enable_zeroshot_tal")[1].split("--eval_prompt")[0]


@pytest.mark.parametrize("option", sorted(REFUSED))
def test_cli_refuses_options_not_ported_by_name(tmp_path, cli_runs, option):
    """Each option once refused by name runs now: the CLI in this process
    with it, on a copy of the port's run of `cli_runs`, writes the DVC and
    grounding JSONs that run wrote without it (--eval_data_parallel:
    without a launcher's ranks the flag changes nothing, as eval.py's on
    one device; tests/test_torch_parallel.py runs it over 2 ranks)."""
    import shutil
    src = cli_runs["port"]
    shutil.copytree(src, tmp_path / "save" / "port")
    out = eval_cli.main([
        "--eval_save_dir", str(tmp_path / "save"), "--eval_folder", "port",
        "--eval_checkpoint", "model-best", "--eval_batch_size", str(EVAL_BS),
        "--eval_gt_file_for_grounding",
        str(src.parent.parent / "grounding.json"), "--eval_device", "cpu",
        option])
    assert out["videos"] >= 5
    for suffix in CLI_JSONS.values():
        name = "eval_model-best.json" + suffix
        assert_same_json(
            json.loads((tmp_path / "save" / "port" / name).read_text()),
            json.loads((src / name).read_text()))


def test_test_mode_caption_file_as_in_jax(tmp_path, monkeypatch):
    """--eval_mode test: the port reads the metadata CSV with the csv
    module (the JAX CLI with pandas) and writes the same file; the
    restored config evaluates it."""
    sys.path.insert(0, ROOT)
    try:
        import eval as jax_eval_cli
    finally:
        sys.path.remove(ROOT)
    monkeypatch.chdir(tmp_path)
    meta = tmp_path / "meta.csv"
    meta.write_text("video-name,video-duration,frame-rate\n"
                    "v_abc,12.5,30\nv_def,100,25\nv_0001,7.25,30\n")
    want = open(jax_eval_cli.create_fake_test_caption_file(str(meta))).read()
    path = eval_cli.create_fake_test_caption_file(str(meta))
    assert open(path).read() == want
    assert list(json.loads(want)) == ["v_abc", "v_def", "v_0001"]
    argv = write_run(tmp_path, {"caption_loss_coef": 1.0}) + [
        "--eval_mode", "test", "--test_video_meta_data_csv_path", str(meta),
        "--test_video_feature_folder", "feats"]
    cfg = eval_cli.restore_config(eval_cli.eval_parser().parse_args(argv))
    assert cfg.val_caption_file == ".tmp/fake_test_anno.json"
    assert cfg.visual_feature_folder == ["feats"]
