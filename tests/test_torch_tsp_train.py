"""The TSP data path, extraction, trainer and CLIs of the port
(gvl_tpu_torch.backbone, train_tsp_cli, import_cli --backbone) against the
JAX package's (gvl_tpu.backbone, tools/train_tsp.py,
tools/import_checkpoint.py --backbone) on the CPU, on videos the tests
write with cv2.VideoWriter.

- tsp_batches: bit-equal clips, labels and GVF over two shuffled epochs and
  the eval order;
- extraction: decode_video_frames and make_clips bit-equal; features from
  one raw `.pth` through tools/import_checkpoint.py --backbone and JAX's
  extract_features against import_cli --backbone and the port's, within
  rtol 2e-4 / atol 2e-5 of each feature's max abs (the features pass 16
  frames of 112 x 112 through R3D-18); the port's from the raw `.pth` and
  from import_cli's file equal; sharding and skipping;
- TSPTrainer.fit, resume and valid_only from JAX's init (dropout 0 on both
  sides) at batch 4 of 4 x 32 x 32 clips: every history entry within
  rtol 2e-2 / atol 1e-3 (JAX's f32 gradients of layer1 are up to 2% off a
  float64 evaluation, tests/test_torch_backbone.py; the SGD steps carry
  that into the losses);
- train_tsp_cli against tools/train_tsp.py --debug on the same CSVs: the
  same history shape and keys, finite, the same files (each package from
  its own random init, so the numbers differ).
Cost: ~75 s in one process.
"""

import csv
import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from gvl_tpu.backbone import r2plus1d as jr2p  # noqa: E402
from gvl_tpu.backbone import train_tsp as jtrain  # noqa: E402
from gvl_tpu.backbone import tsp as jtsp  # noqa: E402
from gvl_tpu.backbone import untrimmed_dataset as jdata  # noqa: E402
from gvl_tpu.backbone.r2plus1d import TSPModel as JTSPModel  # noqa: E402
from gvl_tpu_torch import import_cli, train_tsp_cli  # noqa: E402
from gvl_tpu_torch.backbone import train_tsp as ptrain  # noqa: E402
from gvl_tpu_torch.backbone import tsp as ptsp  # noqa: E402
from gvl_tpu_torch.backbone import untrimmed_dataset as pdata  # noqa: E402
from gvl_tpu_torch.convert import jax_tsp_to_state_dict  # noqa: E402
from tests.test_backbone_import import VideoResNet, _randomize  # noqa: E402
from tests.test_torch_backbone import JittedInit  # noqa: E402
from tests.test_tsp_dataset import write_video  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tool(name):
    """A script of tools/ as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dataset_kw(root, gvf=True):
    """tests/test_tsp_dataset.py's world: two videos, three CSV rows (one
    label missing, one segment too short), a GVF directory."""
    for i in range(2):
        write_video(str(root / f"vid{i}.avi"))
    csv_path = str(root / "meta.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "fps", "t-start", "t-end", "video-duration",
                    "action-label", "temporal-region-label"])
        w.writerow(["vid0.avi", 10, 0.0, 3.5, 4.0, "run", "inside"])
        w.writerow(["vid1.avi", 10, 0.5, 4.0, 4.0, "", "outside"])
        w.writerow(["vid1.avi", 10, 0.0, 0.1, 4.0, "run", "inside"])
    gvf_dir = None
    if gvf:
        gvf_dir = str(root / "gvf")
        os.makedirs(gvf_dir, exist_ok=True)
        for i in range(2):
            np.save(os.path.join(gvf_dir, f"vid{i}.npy"),
                    np.random.RandomState(i).randn(512).astype(np.float32))
    return dict(csv_filename=csv_path, root_dir=str(root), clip_length=8,
                frame_rate=5, clips_per_segment=3,
                label_columns=["action-label", "temporal-region-label"],
                label_mappings=[{"run": 0, "jump": 1},
                                {"inside": 0, "outside": 1}],
                size=32, global_video_features=gvf_dir)


@pytest.mark.parametrize("train", [True, False])
def test_tsp_batches_are_bit_equal(tmp_path, train):
    """Both samplers on the same CSV and videos: two epochs of shuffled
    batches (train: temporal jittering, random crops and flips) or the
    eval order (uniform placement, centre crops), every array equal."""
    kw = dict(dataset_kw(tmp_path), temporal_jittering=train, train=train,
              seed=3)
    jds, pds = jdata.UntrimmedClipDataset(**kw), pdata.UntrimmedClipDataset(**kw)
    assert len(pds) == len(jds) == 6
    want = list(jdata.tsp_batches(jds, 2, shuffle=train, seed=5, epochs=2))
    got = list(pdata.tsp_batches(pds, 2, shuffle=train, seed=5, epochs=2))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"clips", "labels", "gvf"}
        np.testing.assert_array_equal(g["clips"], w["clips"])
        np.testing.assert_array_equal(g["gvf"], w["gvf"])
        for a, b in zip(g["labels"], w["labels"]):
            np.testing.assert_array_equal(a, b)
    assert -1 in np.concatenate([b["labels"][0] for b in got])


def test_extraction_and_backbone_import_match_jax(tmp_path, monkeypatch,
                                                  capsys):
    """One raw TSP `.pth` (R3D-18, fc heads in it): JAX's tool writes
    backbone.msgpack and its extract_features reads it; import_cli
    --backbone writes backbone.pth and the port's extract_features reads it
    or the raw `.pth`. Decoding and clips are bit-equal, the features
    within rtol 2e-4 / atol 2e-5 of their max abs; the shard split and the
    skip of written files hold."""
    vids = []
    for i, n in enumerate((40, 20)):
        vids.append(str(tmp_path / f"v{i}.avi"))
        write_video(vids[-1], n_frames=n)
    tm = _randomize(VideoResNet((2, 2, 2, 2), "3d"), seed=3)
    sd = {"features." + k: v for k, v in tm.state_dict().items()
          if not k.startswith("fc")}
    sd["fc1.weight"], sd["fc1.bias"] = torch.randn(3, 512), torch.zeros(3)
    pth = str(tmp_path / "tsp.pth")
    torch.save({"model": sd, "epoch": 4}, pth)

    frames = jtsp.decode_video_frames(vids[0])
    np.testing.assert_array_equal(ptsp.decode_video_frames(vids[0]), frames)
    assert frames.shape == (40, 112, 112, 3)
    clips = jtsp.make_clips((frames - jtsp.CLIP_MEAN) / jtsp.CLIP_STD)
    np.testing.assert_array_equal(
        ptsp.make_clips((frames - ptsp.CLIP_MEAN) / ptsp.CLIP_STD), clips)

    monkeypatch.setattr(sys, "argv", [
        "import_checkpoint.py", "--backbone", "r3d_18", "--pth", pth,
        "--out", str(tmp_path / "jax_bb")])
    monkeypatch.setattr(jr2p, "TSPModel", JittedInit)
    tool("import_checkpoint").main()
    model = JTSPModel(num_classes_list=(200,), backbone="r3d_18")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 112, 112, 3)), train=False))
    params = jtsp.load_backbone_checkpoint(
        str(tmp_path / "jax_bb" / "backbone.msgpack"),
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes), "r3d_18")
    want = jtsp.extract_features(vids[:1], str(tmp_path / "jax_feats"),
                                 params=params, model=model, batch_size=2)
    want = np.load(want[0])

    res = import_cli.main(["--backbone", "r3d_18", "--pth", pth, "--out",
                           str(tmp_path / "port_bb"), "--device", "cpu"])
    assert res["unused"] == res["unfilled"] == []
    got = {}
    for name, ckpt in (("import_cli", res["path"]), ("raw", pth)):
        out = str(tmp_path / f"feats_{name}")
        written = ptsp.extract_features(vids, out, batch_size=2,
                                        backbone="r3d_18", checkpoint=ckpt,
                                        device="cpu", num_shards=2,
                                        shard_id=0)
        assert written == [os.path.join(out, "v0.npy")]
        got[name] = np.load(written[0])
        # a written file is skipped
        assert ptsp.extract_features(vids, out, backbone="r3d_18",
                                     checkpoint=ckpt, device="cpu",
                                     num_shards=2, shard_id=0) == []
    np.testing.assert_array_equal(got["import_cli"], got["raw"])
    assert got["raw"].shape == want.shape == (3, 512)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["raw"] / scale, want / scale, rtol=2e-4,
                               atol=2e-5)
    assert "RANDOM-INIT" not in capsys.readouterr().out


SHAPE = (4, 32, 32, 3)


def trainer_batches(n, seed):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        clips = r.randn(4, *SHAPE).astype(np.float32) * 0.1
        labels = r.randint(0, 3, (4,))
        clips[..., 0] += (labels[:, None, None, None] - 1) * 1.0
        out.append({"clips": clips,
                    "labels": [labels, r.randint(-1, 2, (4,))]})
    return out


def test_trainer_fit_resume_and_valid_only_match_jax(tmp_path, monkeypatch):
    """TSPTrainer of each package from JAX's init, dropout 0: one epoch of 2
    steps with validation and checkpoints, then a resume (start_epoch 1,
    nothing left to train) and valid_only; every history number within
    rtol 2e-2 / atol 1e-3, the files each writes."""
    monkeypatch.setattr(jtrain, "TSPModel",
                        functools.partial(JittedInit, fc_dropout=0.0))
    kw = dict(backbone="r3d_18", num_classes_list=(3, 2), backbone_lr=1e-3,
              fc_lr=1e-2, epochs=1, lr_warmup_epochs=1, lr_milestones=(2,))
    cfg, pcfg = jtrain.TSPTrainConfig(**kw), ptrain.TSPTrainConfig(**kw)
    mk_tr = lambda ep: iter(trainer_batches(2, seed=ep))  # noqa: E731
    mk_va = lambda: iter(trainer_batches(2, seed=99))  # noqa: E731
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")

    def port_trainer(jt):
        t = ptrain.TSPTrainer(pcfg, mk_tr, mk_va, steps_per_epoch=2,
                              output_dir=pdir, device="cpu")
        t.model.load_state_dict(jax_tsp_to_state_dict(
            {"params": jt.params, "batch_stats": jt.batch_stats}, "r3d_18",
            (3, 2)), strict=True)
        t.model.dropout.p = 0.0
        return t

    jt = jtrain.TSPTrainer(cfg, mk_tr, mk_va, steps_per_epoch=2,
                           clip_shape=SHAPE, output_dir=jdir)
    pt = port_trainer(jt)
    want, got = jt.fit(), pt.fit()

    def close(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=1e-3,
                                           err_msg=k)

    close(got, want)
    assert all(h["avg_loss"] < 10 for h in got)
    assert {"epoch_0.pth", "checkpoint.pth", "metrics.jsonl"} <= \
        set(os.listdir(pdir))
    lines = open(os.path.join(pdir, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 1

    # the JAX trainer resumes in place (a fresh one would compile its steps
    # again), the port's as a fresh trainer
    jt2 = jt
    pt2 = ptrain.TSPTrainer(pcfg, mk_tr, mk_va, steps_per_epoch=2,
                            output_dir=pdir, device="cpu")
    assert jt2.resume() and pt2.resume()
    assert pt2.start_epoch == jt2.start_epoch == 1
    assert pt2.state.step == 2
    for k, v in pt.model.state_dict().items():
        assert torch.equal(pt2.model.state_dict()[k], v), k
    assert pt2.fit() == [] == jt2.fit()
    close(pt2.fit(valid_only=True), jt2.fit(valid_only=True))
    one = ptrain.TSPTrainer(pcfg, mk_tr, mk_va, steps_per_epoch=2,
                            device="cpu").fit(train_only_one_epoch=True)
    assert len(one) == 1 and "train_total_loss" in one[0] \
        and "avg_loss" not in one[0]


def test_train_tsp_cli_matches_the_jax_tool(tmp_path, capsys, monkeypatch):
    """train_tsp_cli and tools/train_tsp.py on --debug with the same CSVs,
    label files and flags: one epoch each, the same history keys, finite
    losses, a checkpoint of epoch 0 and metrics.jsonl; the history printed
    as JSON lines."""
    for sub in ("train", "valid"):
        (tmp_path / sub).mkdir()
        write_video(str(tmp_path / sub / "vid0.avi"))
        with open(tmp_path / f"{sub}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["filename", "fps", "t-start", "t-end",
                        "video-duration", "action-label",
                        "temporal-region-label"])
            w.writerow(["vid0.avi", 10, 0.0, 3.5, 4.0, "run", "inside"])
    (tmp_path / "actions.json").write_text(json.dumps(["run", "jump"]))
    (tmp_path / "regions.json").write_text(json.dumps(["inside", "outside"]))
    args = ["--root-dir", str(tmp_path),
            "--train-csv", str(tmp_path / "train.csv"),
            "--valid-csv", str(tmp_path / "valid.csv"),
            "--label-columns", "action-label", "temporal-region-label",
            "--label-mapping-jsons", str(tmp_path / "actions.json"),
            str(tmp_path / "regions.json"),
            "--backbone", "r3d_18", "--clip-len", "8", "--clip-size", "32",
            "--frame-rate", "5", "--clips-per-segment", "2",
            "--batch-size", "2", "--epochs", "1", "--lr-warmup-epochs", "1",
            "--lr-milestones", "4", "--debug"]
    monkeypatch.setattr(jtrain, "TSPModel", JittedInit)
    want = tool("train_tsp").main(args + ["--output-dir",
                                          str(tmp_path / "jax")])
    capsys.readouterr()
    out = str(tmp_path / "port")
    got = train_tsp_cli.main(args + ["--output-dir", out, "--device", "cpu"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()
               if l.startswith("{")]
    assert printed == got
    assert len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys()
    assert np.isfinite([v for v in got[0].values()]).all()
    assert os.path.exists(os.path.join(out, "epoch_0.pth"))
    assert os.path.exists(os.path.join(out, "metrics.jsonl"))
    assert train_tsp_cli.parse_args(args[:12]).batch_size == 32
