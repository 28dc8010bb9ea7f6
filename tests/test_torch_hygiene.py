"""gvl_tpu_torch imports torch and never JAX, flax, optax, transformers,
tokenizers, safetensors, regex or gvl_tpu, and on a CPU tensor its deformable-attention wrappers launch no
kernel.

The import checks run in one fresh process (`report`), which imports the
modules of each group one at a time, in the order below, and records after
each import which forbidden packages `sys.modules` holds; then it imports
every submodule and calls the wrappers on CPU tensors. A module that brings
in a forbidden package is the first after which one appears, whichever
group it is in, as it would be alone in a process of its own. Each test
reads its group's entries.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "transformers", "tokenizers",
             "safetensors", "regex", "gvl_tpu")

GROUPS = {
    "train": ("gvl_tpu_torch.train.state", "gvl_tpu_torch.train.criterion",
              "gvl_tpu_torch.train.lap", "gvl_tpu_torch.convert",
              "chip_smoke"),
    "text_side": ("gvl_tpu_torch.models.text_encoder",
                  "gvl_tpu_torch.models.text", "gvl_tpu_torch.models.gvl",
                  "gvl_tpu_torch.eval.postprocess",
                  "gvl_tpu_torch.eval.evaluate",
                  "gvl_tpu_torch.train.criterion", "gvl_tpu_torch.convert"),
    "eval_cli": ("gvl_tpu_torch.eval_cli", "gvl_tpu_torch.config",
                 "gvl_tpu_torch.cli", "gvl_tpu_torch.data",
                 "gvl_tpu_torch.data.features",
                 "gvl_tpu_torch.data.synthetic",
                 "gvl_tpu_torch.eval.metrics",
                 "gvl_tpu_torch.eval.metrics.spice",
                 "gvl_tpu_torch.utils.logging",
                 "gvl_tpu_torch.train.checkpoint"),
    "train_cli": ("gvl_tpu_torch.train_cli", "gvl_tpu_torch.train.loop",
                  "gvl_tpu_torch.train.rl"),
    "decode_heads": ("gvl_tpu_torch.utils.amp",
                     "gvl_tpu_torch.models.gpt_captioner",
                     "gvl_tpu_torch.models.captioner"),
    "gpt_tal": ("gvl_tpu_torch.models.gpt_captioner",
                "gvl_tpu_torch.eval.zeroshot_tal",
                "gvl_tpu_torch.models.transformer"),
    "published_files": ("gvl_tpu_torch.utils.hf_files",
                        "gvl_tpu_torch.models.bpe",
                        "gvl_tpu_torch.models.text_encoder",
                        "gvl_tpu_torch.train.import_reference",
                        "gvl_tpu_torch.import_cli",
                        "gvl_tpu_torch.eval.plots", "chip_smoke"),
    "backbone": ("gvl_tpu_torch.backbone.r2plus1d",
                 "gvl_tpu_torch.backbone.tsp",
                 "gvl_tpu_torch.backbone.untrimmed_dataset",
                 "gvl_tpu_torch.backbone.train_tsp",
                 "gvl_tpu_torch.backbone.import_torch",
                 "gvl_tpu_torch.train_tsp_cli", "gvl_tpu_torch.import_cli"),
}

_REPORT = textwrap.dedent("""
    import importlib, json, pkgutil, sys
    FORBIDDEN = %r + ("nltk",)
    groups = json.loads(sys.argv[1])
    rep = {"imports": {}}

    def forbidden():
        return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)

    rep["modules"] = {}
    for group, mods in groups.items():
        for mod in mods:
            importlib.import_module(mod)
            rep["imports"][group + ":" + mod] = forbidden()
            rep["modules"][group + ":" + mod] = sorted(
                m for m in sys.modules if m.split(".")[0] in ("cv2", "h5py"))
    from gvl_tpu_torch.ops import ms_deform_attn_1d, ms_deform_attn_1d_banded
    rep["launches_after_imports"] = [
        [fn.launches, fn.bf16_launches, fn.bwd_launches]
        for fn in (ms_deform_attn_1d, ms_deform_attn_1d_banded)]
    from gvl_tpu_torch.eval.metrics.meteor import _get_stemmer
    rep["stem"] = _get_stemmer().stem("running")
    import gvl_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(gvl_tpu_torch.__path__,
                                                   "gvl_tpu_torch.")]
    for n in names:
        importlib.import_module(n)
    rep["walk"] = [len(names), forbidden()]
    import torch
    g = torch.Generator().manual_seed(0)
    v = torch.randn(2, 12, 2, 4, generator=g)
    loc = torch.rand(2, 5, 2, 2, 3, generator=g)
    attn = torch.rand(2, 5, 2, 2, 3, generator=g)
    outs = [ms_deform_attn_1d(v, (8, 4), loc, attn),
            ms_deform_attn_1d(v, (8, 4), loc.bfloat16(), attn.bfloat16())]
    rep["cpu_wrapper"] = [[list(o.shape) for o in outs],
                          ms_deform_attn_1d.launches,
                          ms_deform_attn_1d.bf16_launches]
    print(json.dumps(rep))
""") % (FORBIDDEN,)


@pytest.fixture(scope="module")
def report():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _REPORT, json.dumps(GROUPS)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _clean(report, group, nltk=False):
    for mod in GROUPS[group]:
        bad = report["imports"][f"{group}:{mod}"]
        if not nltk:
            bad = [m for m in bad if m.split(".")[0] != "nltk"]
        assert not bad, (mod, bad)


def test_port_imports_no_jax_and_launches_nothing_on_cpu(report):
    """Every submodule imports; on CPU tensors, f32 or bf16 taps, the
    deformable-attention wrapper runs its plain version and counts no
    launch."""
    n, bad = report["walk"]
    assert n >= 48 and not [m for m in bad if m.split(".")[0] != "nltk"], bad
    shapes, launches, bf16_launches = report["cpu_wrapper"]
    assert shapes == [[2, 5, 8], [2, 5, 8]]
    assert launches == bf16_launches == 0


def test_train_modules_import_without_jax(report):
    _clean(report, "train")
    assert report["launches_after_imports"] == [[0, 0, 0], [0, 0, 0]]


def _tiny_namespace(**kw):
    import types
    return types.SimpleNamespace(**dict(dict(
        hidden_dim=32, nheads=2, enc_layers=1, dec_layers=2,
        transformer_ff_dim=32, num_feature_levels=2, num_queries=4,
        feature_dim=8, vocab_size=20, input_encoding_size=16, rnn_size=16,
        att_hid_size=16, max_caption_len=4, cap_nheads=1,
        cap_num_feature_levels=2, max_eseq_length=3), **kw))


def test_build_model_defaults_to_the_card_and_raises_without_one():
    """With no device given the model is built on the CUDA device; on a
    machine without one that raises instead of building on the CPU."""
    import torch
    from gvl_tpu_torch.models.gvl import build_model
    if torch.cuda.is_available():
        model = build_model(_tiny_namespace())
        assert next(model.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(_tiny_namespace())
    model = build_model(_tiny_namespace(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


def test_model_options_not_ported_raise_by_name():
    """The gpt2 caption head builds with the offline GPT-2 spec and refuses
    by name a pretrained GPT-2 whose files are not there, naming the paths
    searched (tests/test_torch_pretrained_text.py builds one from written
    files); the light, transformer and none heads, MLP class heads, heads
    shared across layers and remat_trunk build."""
    import torch
    from gvl_tpu_torch.models.gvl import build_model
    gpt = dict(caption_decoder_type="gpt2", prefix_length=3, prefix_size=48,
               gpt_model="gpt2", huggingface_cache_dir=".cache")
    with pytest.raises(FileNotFoundError,
                       match="pretrained GPT-2.*'gpt2'.*models--gpt2"):
        build_model(_tiny_namespace(**gpt), device="cpu")
    for kw in (dict(gpt, load_pretrained_language_model_from_config="offline"),
               dict(remat_trunk=True),
               dict(caption_decoder_type="light"),
               dict(caption_decoder_type="transformer", input_encoding_size=32,
                    num_layers=1),
               dict(caption_decoder_type="none"),
               dict(support_mlp_class_head=True, with_box_refine=0)):
        model = build_model(_tiny_namespace(**kw), device="cpu",
                            generator=torch.Generator().manual_seed(0))
        assert all(p.isfinite().all() for p in model.parameters()), kw
        if "prefix_size" in kw:
            # the prefix is the hidden_dim-wide event feature, as Flax
            # infers it, whatever prefix_size says
            assert model.caption_head[0].clip_project.model[0] \
                .in_features == 32


def test_text_side_modules_import_without_jax(report):
    """Each module of the contrastive text side imports none of JAX, flax,
    optax, transformers or gvl_tpu."""
    _clean(report, "text_side")


def test_gpt_head_and_tal_modules_import_without_jax(report):
    """The gpt2 caption head, zero-shot TAL and the checkpointed trunk
    layers import none of JAX, flax, optax, transformers or gvl_tpu."""
    _clean(report, "gpt_tal")


def test_decode_and_head_modules_import_without_jax(report):
    """The bf16 casts, the cached self-attention and the caption heads
    import none of JAX, flax, optax, transformers or gvl_tpu."""
    _clean(report, "decode_heads")


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is false."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_eval_cli_modules_import_without_jax(report):
    """The eval CLI and the framework-free modules it runs on (config, cli,
    data layer, metric harness, logging, checkpoint) import none of JAX,
    flax, optax, transformers or gvl_tpu; nor does the metric harness import
    nltk, which the card's machine lacks: it stems with its own copy."""
    _clean(report, "eval_cli", nltk=True)
    assert report["stem"] == "run"


def test_eval_cli_on_cuda_raises_without_a_card(tmp_path):
    """`--eval_device cuda` (the default) on a machine without a CUDA device
    raises before it reads the run directory, and nothing runs on the CPU:
    the run directory gains no file."""
    import torch
    from gvl_tpu_torch import eval_cli
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    run = tmp_path / "save" / "run"
    run.mkdir(parents=True)
    (run / "opts.json").write_text(json.dumps({"caption_loss_coef": 1.0}))
    for flags in (["--eval_device", "cuda"], []):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_cli.main(["--eval_save_dir", str(tmp_path / "save"),
                           "--eval_folder", "run"] + flags)
    assert sorted(os.listdir(run)) == ["opts.json"]


def test_train_cli_modules_import_without_jax(report):
    """The train CLI, the train loop and the SCST module import none of JAX,
    flax, optax, transformers, gvl_tpu or nltk."""
    _clean(report, "train_cli", nltk=True)


def test_published_file_modules_import_without_jax(report):
    """The HF file reader, the byte-level BPE, the text encoder's loader,
    the reference checkpoint importer and its CLI, the plots, and
    chip_smoke import none of JAX, flax, optax, transformers, tokenizers,
    safetensors, regex or gvl_tpu (they read the files themselves), nor
    nltk."""
    _clean(report, "published_files", nltk=True)


def test_import_cli_on_cuda_raises_without_a_card(tmp_path):
    """import_cli builds on the card unless given --device cpu: on a
    machine without one it raises before it writes anything."""
    import torch
    from gvl_tpu_torch import import_cli
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    (tmp_path / "cfg.yml").write_text(
        "enable_contrastive: false\ncaption_decoder_type: none\n"
        "caption_loss_coef: 0\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        import_cli.main(["--pth", str(tmp_path / "x.pth"), "--cfg_path",
                         str(tmp_path / "cfg.yml"), "--out",
                         str(tmp_path / "out")])
    assert sorted(os.listdir(tmp_path)) == ["cfg.yml"]


def test_backbone_modules_import_without_jax(report):
    """The TSP backbone, its extraction, sampler, trainer and importer, and
    the two CLIs that run them, import none of JAX, flax, optax,
    transformers or gvl_tpu, nor nltk; nor cv2 or h5py, which they read
    only when a video or an h5 file is opened."""
    _clean(report, "backbone", nltk=True)
    for mod in GROUPS["backbone"]:
        assert not [m for m in report["modules"][f"backbone:{mod}"]
                    if m.split(".")[0] in ("cv2", "h5py")], mod


def test_backbone_entry_points_need_the_card_unless_told_otherwise(
        tmp_path):
    """Without `device="cpu"` the extractor, the trainer, train_tsp_cli and
    import_cli --backbone ask for the card and raise where there is none,
    before they read or write anything."""
    import torch
    from gvl_tpu_torch import import_cli, train_tsp_cli
    from gvl_tpu_torch.backbone import train_tsp, tsp
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    calls = [
        lambda: tsp.extract_features([str(tmp_path / "v.avi")],
                                     str(tmp_path / "feats"),
                                     backbone="r3d_18"),
        lambda: train_tsp.TSPTrainer(
            train_tsp.TSPTrainConfig(backbone="r3d_18"), None, None, 1),
        lambda: train_tsp_cli.main(
            ["--root-dir", str(tmp_path), "--train-csv", "t.csv",
             "--valid-csv", "v.csv", "--label-columns", "a",
             "--label-mapping-jsons", "a.json"]),
        lambda: import_cli.main(["--backbone", "r3d_18", "--pth",
                                 str(tmp_path / "x.pth"), "--out",
                                 str(tmp_path / "out")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert os.listdir(tmp_path) == []
