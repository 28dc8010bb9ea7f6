"""gvl_tpu_torch imports torch and never JAX, flax, optax, transformers or
gvl_tpu, and on a CPU tensor its deformable-attention wrapper launches no
kernel."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_launches_nothing_on_cpu():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gvl_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            gvl_tpu_torch.__path__, "gvl_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "transformers", "gvl_tpu"))
        assert not bad, bad
        import torch
        from gvl_tpu_torch.ops import ms_deform_attn_1d
        g = torch.Generator().manual_seed(0)
        v = torch.randn(2, 12, 2, 4, generator=g)
        loc = torch.rand(2, 5, 2, 2, 3, generator=g)
        attn = torch.rand(2, 5, 2, 2, 3, generator=g)
        out = ms_deform_attn_1d(v, (8, 4), loc, attn)
        assert out.shape == (2, 5, 8)
        assert ms_deform_attn_1d.launches == 0
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 46      # every submodule was imported


def test_train_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        import gvl_tpu_torch.train.state, gvl_tpu_torch.train.criterion
        import gvl_tpu_torch.train.lap, gvl_tpu_torch.convert
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "transformers", "gvl_tpu"))
        assert not bad, bad
        from gvl_tpu_torch.ops import (ms_deform_attn_1d,
                                       ms_deform_attn_1d_banded)
        for fn in (ms_deform_attn_1d, ms_deform_attn_1d_banded):
            assert fn.launches == fn.bwd_launches == 0
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
    import pytest
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
    import pytest
    from gvl_tpu_torch.models.gvl import build_model
    for kw, match in ((dict(caption_decoder_type="light"), "light"),
                      (dict(support_mlp_class_head=True), "MLP class heads"),
                      (dict(with_box_refine=0), "with_box_refine")):
        with pytest.raises(NotImplementedError, match=match):
            build_model(_tiny_namespace(**kw), device="cpu")


def test_text_side_modules_import_without_jax():
    """Each module of the contrastive text side, alone in a fresh process,
    imports none of JAX, flax, optax, transformers or gvl_tpu."""
    for mod in ("gvl_tpu_torch.models.text_encoder",
                "gvl_tpu_torch.models.text", "gvl_tpu_torch.models.gvl",
                "gvl_tpu_torch.eval.postprocess",
                "gvl_tpu_torch.eval.evaluate", "gvl_tpu_torch.train.criterion",
                "gvl_tpu_torch.convert"):
        code = textwrap.dedent(f"""
            import sys
            import {mod}
            bad = sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "transformers", "gvl_tpu"))
            assert not bad, bad
        """)
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (mod, proc.stderr)


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line where
    torch.cuda.is_available() is false."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("this machine has a CUDA device")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_eval_cli_modules_import_without_jax():
    """The eval CLI and the framework-free modules it runs on (config, cli,
    data layer, metric harness, logging, checkpoint), each alone in a fresh
    process, import none of JAX, flax, optax, transformers or gvl_tpu; nor
    does the metric harness import nltk, which the card's machine lacks."""
    for mod in ("gvl_tpu_torch.eval_cli", "gvl_tpu_torch.config",
                "gvl_tpu_torch.cli", "gvl_tpu_torch.data",
                "gvl_tpu_torch.data.features",
                "gvl_tpu_torch.data.synthetic", "gvl_tpu_torch.eval.metrics",
                "gvl_tpu_torch.eval.metrics.spice",
                "gvl_tpu_torch.utils.logging",
                "gvl_tpu_torch.train.checkpoint"):
        code = textwrap.dedent(f"""
            import sys
            import {mod}
            from gvl_tpu_torch.eval.metrics.meteor import _get_stemmer
            assert _get_stemmer().stem("running") == "run"
            bad = sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "transformers", "gvl_tpu",
                "nltk"))
            assert not bad, bad
        """)
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (mod, proc.stderr)


def test_eval_cli_on_cuda_raises_without_a_card(tmp_path):
    """`--eval_device cuda` (the default) on a machine without a CUDA device
    raises before it reads the run directory, and nothing runs on the CPU:
    the run directory gains no file."""
    import json
    import pytest
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


def test_train_cli_modules_import_without_jax():
    """The train CLI, the train loop and the SCST module, each alone in a
    fresh process, import none of JAX, flax, optax, transformers, gvl_tpu
    or nltk."""
    for mod in ("gvl_tpu_torch.train_cli", "gvl_tpu_torch.train.loop",
                "gvl_tpu_torch.train.rl"):
        code = textwrap.dedent(f"""
            import sys
            import {mod}
            bad = sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "transformers", "gvl_tpu",
                "nltk"))
            assert not bad, bad
        """)
        env = dict(os.environ, PYTHONPATH=ROOT)
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, (mod, proc.stderr)
