"""gvl_tpu_torch imports torch and never JAX, flax or gvl_tpu, and on a CPU
tensor its deformable-attention wrapper launches no kernel."""

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
                                            "gvl_tpu"))
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
    assert int(proc.stdout.strip()) >= 14      # every submodule was imported


def test_train_modules_import_without_jax():
    code = textwrap.dedent("""
        import sys
        import gvl_tpu_torch.train.state, gvl_tpu_torch.train.criterion
        import gvl_tpu_torch.train.lap, gvl_tpu_torch.convert
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "gvl_tpu"))
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
    for kw, match in ((dict(enable_contrastive=True), "contrastive"),
                      (dict(caption_decoder_type="light"), "light"),
                      (dict(support_mlp_class_head=True), "MLP class heads"),
                      (dict(with_box_refine=0), "with_box_refine")):
        with pytest.raises(NotImplementedError, match=match):
            build_model(_tiny_namespace(**kw), device="cpu")


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
