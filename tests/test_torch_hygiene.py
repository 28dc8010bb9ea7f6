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
    assert int(proc.stdout.strip()) >= 10      # every submodule was imported
