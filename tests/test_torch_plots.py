"""The port's copy of the diagnostic plots (gvl_tpu_torch.eval.plots) and
EvalRunner's plot hook (gvl_tpu_torch.eval.evaluate.plot_hook) against the
JAX package's (gvl_tpu/eval/plots.py, evaluate.py:506-529), on the JSONs
of tests/test_qualitative_plots.py: each plot writes the same files, byte
for byte, and returns the same value; the hook writes what the JAX block
writes under each setting of eval_disable_plot_hook and
eval_save_qualitative_plots, and writes nothing, without raising, where
matplotlib cannot be imported. Cost: ~15 s in one process.
"""

import os
import sys
import types

import pytest

from gvl_tpu.eval import plots as jplots
from gvl_tpu_torch.eval import plots as pplots
from gvl_tpu_torch.eval.evaluate import plot_hook
from tests.test_qualitative_plots import make_world


def listing(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def rel(value, root):
    """`value` with the paths under `root` made relative."""
    if isinstance(value, str):
        return os.path.relpath(value, root) if value.startswith(root) \
            else value
    if isinstance(value, dict):
        return {k: rel(v, root) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [rel(v, root) for v in value]
    return value


PLOTS = {
    "score_vs_video_length": lambda m, w, out: m.plot_score_vs_video_length(
        w[1], w[0], out_png=os.path.join(out, "len.png")),
    "proposal_distribution": lambda m, w, out: m.plot_proposal_distribution(
        w[1], out_png=os.path.join(out, "dist.png")),
    "split_results_by_duration": lambda m, w, out:
        m.split_results_by_duration(w[1], w[0], out_dir=out),
    "visualize_video_results": lambda m, w, out: m.visualize_video_results(
        {"ours": w[1], "base": w[2]}, w[0], out_dir=out),
    "find_good_samples": lambda m, w, out: m.find_good_samples(
        w[0], {"ours": w[1], "base": w[2]}, "ours"),
}


@pytest.mark.parametrize("name", sorted(PLOTS))
def test_plots_match_jax(tmp_path, name):
    world = make_world(tmp_path)
    results = {}
    for pkg, mod in (("jax", jplots), ("port", pplots)):
        out = str(tmp_path / pkg)
        os.makedirs(out)
        results[pkg] = (rel(PLOTS[name](mod, world, out), out),
                        listing(out))
    assert results["port"] == results["jax"]
    if name != "find_good_samples":
        assert results["port"][1], "no file written"


def jax_hook_files(world, tmp_path, disable, qualitative):
    """What the JAX EvalRunner's hook block (evaluate.py:506-529) writes
    beside a copy of the DVC JSON, by its own calls."""
    d = tmp_path / "jax_hook"
    d.mkdir()
    dvc = str(d / "pred.json")
    open(dvc, "w").write(open(world[1]).read())
    if not disable:
        jplots.plot_proposal_distribution(dvc)
    if qualitative:
        jplots.split_results_by_duration(dvc, world[0])
        jplots.visualize_video_results({"model": dvc}, world[0],
                                       out_dir=dvc + "_timelines")
    return listing(str(d))


@pytest.mark.parametrize("qualitative", [False, True])
@pytest.mark.parametrize("disable", [False, True])
def test_plot_hook_writes_or_skips_as_the_flags_say(tmp_path, disable,
                                                    qualitative):
    world = make_world(tmp_path)
    d = tmp_path / "port_hook"
    d.mkdir()
    dvc = str(d / "pred.json")
    open(dvc, "w").write(open(world[1]).read())
    cfg = types.SimpleNamespace(eval_disable_plot_hook=disable,
                                eval_save_qualitative_plots=qualitative,
                                gt_file_for_eval=[world[0]])
    plot_hook(cfg, dvc)
    got = listing(str(d))
    assert got == jax_hook_files(world, tmp_path, disable, qualitative)
    assert ("pred.png" in got) == (not disable)
    assert any(k.startswith("pred.json_timelines") for k in got) == \
        qualitative


def test_plot_hook_writes_nothing_without_matplotlib(tmp_path, monkeypatch):
    """As on a machine without matplotlib (the card's): no file, no
    error; the eval goes on."""
    world = make_world(tmp_path)
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    d = tmp_path / "hook"
    d.mkdir()
    dvc = str(d / "pred.json")
    open(dvc, "w").write(open(world[1]).read())
    plot_hook(types.SimpleNamespace(eval_disable_plot_hook=False,
                                    eval_save_qualitative_plots=True,
                                    gt_file_for_eval=[world[0]]), dvc)
    assert sorted(os.listdir(d)) == ["pred.json"]
