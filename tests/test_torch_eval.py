"""The port's EvalRunner against the JAX EvalRunner on the synthetic dataset
(tests/test_train_smoke.py build_world), contrastive off, with the same
(noisy) weights: the DVC JSON and the reranked JSON must be equal, with
sentences, query ids, labels and counts exact and floats to 1e-4. The
'long' case evaluates the same dataset at 300 frames (levels 300, 150, 75:
S = 525 >= 512), where the encoder runs the banded op, against the JAX
runner with msda_impl='pallas', its kernels in interpret mode."""

import contextlib

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from gvl_tpu.data.dataset import Batcher
from gvl_tpu.eval.evaluate import EvalRunner as JaxEvalRunner
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu_torch.convert import jax_params_to_state_dict
from gvl_tpu_torch.eval.evaluate import EvalRunner
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from tests.test_torch_model import add_noise
from tests.test_train_smoke import build_world


def assert_same_json(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_same_json(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=path)
    else:
        assert got == want, path


WORLDS = {"short": ({}, contextlib.nullcontext),
          "long": (dict(frame_embedding_num=300, msda_impl="pallas"),
                   pltpu.force_tpu_interpret_mode)}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def runs(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    cfg_kw, jax_context = WORLDS[request.param]
    cfg, ds, *_ = build_world(tmp, eval_disable_plot_hook=True, **cfg_kw)
    assert (sum(cfg.temporal_shapes()) >= 512) == (request.param == "long")
    cfg.enable_contrastive = False        # eval.py --eval_disable_contrastive
    model = jax_build_model(cfg)
    batcher = Batcher(ds, cfg, cfg.batch_size, shuffle=False)
    batch = next(iter(batcher))
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), jnp.asarray(batch["video_feats"]),
        jnp.asarray(batch["video_mask"]), jnp.asarray(batch["duration"]),
        captions=jnp.asarray(batch["captions"])))

    jr = JaxEvalRunner(cfg, model, None, ds.translator)
    jr.set_params(params, None)
    with jax_context():
        want_path, want_json, *_ = jr.run(batcher, str(tmp / "jax.json"))

    port = build_model(cfg, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg)), strict=True)
    got_path, got_json = EvalRunner(cfg, port, ds.translator).run(
        batcher, str(tmp / "port.json"))
    return len(ds), (want_path, want_json), (got_path, got_json)


def test_dvc_json_matches_jax(runs):
    n_videos, (_, want_json), (_, got_json) = runs
    assert len(got_json["results"]) == n_videos
    assert any(p["sentence"] for v in got_json["results"].values() for p in v)
    assert_same_json(got_json, want_json)


def test_reranked_json_matches_jax(runs):
    _, (want_path, _), (got_path, _) = runs
    assert got_path.endswith("_rerank_alpha0.3_temp2.0.json")
    assert want_path.endswith("_rerank_alpha0.3_temp2.0.json")
    with open(want_path) as f:
        want = json.load(f)
    with open(got_path) as f:
        got = json.load(f)
    assert_same_json(got, want)
