"""A reference GVL / PDVC checkpoint into the port
(gvl_tpu_torch.train.import_reference, gvl_tpu_torch.import_cli) against
the JAX package's importer (gvl_tpu/train/checkpoint.py
import_pytorch_checkpoint, tools/import_checkpoint.py), on the CPU.

The test writes the `.pth`: a model's state_dict in the reference layout,
with what a reference checkpoint carries beyond the port's state_dict (the
bbox heads aliased under `transformer.decoder.bbox_head.*`, the caption
DSA's dead `output_proj` / `attention_weights`, `text_encoder.*`), the
whole under "model". Cases: shared and cloned caption heads, and cloned
heads with keys missing and one the rules do not know. The JAX importer's
unused keys must equal the port's; its unfilled flax leaves must map,
through gvl_tpu_torch.convert, onto exactly the port's unfilled entries;
the imported weights equal the JAX import's, converted. Then
`tools/import_checkpoint.py` + `eval.py` (a subprocess) and `import_cli` +
`eval_cli` (in process) on one world whose text encoder is a tiny random
RoBERTa read from local files by both: the same eval JSONs and scores at
test_torch_eval_cli.py's tolerances. Last, the flagship yml as published,
but for huggingface_cache_dir pointing at a written cache, is refused by
none of the three CLIs. Cost: ~95 s in one process.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import gvl_tpu.train.loop as jloop
from gvl_tpu.config import Config as JConfig
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.train.checkpoint import import_pytorch_checkpoint
from gvl_tpu_torch import eval_cli, import_cli
from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.config import load_config
from gvl_tpu_torch.convert import jax_params_to_state_dict
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from gvl_tpu_torch.models.layers import init_params
from gvl_tpu_torch.train import loop as ploop
from gvl_tpu_torch.train.import_reference import (
    _slots, import_reference_checkpoint)
from tests.test_torch_eval import assert_same_json
from tests.test_torch_eval_cli import CLI_JSONS
from tests.test_torch_train_loop import jitted_init_params
from tests.test_torch_pretrained_text import (as_hub_cache, world_captions,
                                              write_roberta)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_DIM = 32


def world_cfg(root, text_dir, **kw):
    """tests/test_torch_grounding_eval.py's world (the flagship's text
    side at tiny widths), its text encoder read from `text_dir`."""
    anno, feats, vocab, vsize = make_synthetic_dataset(
        str(root), num_videos=5, feat_dim=16, min_events=2, max_events=6,
        seed=3)
    from tests.test_torch_text import FLAGSHIP_TEXT
    return dict(FLAGSHIP_TEXT, **dict(
        train_caption_file=anno, val_caption_file=anno,
        gt_file_for_eval=[anno], gt_file_for_para_eval=[],
        visual_feature_folder=feats, visual_feature_type="npy",
        dict_file=vocab, vocab_size=vsize, feature_dim=16,
        frame_embedding_num=24, hidden_dim=64, nheads=4, enc_layers=1,
        dec_layers=2, transformer_ff_dim=64, num_feature_levels=3,
        num_queries=8, gt_proposal_sample_num=4, max_caption_len=8,
        input_encoding_size=32, rnn_size=32, att_hid_size=32, cap_nheads=1,
        cap_num_feature_levels=3, with_box_refine=1,
        caption_decoder_type="standard", caption_loss_coef=1.0,
        count_loss_coef=0.5, max_eseq_length=6, eval_batch_size=2,
        msda_impl="ref", max_text_input_len=12, eval_enable_grounding=True,
        eval_disable_plot_hook=True, seed=7,
        load_pretrained_language_model_from_config="",
        pretrained_language_model=text_dir), **kw)


def jax_params(d: dict, seed: int = 0):
    """Parameters of the JAX model of `d`, drawn by shape (jax.eval_shape
    of its init: nothing compiles): normal(0, 0.05), LayerNorm scales
    around 1."""
    cfg = JConfig().update(d)
    model = jax_build_model(cfg, text_hidden_dim=TEXT_DIM)
    B, G, L = 2, cfg.effective_max_gt_events, cfg.max_text_input_len
    shapes = jax.eval_shape(
        functools.partial(model.init, method=model.init_all),
        jax.random.PRNGKey(0),
        jnp.zeros((B, cfg.frame_embedding_num, cfg.feature_dim)),
        jnp.ones((B, cfg.frame_embedding_num), bool), jnp.ones((B,)),
        captions=jnp.zeros((B, G, cfg.max_caption_len), jnp.int32),
        word_embed=jnp.zeros((B, G, L, TEXT_DIM)),
        token_mask=jnp.ones((B, G, L), bool), gt_mask=jnp.ones((B, G), bool))
    rs = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(shapes["params"], sep="/")
    return {"params": flax.traverse_util.unflatten_dict({
        k: (float(k.endswith("/scale"))
            + 0.05 * rs.randn(*s.shape)).astype(np.float32)
        for k, s in flat.items()}, sep="/")}


def reference_payload(sd: dict, arch: GVLArch, seed: int = 0) -> dict:
    """`sd` (the port's names) as a reference .pth holds it: the bbox heads
    again under transformer.decoder.bbox_head, the caption DSA's dead
    parameters, a text encoder's weights, all under "model"."""
    rs = np.random.RandomState(seed)
    out = {k: v.clone() for k, v in sd.items()}
    for k, v in sd.items():
        if k.startswith("bbox_head."):
            out["transformer.decoder." + k] = v.clone()
    for k in range(arch.dec_layers):
        p = f"caption_head.{k}.core.deformable_att"
        for sub in ("output_proj", "attention_weights"):
            w = out[f"{p}.value_proj.weight"]
            out[f"{p}.{sub}.weight"] = torch.from_numpy(
                rs.randn(*w.shape).astype(np.float32))
            out[f"{p}.{sub}.bias"] = torch.zeros(w.shape[0])
    out["text_encoder.embeddings.word_embeddings.weight"] = torch.ones(5, 3)
    return {"model": out, "epoch": 3}


CASES = {"shared": dict(share_caption_head=1),
         "cloned": dict(share_caption_head=0),
         "cloned_partial": dict(share_caption_head=0)}


@pytest.fixture(scope="module")
def text_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("roberta")
    write_roberta(str(root / "roberta"), world_captions(root),
                  hidden=TEXT_DIM)
    return str(root / "roberta")


@pytest.mark.parametrize("case", sorted(CASES))
def test_unused_and_unfilled_equal_the_jax_importer(tmp_path, text_dir,
                                                    case):
    d = world_cfg(tmp_path, text_dir, **CASES[case])
    src = jax_params(d)
    arch = GVLArch.from_config(PConfig().update(d), TEXT_DIM)
    payload = reference_payload(jax_params_to_state_dict(src, arch), arch)
    if case == "cloned_partial":
        sd = payload["model"]
        for k in [k for k in sd if k.startswith("caption_head.1.")]:
            del sd[k]
        del sd["class_head.1.bias"]
        sd["no_such_module.weight"] = torch.zeros(2)
    pth = str(tmp_path / "ref.pth")
    torch.save(payload, pth)

    moved = jax.tree_util.tree_map(lambda x: x + 1000.0, src)
    jnew, junused, junfilled = import_pytorch_checkpoint(
        pth, moved, n_heads=d["nheads"],
        share_caption_head=bool(d["share_caption_head"]))
    out, unused, unfilled = import_reference_checkpoint(
        pth, arch, share_caption_head=bool(d["share_caption_head"]))

    assert unused == junused
    assert any(k.endswith("attention_weights.weight") for k in
               payload["model"]) and not [k for k in unused if
                                          "deformable_att" in k]
    # JAX's unfilled leaves, mapped onto the port's names, by the NaN
    # they carry through the converter
    flat = flax.traverse_util.flatten_dict(jnew["params"], sep="/")
    for k in junfilled:
        flat[k] = np.full_like(flat[k], np.nan)
    image = jax_params_to_state_dict(
        flax.traverse_util.unflatten_dict(flat, sep="/"), arch)
    with torch.device("meta"):
        from gvl_tpu_torch.models.gvl import GVLModel
        slots = _slots(GVLModel(arch, device="meta"))
    canon = {a: s for s, names in slots.items() for a in names}
    want_unfilled = sorted({canon[k] for k, v in image.items()
                            if torch.isnan(v).any()})
    assert unfilled == want_unfilled
    if case == "cloned_partial":
        assert "no_such_module.weight" in unused
        assert "class_head.1.bias" in unfilled and any(
            k.startswith("caption_head.1.") for k in unfilled)
    else:
        assert unused == [] and unfilled == []
    # the port's import equals the JAX import, converted
    for k, v in out.items():
        assert torch.equal(v, image[k]), k
    assert set(out) | {a for s in unfilled for a in slots[s]} == set(image)


def test_import_cli_and_eval_cli_match_the_jax_tools(tmp_path, text_dir,
                                                     monkeypatch, capsys):
    """tools/import_checkpoint.py then eval.py, and import_cli then
    eval_cli, on one reference .pth and one yml: the DVC, reranked and
    both grounding JSONs equal (floats to 1e-4) and the scores within 1e-4.
    Both take the text encoder from the local RoBERTa files. The JAX tool
    runs in this process with its init jitted (its eager form compiles each
    op alone), eval.py in a subprocess beside the port's CLIs."""
    d = world_cfg(tmp_path, text_dir)
    src = jax_params(d, seed=1)
    arch = GVLArch.from_config(PConfig().update(d), TEXT_DIM)
    pth = tmp_path / "ref.pth"
    torch.save(reference_payload(jax_params_to_state_dict(src, arch), arch),
               pth)
    yml = tmp_path / "cfg.yml"
    yml.write_text(yaml.safe_dump(d))
    spec = importlib.util.spec_from_file_location(
        "import_checkpoint", os.path.join(ROOT, "tools",
                                          "import_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(jloop, "init_params", jitted_init_params)
    monkeypatch.setattr(sys, "argv", [
        "import_checkpoint.py", "--pth", str(pth), "--cfg_path", str(yml),
        "--out", str(tmp_path / "save" / "jax")])
    tool.main()
    out = capsys.readouterr().out
    assert "wrote" in out and "unmapped" not in out and \
        "left at init" not in out
    env = dict(os.environ, JAX_PLATFORMS="cpu", GVL_XLA_CACHE_DIR="0",
               HF_HUB_OFFLINE="1", PYTHONPATH=ROOT)
    evalf = ["--eval_save_dir", str(tmp_path / "save"), "--eval_checkpoint",
             "model-best", "--eval_batch_size", "2",
             "--eval_gt_file_for_grounding", str(tmp_path / "grounding.json"),
             "--eval_device", "cpu"]
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "eval.py"), "--eval_folder",
         "jax"] + evalf, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    res = import_cli.main(["--pth", str(pth), "--cfg_path", str(yml),
                           "--out", str(tmp_path / "save" / "port"),
                           "--device", "cpu"])
    assert res["unused"] == res["unfilled"] == []
    eval_cli.main(["--eval_folder", "port"] + evalf)
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    runs = {k: tmp_path / "save" / k for k in ("jax", "port")}
    for suffix in CLI_JSONS.values():
        got, want = (json.loads((runs[k] / ("eval_model-best.json" + suffix))
                                .read_text()) for k in ("port", "jax"))
        assert len(got["results"]) >= 5
        assert_same_json(got, want)
    got, want = (json.loads((runs[k] / "eval_model-best_scores.json")
                            .read_text()) for k in ("port", "jax"))
    assert set(got) == set(want) and "grounding_mIOU" in got
    assert got.pop("approx", None) == want.pop("approx", None)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)


def test_published_flagship_is_refused_by_no_cli(tmp_path, text_dir):
    """cfgs/anet_tsp_msvg_dvc.yml as published, but for
    huggingface_cache_dir pointing at a written hub cache of
    `roberta-base`: the eval and train CLIs' checks pass, the text encoder
    loads, and import_cli imports a reference .pth of the flagship at its
    published widths (the `--backbone` mode, a TSP video backbone, is
    ported: it reads the .pth it is given)."""
    cache = tmp_path / "cache"
    as_hub_cache(text_dir, str(cache), "roberta-base")
    text = open(os.path.join(ROOT, "cfgs", "anet_tsp_msvg_dvc.yml")).read()
    assert "huggingface_cache_dir: .cache\n" in text
    yml = tmp_path / "anet.yml"
    yml.write_text(text.replace("huggingface_cache_dir: .cache\n",
                                f"huggingface_cache_dir: {cache}\n"))
    cfg = load_config(str(yml))
    assert not cfg.load_pretrained_language_model_from_config
    eval_cli.check_config(cfg)
    ploop.check_config(cfg)
    arch = GVLArch.from_config(cfg, TEXT_DIM)
    model = build_model(cfg, TEXT_DIM, device="cpu")
    init_params(model, torch.Generator().manual_seed(3))
    torch.save(reference_payload(model.state_dict(), arch),
               tmp_path / "ref.pth")
    res = import_cli.main(["--pth", str(tmp_path / "ref.pth"), "--cfg_path",
                           str(yml), "--out", str(tmp_path / "run"),
                           "--device", "cpu"])
    assert res["unused"] == res["unfilled"] == []
    payload = torch.load(res["path"], weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(payload["model"][k], v), k
    assert payload["text_encoder"] is not None
    # --backbone (a TSP video backbone) reads its .pth: none is there
    with pytest.raises(FileNotFoundError, match="x.pth"):
        import_cli.main(["--pth", str(tmp_path / "x.pth"), "--out",
                         str(tmp_path / "b"), "--backbone", "r2plus1d_34",
                         "--device", "cpu"])
