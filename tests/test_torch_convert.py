"""The weight bridge against the JAX package's own importer: JAX parameters
-> jax_params_to_state_dict -> the port's load_state_dict(strict=True) ->
the port's state_dict() -> gvl_tpu.train.checkpoint.import_pytorch_state_dict
must map every tensor and fill every JAX parameter, with equal values."""

import flax
import numpy as np
import pytest

from gvl_tpu.train.checkpoint import import_pytorch_state_dict
from gvl_tpu_torch.convert import jax_params_to_state_dict
from gvl_tpu_torch.models.gvl import GVLArch
from tests.test_torch_model import jax_world


# the last case: the tiny analogue of the long-video widths (more frames,
# queries and events, another feature width; the banded op has no parameters)
@pytest.mark.parametrize("share_caption_head, cfg_kw", [
    (1, {}), (0, {}),
    (1, dict(frame_embedding_num=300, num_queries=20, max_eseq_length=10))])
def test_round_trip_through_jax_importer(share_caption_head, cfg_kw):
    cfg, _, params, port, _ = jax_world(share_caption_head=share_caption_head,
                                        **cfg_kw)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    new, unused, unfilled = import_pytorch_state_dict(
        sd, params, n_heads=cfg.nheads,
        share_caption_head=bool(share_caption_head))
    assert unused == []
    assert unfilled == []
    want = flax.traverse_util.flatten_dict(params["params"], sep="/")
    got = flax.traverse_util.flatten_dict(new["params"], sep="/")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_unmapped_jax_parameter_raises():
    cfg, _, params, _, _ = jax_world()
    extra = {"params": dict(params["params"], stray={"kernel": np.zeros(2)})}
    with pytest.raises(KeyError, match="stray"):
        jax_params_to_state_dict(extra, GVLArch.from_config(cfg))


# the text side: shared projections (the flagship), projections per layer
# with the background embedding, cross fusion, the learned position table
TEXT_ROUND_TRIPS = {
    "flagship": {},
    "own_projections_e2t": dict(disable_cl_proj_layer_share_weight=True,
                                enable_e2t_cl=True),
    "cross_fusion": dict(enable_cross_model_fusion=True),
    "learned_pos": dict(sentence_pos_embedding_type="learned"),
}


@pytest.mark.parametrize("case", sorted(TEXT_ROUND_TRIPS))
def test_round_trip_with_the_text_side_on(case):
    """JAX parameters with the contrastive text side -> the port's model
    state_dict, with the text encoder's `text_encoder.*` tensors beside it,
    as the reference PDVC state_dict holds them -> import_pytorch_state_dict:
    nothing unused, nothing unfilled, every value equal."""
    import torch

    from gvl_tpu_torch.models.text_encoder import load_text_encoder
    from tests.test_torch_text import DT, text_world
    cfg, _, params, port, _, _ = text_world(**TEXT_ROUND_TRIPS[case])
    cfg.update(dict(load_pretrained_language_model_from_config="offline",
                    offline_text_encoder_hidden=DT,
                    offline_text_encoder_layers=1))
    text = load_text_encoder(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    tsd = text.state_dict()
    assert tsd and all(k.startswith("text_encoder.") for k in tsd)
    sd = {k: v.numpy() for k, v in {**port.state_dict(), **tsd}.items()}
    assert any(k.startswith("sentence_context_model.") for k in sd)
    new, unused, unfilled = import_pytorch_state_dict(
        sd, params, n_heads=cfg.nheads, share_caption_head=True)
    assert unused == []
    assert unfilled == []
    want = flax.traverse_util.flatten_dict(params["params"], sep="/")
    got = flax.traverse_util.flatten_dict(new["params"], sep="/")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
