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


@pytest.mark.parametrize("share_caption_head", [1, 0])
def test_round_trip_through_jax_importer(share_caption_head):
    cfg, _, params, port, _ = jax_world(share_caption_head=share_caption_head)
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
