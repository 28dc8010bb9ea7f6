"""JAX (flax) parameters -> the port's state_dict.

The inverse of gvl_tpu.train.checkpoint.import_pytorch_state_dict, with its
conventions (checkpoint.py:127-131): Dense kernel (in, out) -> Linear weight
(out, in); Conv kernel (k, in, out) -> Conv1d weight (out, in, k); flax MHA
query/key/value kernels (C, H, Dh) -> in_proj_weight (3C, C); LSTM ih/hh
kernels transposed. Takes numpy, so it runs wherever the JAX parameters can
be saved as arrays (e.g. an .npz of the flattened tree).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from gvl_tpu_torch.models.gvl import GVLArch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def jax_params_to_state_dict(params_np: Mapping, arch: GVLArch
                             ) -> Dict[str, torch.Tensor]:
    """Map a GVLModel flax parameter tree ({'params': ...} or its inner
    dict, leaves numpy or array-likes) onto GVLModel(arch).state_dict()
    names. Raises if a flax parameter is left unmapped."""
    if "params" in params_np and isinstance(params_np["params"], Mapping):
        params_np = params_np["params"]
    src = _flatten(params_np)
    sd: Dict[str, np.ndarray] = {}
    read = set()

    def take(key: str) -> np.ndarray:
        if key not in src:
            raise KeyError(f"flax parameter {key} missing")
        read.add(key)
        return src[key]

    def dense(fp: str, tp: str):
        sd[f"{tp}.weight"] = take(f"{fp}/kernel").T
        sd[f"{tp}.bias"] = take(f"{fp}/bias")

    def norm(fp: str, tp: str):
        sd[f"{tp}.weight"] = take(f"{fp}/scale")
        sd[f"{tp}.bias"] = take(f"{fp}/bias")

    def msda(fp: str, tp: str):
        for sub in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            dense(f"{fp}/{sub}", f"{tp}.{sub}")

    def mha(fp: str, tp: str):
        C = arch.hidden_dim
        sd[f"{tp}.in_proj_weight"] = np.concatenate(
            [take(f"{fp}/{n}/kernel").reshape(C, C).T
             for n in ("query", "key", "value")])
        sd[f"{tp}.in_proj_bias"] = np.concatenate(
            [take(f"{fp}/{n}/bias").reshape(C) for n in ("query", "key", "value")])
        sd[f"{tp}.out_proj.weight"] = take(f"{fp}/out/kernel").reshape(C, C).T
        sd[f"{tp}.out_proj.bias"] = take(f"{fp}/out/bias")

    # ---- base encoder
    dense("base_encoder/pos_embed/duration_embed",
          "base_encoder.pos_embed.duration_embed_layer")
    for l in range(arch.num_feature_levels):
        fp, tp = f"base_encoder/input_proj_{l}", f"base_encoder.input_proj.{l}"
        sd[f"{tp}.0.weight"] = np.transpose(take(f"{fp}_conv/kernel"), (2, 1, 0))
        sd[f"{tp}.0.bias"] = take(f"{fp}_conv/bias")
        norm(f"{fp}_norm", f"{tp}.1")

    # ---- transformer
    sd["transformer.level_embed"] = take("level_embed")
    dense("reference_points", "transformer.reference_points")
    for i in range(arch.enc_layers):
        fp, tp = f"encoder/layer_{i}", f"transformer.encoder.layers.{i}"
        msda(f"{fp}/self_attn", f"{tp}.self_attn")
        norm(f"{fp}/norm1", f"{tp}.norm1")
        dense(f"{fp}/ffn/linear1", f"{tp}.linear1")
        dense(f"{fp}/ffn/linear2", f"{tp}.linear2")
        norm(f"{fp}/ffn/norm", f"{tp}.norm2")
    for i in range(arch.dec_layers):
        fp, tp = f"decoder_layer_{i}", f"transformer.decoder.layers.{i}"
        msda(f"{fp}/cross_attn", f"{tp}.cross_attn")
        mha(f"{fp}/self_attn", f"{tp}.self_attn")
        norm(f"{fp}/norm1", f"{tp}.norm1")
        norm(f"{fp}/norm2", f"{tp}.norm2")
        dense(f"{fp}/ffn/linear1", f"{tp}.linear1")
        dense(f"{fp}/ffn/linear2", f"{tp}.linear2")
        norm(f"{fp}/ffn/norm", f"{tp}.norm3")

    # ---- queries + per-layer heads
    sd["query_embed.weight"] = take("query_embed")
    for i in range(arch.dec_layers):
        dense(f"class_head_{i}", f"class_head.{i}")
        dense(f"count_head_{i}", f"count_head.{i}")
        for j in range(3):
            dense(f"bbox_head_{i}/layers_{j}", f"bbox_head.{i}.layers.{j}")

    # ---- caption heads (LSTM-DSA); a shared head repeats one flax module
    for k in range(arch.dec_layers):
        fp = f"caption_head_{0 if arch.share_caption_head else k}"
        tp = f"caption_head.{k}"
        sd[f"{tp}.embed.weight"] = take(f"{fp}/embed/embedding")
        dense(f"{fp}/logit", f"{tp}.logit")
        sd[f"{tp}.core.rnn.weight_ih_l0"] = take(f"{fp}/cell/ih/kernel").T
        sd[f"{tp}.core.rnn.weight_hh_l0"] = take(f"{fp}/cell/hh/kernel").T
        for sub in ("sampling_offsets", "value_proj"):
            dense(f"{fp}/dsa/{sub}", f"{tp}.core.deformable_att.{sub}")
        for sub in ("ctx2att", "h2att", "alpha_net"):
            dense(f"{fp}/dsa/{sub}", f"{tp}.core.{sub}")

    unmapped = sorted(set(src) - read)
    if unmapped:
        raise KeyError(f"flax parameters with no place in the port: {unmapped}")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in sd.items()}


def jax_grads_to_named(grads_np: Mapping, arch: GVLArch
                       ) -> Dict[str, torch.Tensor]:
    """Map a gradient tree of the flax parameters onto the names of
    GVLModel(arch).named_parameters(), by the mapping of the parameters
    themselves. A shared caption head is one module in both packages, so its
    gradient appears once, under `caption_head.0.*`, as named_parameters()
    lists it."""
    named = jax_params_to_state_dict(grads_np, arch)
    if arch.share_caption_head:
        named = {k: v for k, v in named.items()
                 if not (k.startswith("caption_head.")
                         and not k.startswith("caption_head.0."))}
    return named
