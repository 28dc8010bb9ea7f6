"""JAX (flax) parameters -> the port's state_dict.

The inverse of gvl_tpu.train.checkpoint.import_pytorch_state_dict, with its
conventions (checkpoint.py:127-131): Dense kernel (in, out) -> Linear weight
(out, in); Conv kernel (k, in, out) -> Conv1d weight (out, in, k); flax MHA
query/key/value kernels (C, H, Dh) -> in_proj_weight (3C, C), or for the
BERT-style sentence block separate query/key/value weights (C, C); LSTM
ih/hh kernels transposed. `flax_roberta_to_state_dict` maps the HF Flax
RoBERTa tree of the text encoder onto HF `RobertaModel` names under
`text_encoder.`, which are also the names of the text encoder's
parameters, so it maps the tree's gradients too. Takes numpy, so it runs
wherever the JAX parameters can be saved as arrays (e.g. an .npz of the
flattened tree).

The trunk's query inputs: `reference_points` -> `transformer.
reference_points` in query mode; in a two-stage model (arch.two_stage,
initialised with proposals, gvl_tpu/train/loop.py:73-74) `pos_trans` and
`pos_trans_norm` -> `transformer.pos_trans` and `transformer.
pos_trans_norm` instead, as each JAX tree holds only its mode's.

Heads (flax path -> state_dict name; i a decoder layer, k a caption head
index, j a layer of an MLP; a shared flax module, index 0, fills every port
index):
- class heads: `class_head_{i}` -> `class_head.{i}` (Linear), or with
  support_mlp_class_head `class_head_{i}/layers_{j}` ->
  `class_head.{i}.layers.{j}`; `count_head_{i}`, `bbox_head_{i}/layers_{j}`
  likewise; without box refinement one shared head, `*_0`.
- 'standard' caption head: the reference LSTM_DSA names (`embed`, `logit`,
  `core.rnn.weight_ih_l0` / `weight_hh_l0` <- `cell/ih`, `cell/hh`,
  `core.deformable_att.{sampling_offsets,value_proj}` <- `dsa/*`,
  `core.{ctx2att,h2att,alpha_net}` <- `dsa/*`).
- 'light': `embed`, `logit`, `cell.weight_ih_l0` / `cell.weight_hh_l0` <-
  `cell/ih`, `cell/hh` (the Flax paths).
- 'transformer': `embed`, `logits`, and for each layer n
  `self_attn.{n}.{query,key,value,out}` <- `self_attn_{n}/*` (DenseGeneral
  kernels (E, H, Dh) and (H, Dh, E) flattened), `dim_project.{n}`,
  `cross_attn.{n}.{sampling_offsets,attention_weights,value_proj,
  output_proj}`, `norm{1,2,3}.{n}`, `ffn{1,2}.{n}` <- the `_{n}` paths.
- 'gpt2' (the reference ClipCap / HF GPT-2 names, models/gpt_captioner.py):
  `gpt.transformer.{wte,wpe}` <- `gpt/{wte,wpe}/embedding`; for each block
  i `gpt.transformer.h.{i}.ln_{1,2}` <- `gpt/ln{1,2}_{i}`,
  `attn.c_attn` (Conv1D (E, 3E)) <- the `gpt/attn_{i}/{query,key,value}`
  kernels (E, H, Dh) flattened and concatenated in that order, `attn.c_proj`
  <- `gpt/attn_{i}/out` ((H, Dh, E) flattened), `mlp.c_fc`, `mlp.c_proj` <-
  `gpt/fc_{i}`, `gpt/proj_{i}` (Dense kernels are Conv1D's orientation: no
  transpose); `gpt.transformer.ln_f`. The MLP mapper `clip_project.model.
  {0,2}` (Linear) <- `clip_project/fc{1,2}`; the transformer mapper the
  Flax paths (`Dense_0`, `prefix_const`, `attn_{i}` as the transformer
  head's self_attn, `ln1_{i}`, `ffn1_{i}`, `ffn2_{i}`, `ln2_{i}`).
  gvl_tpu/train/checkpoint.py:366-455 import_hf_gpt2_state_dict is the
  bridge back.
- 'none': no parameters.
The JAX package's `import_pytorch_state_dict` maps only Linear class heads
(checkpoint.py:263-264) and the 'standard' caption head (:326-352); the
other heads' keys are the ones it leaves unused and unfilled
(tests/test_torch_caption_heads.py names them).
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
    take, dense, norm = _readers(src, sd, read)

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
    if arch.two_stage:
        dense("pos_trans", "transformer.pos_trans")
        norm("pos_trans_norm", "transformer.pos_trans_norm")
    else:
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

    # ---- queries + per-layer heads (shared without box refinement)
    sd["query_embed.weight"] = take("query_embed")
    for i in range(arch.dec_layers):
        fi = i if arch.with_box_refine else 0
        if arch.support_mlp_class_head:
            for j in range(3):
                dense(f"class_head_{fi}/layers_{j}",
                      f"class_head.{i}.layers.{j}")
        else:
            dense(f"class_head_{fi}", f"class_head.{i}")
        dense(f"count_head_{fi}", f"count_head.{i}")
        for j in range(3):
            dense(f"bbox_head_{fi}/layers_{j}", f"bbox_head.{i}.layers.{j}")

    # ---- caption heads; a shared head repeats one flax module
    for k in range(arch.dec_layers):
        fp = f"caption_head_{0 if arch.share_caption_head else k}"
        _caption_head(arch, fp, f"caption_head.{k}", take, dense, norm, msda,
                      sd)

    if arch.enable_contrastive:
        _text_side(arch, take, dense, norm, sd)

    return _finish(src, sd, read)


def _readers(src: Dict[str, np.ndarray], sd: Dict, read: set):
    """take(flax key), dense(flax path, port name) and norm(...) over the
    flattened tree `src`, writing into `sd` and recording what was read."""
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

    return take, dense, norm


def _finish(src: Dict, sd: Dict, read: set) -> Dict[str, torch.Tensor]:
    unmapped = sorted(set(src) - read)
    if unmapped:
        raise KeyError(f"flax parameters with no place in the port: {unmapped}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def jax_gpt2_head_to_state_dict(params_np: Mapping, spec
                                ) -> Dict[str, torch.Tensor]:
    """A GPT2Captioner's own flax tree ({'params': ...} or its inner dict)
    -> the state_dict names of gvl_tpu_torch.models.gpt_captioner
    .GPT2Captioner(spec), by the 'gpt2' map of the module docstring."""
    if "params" in params_np and isinstance(params_np["params"], Mapping):
        params_np = params_np["params"]
    src = _flatten(params_np)
    sd: Dict[str, np.ndarray] = {}
    read = set()
    take, dense, norm = _readers(src, sd, read)
    arch = GVLArch(caption_decoder_type="gpt2", gpt_n_embd=spec.n_embd,
                   gpt_n_layer=spec.n_layer, gpt_n_head=spec.n_head,
                   gpt_mapping_type=spec.mapping_type,
                   prefix_num_mapping_layer=spec.prefix_num_mapping_layer)
    _gpt2_head(arch, "", "", take, dense, norm, sd)
    return _finish(src, sd, read)


def _caption_head(arch: GVLArch, fp: str, tp: str, take, dense, norm, msda,
                  sd) -> None:
    """One caption head of caption_decoder_type (the map in the module
    docstring)."""
    kind = arch.caption_decoder_type
    if kind == "none":
        return
    if kind == "gpt2":
        _gpt2_head(arch, fp + "/", tp + ".", take, dense, norm, sd)
        return
    sd[f"{tp}.embed.weight"] = take(f"{fp}/embed/embedding")
    if kind in ("standard", "light"):
        cell = "core.rnn" if kind == "standard" else "cell"
        dense(f"{fp}/logit", f"{tp}.logit")
        sd[f"{tp}.{cell}.weight_ih_l0"] = take(f"{fp}/cell/ih/kernel").T
        sd[f"{tp}.{cell}.weight_hh_l0"] = take(f"{fp}/cell/hh/kernel").T
    if kind == "standard":
        for sub in ("sampling_offsets", "value_proj"):
            dense(f"{fp}/dsa/{sub}", f"{tp}.core.deformable_att.{sub}")
        for sub in ("ctx2att", "h2att", "alpha_net"):
            dense(f"{fp}/dsa/{sub}", f"{tp}.core.{sub}")
    if kind != "transformer":
        return
    dense(f"{fp}/logits", f"{tp}.logits")
    for n in range(arch.cap_num_layers):
        _dense_general_attn(f"{fp}/self_attn_{n}", f"{tp}.self_attn.{n}",
                            take, sd)
        dense(f"{fp}/dim_project_{n}", f"{tp}.dim_project.{n}")
        msda(f"{fp}/cross_attn_{n}", f"{tp}.cross_attn.{n}")
        for m in (1, 2, 3):
            norm(f"{fp}/norm{m}_{n}", f"{tp}.norm{m}.{n}")
        dense(f"{fp}/ffn1_{n}", f"{tp}.ffn1.{n}")
        dense(f"{fp}/ffn2_{n}", f"{tp}.ffn2.{n}")


def _dense_general_attn(fa: str, ta: str, take, sd) -> None:
    """Flax attention with DenseGeneral projections -> CachedSelfAttention's
    Linear `query`, `key`, `value`, `out`."""
    for sub in ("query", "key", "value"):
        w = take(f"{fa}/{sub}/kernel")                         # (E, H, Dh)
        sd[f"{ta}.{sub}.weight"] = w.reshape(w.shape[0], -1).T
        sd[f"{ta}.{sub}.bias"] = take(f"{fa}/{sub}/bias").reshape(-1)
    w = take(f"{fa}/out/kernel")                               # (H, Dh, E)
    sd[f"{ta}.out.weight"] = w.reshape(-1, w.shape[-1]).T
    sd[f"{ta}.out.bias"] = take(f"{fa}/out/bias")


def _gpt2_head(arch: GVLArch, fp: str, tp: str, take, dense, norm,
               sd) -> None:
    """The ClipCap head (the map in the module docstring); fp and tp are
    the head's flax path and port name prefixes, '' or with their
    separator."""
    E = arch.gpt_n_embd
    g, tg = f"{fp}gpt", f"{tp}gpt.transformer"
    sd[f"{tg}.wte.weight"] = take(f"{g}/wte/embedding")
    sd[f"{tg}.wpe.weight"] = take(f"{g}/wpe/embedding")
    for i in range(arch.gpt_n_layer):
        th, fa = f"{tg}.h.{i}", f"{g}/attn_{i}"
        norm(f"{g}/ln1_{i}", f"{th}.ln_1")
        norm(f"{g}/ln2_{i}", f"{th}.ln_2")
        qkv = ("query", "key", "value")
        sd[f"{th}.attn.c_attn.weight"] = np.concatenate(
            [take(f"{fa}/{n}/kernel").reshape(E, E) for n in qkv], axis=1)
        sd[f"{th}.attn.c_attn.bias"] = np.concatenate(
            [take(f"{fa}/{n}/bias").reshape(E) for n in qkv])
        sd[f"{th}.attn.c_proj.weight"] = take(f"{fa}/out/kernel").reshape(E, E)
        sd[f"{th}.attn.c_proj.bias"] = take(f"{fa}/out/bias")
        for src, dst in (("fc", "c_fc"), ("proj", "c_proj")):
            sd[f"{th}.mlp.{dst}.weight"] = take(f"{g}/{src}_{i}/kernel")
            sd[f"{th}.mlp.{dst}.bias"] = take(f"{g}/{src}_{i}/bias")
    norm(f"{g}/ln_f", f"{tg}.ln_f")
    m, tm = f"{fp}clip_project", f"{tp}clip_project"
    if arch.gpt_mapping_type == "mlp":
        dense(f"{m}/fc1", f"{tm}.model.0")
        dense(f"{m}/fc2", f"{tm}.model.2")
        return
    dense(f"{m}/Dense_0", f"{tm}.Dense_0")
    sd[f"{tm}.prefix_const"] = take(f"{m}/prefix_const")
    for i in range(arch.prefix_num_mapping_layer):
        _dense_general_attn(f"{m}/attn_{i}", f"{tm}.attn_{i}", take, sd)
        for n in ("ln1", "ln2"):
            norm(f"{m}/{n}_{i}", f"{tm}.{n}_{i}")
        for n in ("ffn1", "ffn2"):
            dense(f"{m}/{n}_{i}", f"{tm}.{n}_{i}")


def _text_side(arch: GVLArch, take, dense, norm, sd) -> None:
    """The contrastive projections (shared: one flax module, every port
    index), word and sentence context and the background embedding
    (gvl.py:272-313; checkpoint.py:270-321)."""
    def proj(fp: str, tp: str):
        if arch.enable_multilayer_projection:
            for j in range(2):
                dense(f"{fp}/layers_{j}", f"{tp}.layers.{j}")
        else:
            dense(fp, tp)

    own = arch.disable_cl_proj_layer_share_weight
    for i in range(arch.dec_layers):
        proj(f"cl_proj_event_{i if own else 0}",
             f"contrastive_projection_event.{i}")
    for i in range(1 + int(arch.enable_sentence_context_modeling)):
        proj(f"cl_proj_text_{i if own else 0}",
             f"contrastive_projection_text.{i}")
    if arch.enable_e2t_cl:
        sd["background_embed"] = take("background_embed")
    if arch.enable_word_context_modeling and \
            arch.word_context_modeling_type == "attention_pool":
        dense("word_context/w1", "word_context_model.w1")
        dense("word_context/w2", "word_context_model.w2")
    if not arch.enable_sentence_context_modeling:
        return
    D = arch.text_hidden_dim
    fp, top = "sentence_context", "sentence_context_model"

    def bert_attn(fa: str, ta: str):
        for n in ("query", "key", "value"):
            sd[f"{ta}.self.{n}.weight"] = \
                take(f"{fa}/{n}/kernel").reshape(D, D).T
            sd[f"{ta}.self.{n}.bias"] = take(f"{fa}/{n}/bias").reshape(D)
        sd[f"{ta}.output.dense.weight"] = \
            take(f"{fa}/out/kernel").reshape(D, D).T
        sd[f"{ta}.output.dense.bias"] = take(f"{fa}/out/bias")

    for i in range(arch.sentence_modeling_layer_num):
        tp = f"{top}.transformer_block.layer.{i}"
        bert_attn(f"{fp}/self_attn_{i}", f"{tp}.attention")
        norm(f"{fp}/norm1_{i}", f"{tp}.attention.output.LayerNorm")
        if arch.enable_cross_model_fusion:
            bert_attn(f"{fp}/cross_attn_{i}", f"{tp}.crossattention")
            norm(f"{fp}/norm_cross_{i}",
                 f"{tp}.crossattention.output.LayerNorm")
        dense(f"{fp}/ffn1_{i}", f"{tp}.intermediate.dense")
        dense(f"{fp}/ffn2_{i}", f"{tp}.output.dense")
        norm(f"{fp}/norm2_{i}", f"{tp}.output.LayerNorm")
    if arch.enable_cross_model_fusion:
        dense(f"{fp}/memory_projection", f"{top}.memory_projection")
    if arch.enable_sentence_pos_embedding and \
            arch.sentence_pos_embedding_type != "cosine":
        sd[f"{top}.pos_table.weight"] = take(f"{fp}/pos_table")


def flax_roberta_to_state_dict(params_np: Mapping,
                               prefix: str = "text_encoder."
                               ) -> Dict[str, torch.Tensor]:
    """Map an HF `FlaxRobertaModel` parameter tree (leaves numpy or
    array-likes) onto HF `RobertaModel` state_dict names under `prefix`, the
    names of gvl_tpu_torch.models.text_encoder.TextEncoder, which are those
    of its named_parameters(): a tree of the same structure (gradients, Adam
    moments) maps onto them alike. The pooler, which the encoder never runs,
    is mapped too. Raises if a flax parameter is left unmapped."""
    if "params" in params_np and isinstance(params_np["params"], Mapping):
        params_np = params_np["params"]
    src = _flatten(params_np)
    sd: Dict[str, np.ndarray] = {}
    for key, v in src.items():
        *path, leaf = key.split("/")
        if leaf == "embedding":
            sd[".".join(path) + ".weight"] = v
        elif leaf == "kernel":
            sd[".".join(path) + ".weight"] = v.T
        elif leaf == "scale":
            sd[".".join(path) + ".weight"] = v
        elif leaf == "bias":
            sd[".".join(path) + ".bias"] = v
        else:
            raise KeyError(f"flax RoBERTa parameter {key} has no place in the "
                           "port")
        if path[0] not in ("embeddings", "encoder", "pooler"):
            raise KeyError(f"flax RoBERTa parameter {key} has no place in the "
                           "port")
    return {prefix + k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


def jax_grads_to_named(grads_np: Mapping, arch: GVLArch
                       ) -> Dict[str, torch.Tensor]:
    """Map a gradient tree of the flax parameters onto the names of
    GVLModel(arch).named_parameters(), by the mapping of the parameters
    themselves. A shared caption head, class, count or bbox head, or
    contrastive projection is one module in both packages, so its gradient appears once, under index 0,
    as named_parameters() lists it."""
    named = jax_params_to_state_dict(grads_np, arch)
    shared = []
    if arch.share_caption_head:
        shared.append("caption_head.")
    if not arch.with_box_refine:
        shared += ["class_head.", "count_head.", "bbox_head."]
    if arch.enable_contrastive and not arch.disable_cl_proj_layer_share_weight:
        shared += ["contrastive_projection_event.",
                   "contrastive_projection_text."]
    return {k: v for k, v in named.items()
            if not any(k.startswith(p) and not k.startswith(p + "0.")
                       for p in shared)}


def jax_tsp_to_state_dict(variables_np: Mapping, backbone: str,
                          num_classes_list=(200,), use_gvf: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """A JAX TSPModel's variables ({'params': ..., 'batch_stats': ...},
    numpy) -> the state_dict of gvl_tpu_torch.backbone.r2plus1d.TSPModel
    with the same heads (the inverse of gvl_tpu/backbone/import_torch.py):
    conv kernels (kT, kH, kW, I, O) -> (O, I, kT, kH, kW), Dense kernels
    transposed, BatchNorm scale / bias / mean / var -> weight / bias /
    running_mean / running_var; num_batches_tracked 0. Raises if a variable
    is left unmapped."""
    from gvl_tpu_torch.backbone.import_torch import flax_path
    from gvl_tpu_torch.backbone.r2plus1d import TSPModel
    with torch.device("meta"):
        model = TSPModel(num_classes_list, backbone, use_gvf, device="meta")
    src = {}
    for coll in ("params", "batch_stats"):
        src.update({(coll,) + tuple(k.split("/")): v for k, v in
                    _flatten(variables_np.get(coll, {})).items()})
    heads = {h: f"fc_{i}" for i, h in enumerate(model.heads)}
    sd, read = {}, set()
    for name, t in model.state_dict().items():
        head, rest = name.split(".", 1)
        key = f"{heads[head]}.{rest}" if head in heads else rest
        mapped = flax_path(key, backbone)
        if mapped is None:
            sd[name] = torch.zeros((), dtype=t.dtype)
            continue
        coll, path, kind = mapped
        full = (coll,) + path
        if full not in src:
            raise KeyError(f"flax variable {'/'.join(full)} missing")
        read.add(full)
        arr = np.asarray(src[full], np.float32)
        if kind == "conv":
            arr = np.transpose(arr, (4, 3, 0, 1, 2))
        elif kind == "dense":
            arr = arr.T
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    unmapped = sorted("/".join(k) for k in set(src) - read)
    if unmapped:
        raise KeyError(f"flax variables with no place in the port: "
                       f"{unmapped}")
    return sd
