"""Configuration system.

Mirrors the reference CLI surface (reference: opts.py:7-290) — every argparse
flag becomes a `Config` field with the same name and default, and YAML configs
overlay on top with recursive single-parent inheritance via `base_cfg_path`
(reference: opts.py:321-328).  The reference applies YAML *after* CLI parsing,
so YAML overrides CLI (opts.py:293-294); `load_config` reproduces that order.

Unknown YAML keys are stored as attributes rather than rejected so that the
reference's shipped cfgs/*.yml files parse unchanged.

The port's copy of gvl_tpu/config.py: every field, name and default is the
JAX package's but one, `device`, which defaults to "cuda" (the JAX package's
"tpu"). Fields that select JAX-only paths (msda_impl 'pallas', matcher_impl,
mesh_shape, ...) are kept so that a run directory's opts.json reads the same
in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, List, Optional

import yaml


@dataclasses.dataclass
class Config:
    # ---- run bookkeeping (opts.py:11-21) ----
    cfg_path: str = ""
    id: str = ""
    fixid: str = ""
    gpu_id: List[str] = dataclasses.field(default_factory=list)
    disable_tqdm: bool = False
    seed: int = 777
    random_seed: bool = False
    disable_cudnn: int = 0
    debug: bool = False
    device: str = "cuda"
    train_use_amp: bool = False

    # ---- input data paths (opts.py:24-42) ----
    train_caption_file: str = "data/anet/captiondata/train_modified.json"
    invalid_video_json: List[str] = dataclasses.field(default_factory=list)
    val_caption_file: str = "data/anet/captiondata/val_1.json"
    visual_feature_folder: Any = "data/anet/resnet_bn"
    gt_file_for_auc: Any = "data/anet/captiondata/val_all.json"
    gt_file_for_eval: List[str] = dataclasses.field(
        default_factory=lambda: ["data/anet/captiondata/val_1.json",
                                 "data/anet/captiondata/val_2.json"])
    gt_file_for_para_eval: List[str] = dataclasses.field(
        default_factory=lambda: [
            "data/anet/captiondata/para/anet_entities_val_1_para.json",
            "data/anet/captiondata/para/anet_entities_val_2_para.json"])
    dict_file: str = "data/anet/vocabulary_activitynet.json"
    criteria_for_best_ckpt: str = "dvc"  # dvc | pc | grounding
    visual_feature_type: Any = "c3d"
    feature_dim: int = 500
    start_from: str = ""
    start_from_mode: str = "last"
    pretrain: Optional[str] = None  # full | encoder | decoder
    pretrain_path: str = ""

    # ---- dataloader (opts.py:45-53) ----
    nthreads: int = 4
    data_norm: int = 0
    data_rescale: int = 1
    feature_sample_rate: int = 1
    train_proposal_sample_num: int = 24
    gt_proposal_sample_num: int = 10

    # ---- caption decoder (opts.py:57-70) ----
    vocab_size: int = 5747
    wordRNN_input_feats_type: str = "C"
    caption_decoder_type: str = "light"  # none|light|standard|transformer|gpt2
    enable_pos_emb_for_captioner: bool = False
    rnn_size: int = 512
    num_layers: int = 1
    input_encoding_size: int = 512
    att_hid_size: int = 512
    drop_prob: float = 0.5
    max_caption_len: int = 30

    # ---- transformer (opts.py:73-100) ----
    hidden_dim: int = 512
    num_queries: int = 100
    hidden_dropout_prob: float = 0.5
    layer_norm_eps: float = 1e-12
    caption_cost_type: str = "loss"
    caption_loss_type: str = "ce"
    set_cost_caption: float = 0.0
    set_cost_class: float = 1.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    cost_alpha: float = 0.25
    cost_gamma: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    count_loss_coef: float = 0.0
    caption_loss_coef: float = 0.0
    eos_coef: float = 0.1
    num_classes: int = 1
    dec_layers: int = 6
    enc_layers: int = 6
    transformer_ff_dim: int = 2048
    transformer_dropout_prob: float = 0.1
    frame_embedding_num: int = 100
    sample_method: str = "nearest"
    fix_xcw: int = 0
    box_head_init_bias: float = -2.0

    # ---- optimizer (opts.py:104-117) ----
    training_scheme: str = "all"
    epoch: int = 30
    batch_size: int = 1
    eval_batch_size: int = 1
    grad_clip: float = 100.0
    optimizer_type: str = "adam"
    weight_decay: float = 0.0
    lr: float = 1e-4
    task_heads_lr: float = 5e-5
    task_heads_different_lr: bool = False
    learning_rate_decay_start: float = 8
    learning_rate_decay_every: float = 3
    learning_rate_decay_rate: float = 0.5

    # ---- saving/logging (opts.py:120-123) ----
    min_epoch_when_save: int = -1
    save_checkpoint_every: int = 1
    save_all_checkpoint: bool = False
    save_dir: str = "save"

    # ---- deformable detr (opts.py:126-163) ----
    lr_backbone_names: List[str] = dataclasses.field(default_factory=lambda: ["None"])
    lr_backbone: float = 2e-5
    lr_proj: int = 0
    learning_strategy: str = "multi_step"
    warm_up_ratio: float = 0.1
    lr_linear_proj_names: List[str] = dataclasses.field(
        default_factory=lambda: ["reference_points", "sampling_offsets"])
    lr_linear_proj_mult: float = 0.1
    with_box_refine: bool = False
    transformer_input_type: str = "queries"  # gt_proposals | queries
    backbone: Optional[str] = None
    dilation: bool = False
    position_embedding: str = "sine"
    position_embedding_scale: float = 2 * math.pi
    num_feature_levels: int = 4
    nheads: int = 8
    dec_n_points: int = 4
    enc_n_points: int = 4
    share_caption_head: int = 1
    cap_nheads: int = 8
    cap_dec_n_points: int = 4
    cap_num_feature_levels: int = 4
    disable_mid_caption_heads: bool = False
    aux_loss: bool = True

    # ---- loss coefficients (opts.py:171-173) ----
    cls_loss_coef: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0

    # ---- pretrain-weight filters (opts.py:176-179) ----
    remove_class_head_weight: bool = False
    remove_bbox_head_weight: bool = False
    remove_caption_head_weight: bool = False
    remove_contrastive_projection_weight: bool = False

    # ---- event counter (opts.py:183-185) ----
    max_eseq_length: int = 10
    lloss_gau_mask: int = 1
    lloss_beta: float = 1.0

    # ---- scheduled sampling (opts.py:188-196) ----
    scheduled_sampling_start: int = -1
    basic_ss_prob: float = 0.0
    scheduled_sampling_increase_every: int = 2
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25

    dataset: str = "anet"

    # ---- text encoder (opts.py:202-224) ----
    pretrained_language_model: str = "roberta-base"
    load_pretrained_language_model_from_config: Optional[str] = None
    gpt_model: str = "gpt2"
    text_encoder_lr: float = 1e-5
    text_encoder_learning_strategy: str = "warmup_linear"
    text_encoder_warm_up_ratio: float = 0.01
    text_encoder_lr_decay_start: float = 8
    text_encoder_lr_decay_every: float = 3
    text_encoder_lr_decay_rate: float = 0.5
    max_text_input_len: int = 32
    enable_layer_diff_text_feature: bool = False
    enable_word_context_modeling: bool = False
    word_context_modeling_type: str = "attention_pool"
    enable_sentence_context_modeling: bool = False
    enable_sentence_pos_embedding: bool = False
    sentence_pos_embedding_type: str = "cosine"
    enable_multilayer_projection: bool = False
    max_pos_num: int = 500
    sentence_modeling_layer_num: int = 1
    enable_cross_model_fusion: bool = False
    huggingface_cache_dir: str = ".cache"

    # ---- contrastive loss (opts.py:227-237) ----
    enable_contrastive: bool = False
    contrastive_hidden_size: int = 128
    contrastive_loss_start_coef: float = 0.0
    contrastive_loss_temperature: float = 0.1
    enable_cross_video_cl: bool = True
    set_cost_cl: float = 0.0
    cl_schedule_val: List[float] = dataclasses.field(default_factory=lambda: [0, 0.1])
    cl_schedule_time: List[int] = dataclasses.field(default_factory=lambda: [0, 2])
    disable_cl_proj_layer_share_weight: bool = False
    enable_e2t_cl: bool = False
    enable_bg_for_cl: bool = False

    # ---- finetuning switches (opts.py:240-247) ----
    only_ft_captioner: bool = False
    ft_captioner_from_scratch: bool = False
    only_ft_class_head: bool = False
    action_classes_path: str = "data/anet/anet1.3/action_name.txt"
    tal_gt_file: str = "data/anet/anet1.3/activity_net.v1-3.min.json"
    support_mlp_class_head: bool = False

    # ---- grounding eval (opts.py:250-260) ----
    eval_enable_grounding: bool = True
    eval_enable_maximum_matching_for_grounding: bool = False
    eval_set_cost_class: float = 0.0
    eval_grounding_cost_alpha: float = 0.25
    eval_grounding_cost_gamma: float = 2.0
    eval_set_cost_cl: float = 1.0
    eval_disable_captioning: bool = False
    eval_disable_contrastive: bool = False
    eval_enable_matching_score: bool = False
    eval_matching_score_weight: float = 0.0
    # qualitative plot suite (reference misc/plot/*): duration-bucketed
    # result splits + per-video timeline renders, written next to the
    # result JSON when enabled
    eval_save_qualitative_plots: bool = False
    eval_gt_file_for_grounding: str = \
        "data/anet/captiondata/grounding/val1_for_grounding.json"

    # ---- msvg / eval tool / cropping / rerank (opts.py:263-274) ----
    train_with_split_anno: bool = False
    eval_tool_version: str = "2018"
    enable_video_cropping: bool = False
    min_crop_ratio: float = 0.5
    crop_num: int = 2
    ec_alpha: float = 0.3

    # ---- gpt2 (opts.py:277-280) ----
    prefix_num_mapping_layer: int = 8
    prefix_size: int = 512
    prefix_length: int = 10
    eval_use_amp: bool = False

    # ---- RL / SCST (opts.py:283-287) ----
    rl_scorer_types: List[str] = dataclasses.field(default_factory=lambda: ["Meteor"])
    rl_scorer_weights: List[float] = dataclasses.field(default_factory=lambda: [1.0])
    cached_tokens: str = "anet/activitynet_train_ngrams_for_cider-idxs"
    cl_para_ratio: float = 0.0
    cl_sent_ratio: float = 1.0

    # ================= TPU-native additions (no reference equivalent) ======
    # Static-shape controls: the reference masked-selects into ragged tensors;
    # we pad to fixed sizes so everything jits once.
    max_gt_events: int = 0          # 0 -> derived from gt_proposal_sample_num
    msda_impl: str = "pallas"       # 'pallas' | 'ref' (pure jnp gather oracle)
    matcher_impl: str = "jax"       # 'jax' (on-device LAP) | 'scipy' (callback)
    dsa_sample_impl: str = "auto"   # captioner DSA sampling: 'twohot' (MXU
                                    # matmul — measured fastest at every S
                                    # incl. YouMakeup 1500; 'auto' resolves
                                    # to it) | 'gather' (O(R) fallback)
    msda_band_margin: int = 32      # banded encoder-MSDA halo in positions
                                    # (long sequences, S>=512): taps beyond
                                    # it clamp to the band edge; 0 forces
                                    # the exact dense kernel
    remat_trunk: bool = False       # checkpoint the enc/dec layers
                                    # (torch.utils.checkpoint): recompute
                                    # activations in the backward instead
                                    # of storing (B,S,C) per layer — exact,
                                    # trades ~1 extra fwd of FLOPs for
                                    # activation memory; for long-video
                                    # training at large T
    compute_dtype: str = "float32"  # note: XLA on TPU already feeds f32
                                    # matmuls through the bf16 MXU (the
                                    # effective equivalent of the reference's
                                    # AMP flags); this knob is reserved for a
                                    # full bf16 activation path
    mesh_shape: str = "dp"          # mesh axes spec of the JAX package's parallel module
    sp_msda: bool = True            # on an 'sp' mesh: route deformable
                                    # attention through the shard_map'd
                                    # halo-exchange/psum op (keeps the memory
                                    # axis sharded; ops/ms_deform_attn_sp.py)
    sp_halo_frac: float = 0.125     # halo width as a fraction of each
                                    # level's length; taps beyond it clamp
    log_every: int = 50
    num_workers: int = 4            # host data pipeline workers
    profile_steps: int = 0          # >0: capture a jax.profiler trace of the
                                    # first N steps into <run_dir>/trace
    eval_beam_size: int = 1         # >1: beam search in caption decoding
    eval_decode_early_exit: bool = False  # greedy eval decode stops when
                                    # every caption has emitted EOS (the
                                    # reference's loop break) — serving time
                                    # tracks actual caption length instead
                                    # of max_caption_len; token output
                                    # identical. All autoregressive heads
                                    # (standard/light/transformer/gpt2);
                                    # beam > 1 rejects the knob
    eval_disable_plot_hook: bool = False  # skip the per-eval proposal-
                                    # distribution matplotlib figure the
                                    # reference renders after every eval
                                    # (eval_utils.py:259). Measured 8.7 s
                                    # of host time per eval epoch on a
                                    # 1-core host — pure waste in serving
                                    # or frequent-eval training loops.
    eval_decode_bf16: bool = False  # cast the caption decode to bfloat16
    eval_full_bf16: bool = False    # run the WHOLE eval forward (trunk +
                                    # decode) in bfloat16: params + video
                                    # feats cast to bf16, trunk outputs cast
                                    # back to f32 before the criterion /
                                    # postprocess (flax norms still compute
                                    # stats in f32; the Pallas MSDA kernels
                                    # accumulate in f32). Implies
                                    # eval_decode_bf16.
    train_caption_bf16: bool = False  # run the caption teacher-forcing pass
                                    # (the FLOP-heavy ~half of the train
                                    # step) in bfloat16: caption-head params
                                    # + query/memory inputs cast to bf16,
                                    # log_softmax and the NLL reduction stay
                                    # f32 (master weights/optimizer f32).
                                    # standard/light/transformer heads; the
                                    # gpt2 head keeps f32
    eval_data_parallel: bool = False  # shard eval batches over all local
                                      # devices ('dp' mesh); params replicate
    eval_decode_chunk: int = 16     # decode at most this many videos per
                                    # lax.map chunk: keeps clips/s flat in
                                    # batch size (unchunked B=64 loses ~40%
                                    # to XLA scheduling pressure; DESIGN.md)
                                    # (~2x step FLOPs reduction; may flip
                                    # borderline greedy choices — validate on
                                    # metrics before shipping)
    caption_scan_loops: bool = False  # lax.scan caption token loops (lower
                                    # compile time/memory) vs unrolled (fast)
    fuse_caption_layers: bool = True  # shared caption head: teacher-force
                                    # every decoder layer's matched events in
                                    # ONE head call (layers folded into the
                                    # event axis) — one serial token chain
                                    # instead of dec_layers, with wider
                                    # per-step matmuls; exact (events are
                                    # independent) up to dropout draws
    length_bucket: int = 64         # data_rescale=0: pad variable-length
                                    # batches up to multiples of this, so the
                                    # step re-jits once per bucket, not per
                                    # batch

    def __post_init__(self):
        self._extra = {}

    # -- dict-style access so code written against argparse Namespaces works --
    def get(self, key: str, default: Any = None) -> Any:
        if hasattr(self, key):
            return getattr(self, key)
        return self._extra.get(key, default)

    def set(self, key: str, value: Any) -> None:
        if dataclasses.fields(self) and key in {f.name for f in dataclasses.fields(self)}:
            setattr(self, key, value)
        else:
            self._extra[key] = value
            setattr(self, key, value)

    def update(self, d: dict) -> "Config":
        for k, v in d.items():
            self.set(k, v)
        return self

    def to_dict(self) -> dict:
        out = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        out.update(self._extra)
        return out

    def dump_json(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=str)

    # -- derived quantities --------------------------------------------------
    @property
    def effective_max_gt_events(self) -> int:
        """Static per-video GT-event capacity used to pad caption/box tensors."""
        if self.max_gt_events > 0:
            return self.max_gt_events
        # gt_proposal_sample_num caps sampled GT events (reference:
        # video_dataset.py:270-276); TACoS uses 1000 as "no cap" — clamp to a
        # practical padded width there.
        return min(int(self.gt_proposal_sample_num), 64)

    def temporal_shapes(self, T: Optional[int] = None) -> List[int]:
        """Static per-level lengths of the stride-2 conv pyramid.

        Level 0 keeps T; levels 1..L-1 halve with ceil (Conv1d k=3 s=2 p=1;
        reference: pdvc/base_encoder.py:37-42).
        """
        t = int(T if T is not None else self.frame_embedding_num)
        shapes = [t]
        for _ in range(1, self.num_feature_levels):
            t = (t + 1) // 2
            shapes.append(t)
        return shapes


def _read_yaml_chain(cfg_path: str) -> dict:
    """Load a YAML config, recursively applying single-parent inheritance
    via `base_cfg_path` (reference: opts.py:321-328)."""
    with open(cfg_path, "r") as handle:
        yml = yaml.safe_load(handle) or {}
    merged: dict = {}
    if "base_cfg_path" in yml:
        base_path = yml["base_cfg_path"]
        if not os.path.isabs(base_path) and not os.path.exists(base_path):
            cand = os.path.join(os.path.dirname(cfg_path), os.path.basename(base_path))
            if os.path.exists(cand):
                base_path = cand
        merged.update(_read_yaml_chain(base_path))
    merged.update(yml)
    return merged


def load_config(cfg_path: Optional[str] = None, **overrides: Any) -> Config:
    """Build a Config: defaults <- CLI-style overrides <- YAML.

    YAML wins over overrides, matching the reference where import_cfg runs
    after argparse (opts.py:293-294).
    """
    cfg = Config()
    cfg.update(overrides)
    if cfg_path:
        cfg.cfg_path = cfg_path
        cfg.update(_read_yaml_chain(cfg_path))
    if cfg.caption_decoder_type == "none":
        assert cfg.caption_loss_coef == 0
        assert cfg.set_cost_caption == 0
    if int(cfg.get("eval_beam_size", 1)) > 1 and \
            cfg.caption_decoder_type != "standard":
        # beam search is implemented for the LSTM-DSA head only; fail at
        # config time instead of a bare assert deep in the eval step
        raise ValueError(
            f"eval_beam_size={cfg.eval_beam_size} requires "
            f"caption_decoder_type='standard' (LSTM-DSA); got "
            f"'{cfg.caption_decoder_type}'. Use eval_beam_size=1 for the "
            "light/transformer/gpt2/none heads.")
    if cfg.get("caption_decoder_type") == "transformer" and \
            int(cfg.get("input_encoding_size", 0)) != \
            int(cfg.get("hidden_dim", 0)):
        # the reference Transformer_DSA feeds the input_encoding_size word
        # embedding straight into d_model=hidden_dim layers
        # (Transformer_DSA.py:132-148) — it only works when the two agree;
        # fail at parse time instead of with a shape error mid-build
        raise ValueError(
            "caption_decoder_type='transformer' requires input_encoding_size"
            f" == hidden_dim (got {cfg.get('input_encoding_size')} vs "
            f"{cfg.get('hidden_dim')})")
    if bool(cfg.get("eval_decode_early_exit", False)) and \
            int(cfg.get("eval_beam_size", 1)) > 1:
        # beam decode has no early-exit path; refuse rather than silently
        # running all max_caption_len steps with the knob 'on'
        raise ValueError(
            "eval_decode_early_exit is not supported with eval_beam_size > 1"
            " (beam decode runs the fixed step count); disable one of them.")
    return cfg
