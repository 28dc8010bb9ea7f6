"""The GVL model in query mode: PDVC-style deformable-transformer event
detector with iterative box refinement and the LSTM-DSA caption head.

Port of gvl_tpu/models/gvl.py for the dense-captioning eval path, the
train step (trunk in train mode, teacher-forced captions) and the
contrastive text head (event projections in the trunk, `encode_text`). Not
ported yet, and refused by `build_model`: caption heads other than
'standard', MLP class heads, heads shared across decoder layers (no box
refinement), and beam search. Two-stage / proposal queries are refused by
the EvalRunner. Parameter names follow the reference pdvc/pdvc.py
state_dict. The text encoder itself lives beside the model
(gvl_tpu_torch/models/text_encoder.py), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.base_encoder import BasePyramidEncoder
from gvl_tpu_torch.models.captioner import LSTMDSACaptioner
from gvl_tpu_torch.models.layers import MLP, init_params
from gvl_tpu_torch.models.text import (SentenceContextBlock, bert_head_count,
                                       pool_words)
from gvl_tpu_torch.models.transformer import (DeformableTransformer,
                                              expand_reference_for_levels,
                                              flatten_levels)
from gvl_tpu_torch.utils.boxes import inverse_sigmoid


@dataclasses.dataclass(frozen=True)
class GVLArch:
    """Frozen architecture spec; a copy of gvl_tpu.models.gvl.GVLArch
    (gvl.py:45-176) whose from_config reads any attribute-bearing config."""
    hidden_dim: int = 512
    nheads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    ff_dim: int = 512
    num_feature_levels: int = 4
    enc_n_points: int = 4
    dec_n_points: int = 4
    num_queries: int = 100
    num_classes: int = 1
    max_eseq_length: int = 10
    with_box_refine: bool = True
    support_mlp_class_head: bool = False
    box_head_init_bias: float = -2.0
    share_caption_head: bool = True
    caption_decoder_type: str = "standard"
    vocab_size: int = 5747
    input_encoding_size: int = 512
    rnn_size: int = 512
    att_hid_size: int = 512
    max_caption_len: int = 30
    cap_nheads: int = 1
    cap_dec_n_points: int = 4
    cap_num_feature_levels: int = 4
    enable_pos_emb_for_captioner: bool = False
    enable_contrastive: bool = True
    contrastive_hidden_size: int = 128
    enable_multilayer_projection: bool = False
    disable_cl_proj_layer_share_weight: bool = False
    enable_e2t_cl: bool = False
    text_hidden_dim: int = 768
    enable_word_context_modeling: bool = True
    word_context_modeling_type: str = "attention_pool"
    enable_sentence_context_modeling: bool = False
    enable_sentence_pos_embedding: bool = False
    sentence_pos_embedding_type: str = "cosine"
    max_pos_num: int = 500
    sentence_modeling_layer_num: int = 1
    enable_cross_model_fusion: bool = False
    enable_layer_diff_text_feature: bool = False
    feature_dim: int = 500
    msda_impl: str = "pallas"     # 'ref': the dense kernel at every S
    msda_band_margin: int = 32
    dropout: float = 0.1          # transformer_dropout_prob
    drop_prob: float = 0.5        # caption head, on the cell output

    @classmethod
    def from_config(cls, cfg: Any, text_hidden_dim: int = 768) -> "GVLArch":
        def get(name, default):
            return getattr(cfg, name, default)

        return cls(
            hidden_dim=cfg.hidden_dim, nheads=cfg.nheads,
            enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
            ff_dim=cfg.transformer_ff_dim,
            num_feature_levels=cfg.num_feature_levels,
            enc_n_points=get("enc_n_points", 4),
            dec_n_points=get("dec_n_points", 4),
            num_queries=cfg.num_queries, num_classes=get("num_classes", 1),
            max_eseq_length=cfg.max_eseq_length,
            with_box_refine=bool(get("with_box_refine", True)),
            support_mlp_class_head=bool(get("support_mlp_class_head", False)),
            box_head_init_bias=get("box_head_init_bias", -2.0),
            share_caption_head=bool(get("share_caption_head", True)),
            caption_decoder_type=get("caption_decoder_type", "standard"),
            vocab_size=cfg.vocab_size,
            input_encoding_size=cfg.input_encoding_size,
            rnn_size=cfg.rnn_size, att_hid_size=cfg.att_hid_size,
            max_caption_len=cfg.max_caption_len,
            cap_nheads=cfg.cap_nheads,
            cap_dec_n_points=get("cap_dec_n_points", 4),
            cap_num_feature_levels=cfg.cap_num_feature_levels,
            enable_pos_emb_for_captioner=bool(
                get("enable_pos_emb_for_captioner", False)),
            enable_contrastive=bool(get("enable_contrastive", False)),
            contrastive_hidden_size=int(get("contrastive_hidden_size", 128)),
            enable_multilayer_projection=bool(
                get("enable_multilayer_projection", False)),
            disable_cl_proj_layer_share_weight=bool(
                get("disable_cl_proj_layer_share_weight", False)),
            enable_e2t_cl=bool(get("enable_e2t_cl", False)),
            text_hidden_dim=int(text_hidden_dim),
            enable_word_context_modeling=bool(
                get("enable_word_context_modeling", False)),
            word_context_modeling_type=get("word_context_modeling_type",
                                           "attention_pool"),
            enable_sentence_context_modeling=bool(
                get("enable_sentence_context_modeling", False)),
            enable_sentence_pos_embedding=bool(
                get("enable_sentence_pos_embedding", False)),
            sentence_pos_embedding_type=get("sentence_pos_embedding_type",
                                            "cosine"),
            max_pos_num=int(get("max_pos_num", 500)),
            sentence_modeling_layer_num=int(
                get("sentence_modeling_layer_num", 1)),
            enable_cross_model_fusion=bool(
                get("enable_cross_model_fusion", False)),
            enable_layer_diff_text_feature=bool(
                get("enable_layer_diff_text_feature", False)),
            feature_dim=cfg.feature_dim,
            msda_impl=get("msda_impl", "pallas"),
            msda_band_margin=int(get("msda_band_margin", 32)),
            dropout=float(get("transformer_dropout_prob", 0.1)),
            drop_prob=float(get("drop_prob", 0.5)),
        )


def _check_ported(a: GVLArch) -> None:
    if a.msda_impl not in ("pallas", "ref"):
        raise ValueError(f"unknown msda_impl: {a.msda_impl}")
    if a.caption_decoder_type != "standard":
        raise NotImplementedError(
            f"caption head '{a.caption_decoder_type}' is not ported yet; "
            "only 'standard' (LSTM-DSA) is")
    if a.support_mlp_class_head:
        raise NotImplementedError("MLP class heads are not ported yet")
    if not a.with_box_refine:
        raise NotImplementedError("heads shared across decoder layers "
                                  "(with_box_refine=0) are not ported yet")


class GVLModel(nn.Module):
    """Trunk (`forward`), text head (`encode_text`), greedy or sampled
    caption decode (`caption_sample`) and teacher forcing (`caption_train`,
    `caption_train_nll`). Dropout is live
    under `.train()` only; its draws come from the device's default
    generator, which the caller seeds (`torch.manual_seed`).

    Built on `device`; parameters are drawn by `init_params` with the JAX
    package's initializers from `generator`, or loaded with
    `load_state_dict` (see gvl_tpu_torch.convert)."""

    def __init__(self, arch: GVLArch, device=None):
        super().__init__()
        _check_ported(arch)
        a = self.arch = arch
        num_pred = a.dec_layers
        self.base_encoder = BasePyramidEncoder(
            a.num_feature_levels, a.hidden_dim, a.feature_dim, device=device)
        # the banded encoder route is the 'pallas' one (layers.py:149-151);
        # 'ref' runs the exact dense op at every S, as a margin of 0 does
        band_margin = a.msda_band_margin if a.msda_impl == "pallas" else 0
        self.transformer = DeformableTransformer(
            a.hidden_dim, a.ff_dim, a.enc_layers, a.dec_layers,
            a.num_feature_levels, a.nheads, a.enc_n_points, a.dec_n_points,
            band_margin, a.dropout, device=device)
        self.query_embed = nn.Embedding(a.num_queries, a.hidden_dim * 2,
                                        device=device)

        # one head per decoder layer (box refinement clones them)
        self.class_head = nn.ModuleList(
            nn.Linear(a.hidden_dim, a.num_classes, device=device)
            for _ in range(num_pred))
        self.count_head = nn.ModuleList(
            nn.Linear(a.hidden_dim, a.max_eseq_length + 1, device=device)
            for _ in range(num_pred))
        self.bbox_head = nn.ModuleList(
            MLP(a.hidden_dim, a.hidden_dim, 2, 3, device=device)
            for _ in range(num_pred))

        def captioner(i):
            return LSTMDSACaptioner(
                a.vocab_size, a.input_encoding_size, a.rnn_size, a.hidden_dim,
                a.cap_num_feature_levels, a.cap_nheads, a.cap_dec_n_points,
                a.att_hid_size, a.max_caption_len,
                a.enable_pos_emb_for_captioner, a.drop_prob, device=device)

        if a.share_caption_head:
            self.caption_head = nn.ModuleList([captioner(0)] * num_pred)
        else:
            self.caption_head = nn.ModuleList(captioner(i)
                                              for i in range(num_pred))
        if a.enable_contrastive:
            self._init_text_side(device)

    def _init_text_side(self, device) -> None:
        """Contrastive projections (shared across layers unless
        disable_cl_proj_layer_share_weight), word and sentence context and
        the background embedding (gvl.py:272-313)."""
        a = self.arch
        Dt, Dcl = a.text_hidden_dim, a.contrastive_hidden_size

        def proj(d_in):
            if a.enable_multilayer_projection:
                return MLP(d_in, d_in, Dcl, 2, device=device)
            return nn.Linear(d_in, Dcl, device=device)

        n_event = a.dec_layers
        n_text = 1 + int(a.enable_sentence_context_modeling)
        if a.disable_cl_proj_layer_share_weight:
            self.contrastive_projection_event = nn.ModuleList(
                proj(a.hidden_dim) for _ in range(n_event))
            self.contrastive_projection_text = nn.ModuleList(
                proj(Dt) for _ in range(n_text))
        else:
            self.contrastive_projection_event = nn.ModuleList(
                [proj(a.hidden_dim)] * n_event)
            self.contrastive_projection_text = nn.ModuleList(
                [proj(Dt)] * n_text)
        self._pool_fn = None          # max / mean pooling have no parameters
        if a.enable_word_context_modeling:
            pool = pool_words(a.word_context_modeling_type, Dt, device=device)
            if isinstance(pool, nn.Module):
                self.word_context_model = pool
            else:
                self._pool_fn = pool
        if a.enable_sentence_context_modeling:
            self.sentence_context_model = SentenceContextBlock(
                Dt, a.sentence_modeling_layer_num,
                a.enable_sentence_pos_embedding,
                a.sentence_pos_embedding_type, a.max_pos_num,
                a.enable_cross_model_fusion, a.hidden_dim,
                n_heads=bert_head_count(Dt), device=device)
        if a.enable_e2t_cl:
            self.background_embed = nn.Parameter(
                torch.empty(1, Dcl, device=device))

    def flax_init_(self, generator: torch.Generator) -> None:
        if self.arch.enable_contrastive and self.arch.enable_e2t_cl:
            nn.init.normal_(self.background_embed, 0.0, 1.0,
                            generator=generator)
        nn.init.normal_(self.query_embed.weight, 0.0, 1.0, generator=generator)
        focal = -math.log((1 - 0.01) / 0.01)
        for i, (ch, bh) in enumerate(zip(self.class_head, self.bbox_head)):
            ch.bias.fill_(focal)
            last = bh.layers[-1]
            last.weight.zero_()
            last.bias.zero_()
            if i == 0:
                last.bias[1] = self.arch.box_head_init_bias

    # ------------------------------------------------------------------ trunk
    def forward(self, feats, feat_mask, duration) -> Dict[str, Any]:
        """Query-mode trunk. Port of GVLModel.__call__ (gvl.py:347-427)."""
        a = self.arch
        B = feats.shape[0]
        tr = self.transformer
        srcs, masks, poses = self.base_encoder(feats, feat_mask, duration)
        src_flat, mask_flat, pos_flat, shapes, valid_ratios = flatten_levels(
            srcs, masks, poses, tr.level_embed)
        memory = tr.encoder(src_flat, pos_flat, mask_flat, shapes, valid_ratios)

        q = self.query_embed.weight
        query_pos = q[None, :, :a.hidden_dim].expand(B, -1, -1)
        tgt = q[None, :, a.hidden_dim:].expand(B, -1, -1)
        ref = torch.sigmoid(tr.reference_points(query_pos))          # (B,Nq,1)
        qmask = torch.ones((B, a.num_queries), dtype=torch.bool,
                           device=feats.device)

        hs_list, ref_before_list = [], []
        out = tgt
        for lid, layer in enumerate(tr.decoder.layers):
            ref_input = expand_reference_for_levels(ref, valid_ratios)
            out = layer(out, query_pos, ref_input, memory, mask_flat, shapes,
                        qmask)
            hs_list.append(out)
            ref_before_list.append(ref)
            ref = self._refine(self.bbox_head[lid](out), ref).detach()

        logits, counts, coords, event_embeds = [], [], [], []
        for lid, h in enumerate(hs_list):
            logits.append(self.class_head[lid](h))
            counts.append(self.count_head[lid](h.amax(dim=1)))
            coords.append(self._refine(self.bbox_head[lid](h),
                                       ref_before_list[lid]))
            if a.enable_contrastive:
                event_embeds.append(self.contrastive_projection_event[lid](h))
        out = {
            "hs": torch.stack(hs_list),                     # (Ld,B,Nq,C)
            "pred_logits": torch.stack(logits),             # (Ld,B,Nq,K)
            "pred_count": torch.stack(counts),              # (Ld,B,E+1)
            "pred_boxes": torch.stack(coords),              # (Ld,B,Nq,2)
            "layer_refs": tuple(ref_before_list),
            "memory": memory,
            "mask_flat": mask_flat,
            "valid_ratios": valid_ratios,
            "query_mask": qmask,
            "query_pos": query_pos,
        }
        if a.enable_contrastive:
            out["event_embed"] = torch.stack(event_embeds)  # (Ld,B,Nq,Dcl)
            if a.enable_e2t_cl:
                out["background_embed"] = self.background_embed
        return out

    @staticmethod
    def _refine(tmp, ref):
        """Box delta against the (pre-sigmoid) reference (gvl.py:429-435)."""
        if ref.shape[-1] == 2:
            return torch.sigmoid(tmp + inverse_sigmoid(ref))
        center = tmp[..., :1] + inverse_sigmoid(ref)
        return torch.sigmoid(torch.cat([center, tmp[..., 1:]], dim=-1))

    # ------------------------------------------------------------- text side
    def encode_text(self, word_embed, token_mask, sent_mask, memory=None,
                    memory_mask=None) -> Dict[str, torch.Tensor]:
        """Pool word features into sentence features and project them into
        the contrastive space (gvl.py:438-471).

        word_embed (B, G, Ltok, Dt), the text encoder's last hidden state;
        token_mask (B, G, Ltok) bool; sent_mask (B, G) bool. Returns 'aux'
        and 'final' (B, G, Dcl) with their unprojected 'aux_pre' and
        'final_pre': decoder layers 0..Ld-2 match 'aux', the last 'final'.
        Without enable_layer_diff_text_feature 'aux' is 'final'."""
        a = self.arch
        if a.enable_word_context_modeling:
            pool = self._pool_fn or self.word_context_model
            sent = pool(word_embed, token_mask)
        else:
            sent = word_embed[..., 0, :]            # the first (bos) token
        aux_pre = aux = None
        if a.enable_layer_diff_text_feature:
            pooled = a.word_context_modeling_type == "attention_pool"
            aux_pre = sent if pooled else F.gelu(sent)
            aux = self.contrastive_projection_text[0](aux_pre)
        final_pre = sent
        if a.enable_sentence_context_modeling:
            final_pre = self.sentence_context_model(sent, sent_mask, memory,
                                                    memory_mask)
        final = self.contrastive_projection_text[-1](final_pre)
        if aux is None:
            aux, aux_pre = final, final_pre
        return {"aux": aux, "final": final, "aux_pre": aux_pre,
                "final_pre": final_pre}

    # ------------------------------------------------------------ captioning
    def caption_train(self, layer_id: int, query, reference, memory,
                      memory_mask, temporal_shapes, valid_ratios, seq,
                      ss_prob: float = 0.0, ref_prepared: bool = False):
        """Teacher-forced logprobs (B, Ne, Lc-1, V+1) of the layer's caption
        head (gvl.py:474-489)."""
        return self.caption_head[layer_id](
            query, reference, memory, memory_mask, temporal_shapes,
            valid_ratios, seq, ss_prob=ss_prob, ref_prepared=ref_prepared)

    def caption_train_nll(self, layer_id: int, query, reference, memory,
                          memory_mask, temporal_shapes, valid_ratios, seq,
                          seq_mask, ref_prepared: bool = False):
        """Fused teacher-forcing NLL (B, Ne): caption_train + caption_nll
        without the normalised logprob tensor (gvl.py:491-519)."""
        return self.caption_head[layer_id].teacher_forced_nll(
            query, reference, memory, memory_mask, temporal_shapes,
            valid_ratios, seq, seq_mask, ref_prepared=ref_prepared)

    def caption_sample(self, layer_id: int, query, reference, memory,
                       memory_mask, temporal_shapes, valid_ratios,
                       beam_size: int = 1, greedy: bool = True,
                       temperature: float = 1.0,
                       generator: torch.Generator = None,
                       ref_prepared: bool = False):
        """Greedy or sampled decode with the layer's caption head
        (gvl.py:521-550); with ref_prepared, `reference` is already
        prepare_dsa_reference's (B, Ne, L, 2), which the fused SCST path
        concatenates across layers. The head's dropout follows its mode."""
        if beam_size > 1:
            raise NotImplementedError("beam search is not ported yet")
        return self.caption_head[layer_id].sample(
            query, reference, memory, memory_mask, temporal_shapes,
            valid_ratios, greedy=greedy, temperature=temperature,
            generator=generator, ref_prepared=ref_prepared)


def build_model(cfg: Any, text_hidden_dim: int = 768, device=None,
                generator: torch.Generator = None) -> GVLModel:
    """GVLModel for `cfg`, in eval mode, on `device`: the current CUDA device
    when none is given (raising where there is none), so a CPU caller asks
    for "cpu". text_hidden_dim is the text encoder's width (its
    `hidden_size`), read only with enable_contrastive. With a generator,
    its parameters are drawn with the JAX package's initializers; without
    one they are left uninitialised for `load_state_dict`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device is available; pass "
                "device='cpu' to build the model on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.device("meta"):
        model = GVLModel(GVLArch.from_config(cfg, text_hidden_dim),
                         device="meta")
    model = model.to_empty(device=device)
    if generator is not None:
        init_params(model, generator)
    return model.eval()
