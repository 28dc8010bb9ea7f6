"""The GVL model: PDVC-style deformable-transformer event detector, its
heads and its caption head, with learnt queries or, two-stage
(transformer_input_type 'gt_proposals'), the GT segments as queries.

Port of gvl_tpu/models/gvl.py for the dense-captioning eval path, the
train step (trunk in train mode, teacher-forced captions) and the
contrastive text head (event projections in the trunk, `encode_text`).
Heads: linear or 3-layer MLP class heads (support_mlp_class_head); one
class, count and bbox head per decoder layer with box refinement, one head
shared by every layer without it (with_box_refine=0, gvl.py:249-262); the
caption heads 'standard' (LSTM-DSA), 'light', 'transformer', 'gpt2'
(ClipCap, gvl_tpu_torch/models/gpt_captioner.py; `caption_train_gpt`,
`caption_sample_gpt`) and 'none' (gvl.py:316-344), with greedy, sampled,
early-exit and (LSTM-DSA) beam decode. With remat_trunk each encoder and
decoder layer is checkpointed (models/transformer.py run_layer).
In two-stage mode the decoder's queries are the embedded GT segments and
the boxes are not refined (gvl.py:370-405). Parameter names
follow the reference pdvc/pdvc.py state_dict. The text encoder itself lives
beside the model (gvl_tpu_torch/models/text_encoder.py), as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from gvl_tpu_torch.models.base_encoder import BasePyramidEncoder
from gvl_tpu_torch.models.captioner import (LightCaptioner, LSTMDSACaptioner,
                                            PuppetCaptioner,
                                            TransformerDSACaptioner,
                                            caption_nll)
from gvl_tpu_torch.models.gpt_captioner import (GPT2Captioner, GPT2Spec,
                                                load_gpt2_spec)
from gvl_tpu_torch.models.layers import MLP, init_params
from gvl_tpu_torch.models.text import (SentenceContextBlock, bert_head_count,
                                       pool_words)
from gvl_tpu_torch.models.transformer import (DeformableTransformer,
                                              expand_reference_for_levels,
                                              flatten_levels,
                                              proposal_pos_embed, run_layer)
from gvl_tpu_torch.utils.amp import bf16_parameters
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
    cap_num_layers: int = 1
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
    remat_trunk: bool = False     # checkpoint each encoder / decoder layer
    two_stage: bool = False       # transformer_input_type == 'gt_proposals'
    dropout: float = 0.1          # transformer_dropout_prob
    drop_prob: float = 0.5        # caption head, on the cell output
    # the gpt2 caption head's spec (gvl.py:100-124), from load_gpt2_spec
    gpt_vocab_size: int = 1000
    gpt_n_embd: int = 128
    gpt_n_layer: int = 2
    gpt_n_head: int = 4
    gpt_n_positions: int = 1024
    prefix_length: int = 10
    prefix_size: int = 512
    gpt_mapping_type: str = "mlp"
    prefix_num_mapping_layer: int = 2
    gpt_stop_token_id: int = 13

    @classmethod
    def from_config(cls, cfg: Any, text_hidden_dim: int = 768,
                    gpt_spec: GPT2Spec = None) -> "GVLArch":
        """The arch of `cfg`; with the gpt2 caption head, its spec is
        `gpt_spec`, by default load_gpt2_spec(cfg)'s (gvl.py:617-621)."""
        def get(name, default):
            return getattr(cfg, name, default)

        gpt_kw = {}
        if get("caption_decoder_type", "standard") == "gpt2":
            s = gpt_spec or load_gpt2_spec(cfg)[0]
            gpt_kw = dict(
                gpt_vocab_size=s.vocab_size, gpt_n_embd=s.n_embd,
                gpt_n_layer=s.n_layer, gpt_n_head=s.n_head,
                gpt_n_positions=s.n_positions,
                prefix_length=s.prefix_length, prefix_size=s.prefix_size,
                gpt_mapping_type=s.mapping_type,
                prefix_num_mapping_layer=s.prefix_num_mapping_layer,
                gpt_stop_token_id=s.stop_token_id)
        return cls(**gpt_kw,
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
            cap_num_layers=int(get("num_layers", 1)),
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
            remat_trunk=bool(get("remat_trunk", False)),
            two_stage=get("transformer_input_type", "queries")
            == "gt_proposals",
            dropout=float(get("transformer_dropout_prob", 0.1)),
            drop_prob=float(get("drop_prob", 0.5)),
        )


def _check_ported(a: GVLArch) -> None:
    if a.msda_impl not in ("pallas", "ref"):
        raise ValueError(f"unknown msda_impl: {a.msda_impl}")



class GVLModel(nn.Module):
    """Trunk (`forward`), text head (`encode_text`), greedy, sampled,
    early-exit or beam caption decode (`caption_sample`) and teacher forcing
    (`caption_train`, `caption_train_nll`). Dropout is live
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
            band_margin, a.dropout, a.remat_trunk, a.two_stage,
            device=device)
        self.query_embed = nn.Embedding(a.num_queries, a.hidden_dim * 2,
                                        device=device)

        # one class, count and bbox head per decoder layer with box
        # refinement; one module shared by every layer without it
        # (gvl.py:235-262, reference pdvc.py:124-146)
        def class_head():
            if a.support_mlp_class_head:
                return MLP(a.hidden_dim, a.hidden_dim, a.num_classes, 3,
                           device=device)
            return nn.Linear(a.hidden_dim, a.num_classes, device=device)

        def heads(make):
            if a.with_box_refine:
                return nn.ModuleList(make() for _ in range(num_pred))
            return nn.ModuleList([make()] * num_pred)

        self.class_head = heads(class_head)
        self.count_head = heads(lambda: nn.Linear(
            a.hidden_dim, a.max_eseq_length + 1, device=device))
        self.bbox_head = heads(lambda: MLP(a.hidden_dim, a.hidden_dim, 2, 3,
                                           device=device))

        if a.share_caption_head:
            self.caption_head = nn.ModuleList([self._captioner(device)]
                                              * num_pred)
        else:
            self.caption_head = nn.ModuleList(self._captioner(device)
                                              for _ in range(num_pred))
        if a.enable_contrastive:
            self._init_text_side(device)

    def _captioner(self, device) -> nn.Module:
        """The caption head of caption_decoder_type (gvl.py:316-344)."""
        a = self.arch
        query_dim = a.hidden_dim * (2 if a.enable_pos_emb_for_captioner
                                    else 1)
        if a.caption_decoder_type == "standard":
            return LSTMDSACaptioner(
                a.vocab_size, a.input_encoding_size, a.rnn_size, a.hidden_dim,
                a.cap_num_feature_levels, a.cap_nheads, a.cap_dec_n_points,
                a.att_hid_size, a.max_caption_len,
                a.enable_pos_emb_for_captioner, a.drop_prob, device=device)
        if a.caption_decoder_type == "light":
            return LightCaptioner(a.vocab_size, a.input_encoding_size,
                                  a.rnn_size, a.max_caption_len, query_dim,
                                  a.drop_prob, device=device)
        if a.caption_decoder_type == "transformer":
            return TransformerDSACaptioner(
                a.vocab_size, a.input_encoding_size, a.hidden_dim,
                a.cap_num_layers, a.cap_num_feature_levels, a.cap_nheads,
                a.cap_dec_n_points, a.max_caption_len, query_dim, a.drop_prob,
                device=device)
        if a.caption_decoder_type == "gpt2":
            # (gvl.py:334-343) the prefix is the event feature, hidden_dim
            # wide: Flax infers the mapper's input width from it, whatever
            # prefix_size says
            return GPT2Captioner(GPT2Spec(
                vocab_size=a.gpt_vocab_size, n_embd=a.gpt_n_embd,
                n_layer=a.gpt_n_layer, n_head=a.gpt_n_head,
                n_positions=a.gpt_n_positions, prefix_length=a.prefix_length,
                prefix_size=a.hidden_dim, mapping_type=a.gpt_mapping_type,
                prefix_num_mapping_layer=a.prefix_num_mapping_layer,
                stop_token_id=a.gpt_stop_token_id), device=device)
        return PuppetCaptioner(a.vocab_size, a.max_caption_len)

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
        # a shared head is one module: initialised once, as head 0
        for ch in dict.fromkeys(self.class_head):
            if isinstance(ch, nn.Linear):          # MLP heads keep zeros
                ch.bias.fill_(focal)
        for i, bh in enumerate(dict.fromkeys(self.bbox_head)):
            last = bh.layers[-1]
            last.weight.zero_()
            last.bias.zero_()
            if i == 0:
                last.bias[1] = self.arch.box_head_init_bias

    # ------------------------------------------------------------------ trunk
    def forward(self, feats, feat_mask, duration, proposals=None,
                proposals_mask=None) -> Dict[str, Any]:
        """The trunk. Port of GVLModel.__call__ (gvl.py:347-427): learnt
        queries, or in a two-stage model the proposals (B, G, 2) (center,
        length) in [0, 1] with their mask proposals_mask (B, G), whose
        embedding gives the queries (one per proposal, the masked ones kept
        out of the self-attention's keys); then every layer's boxes are the
        proposals, not refined (disable_iterative_refine)."""
        a = self.arch
        B = feats.shape[0]
        tr = self.transformer
        if a.two_stage != (proposals is not None):
            raise ValueError("GVLModel: a two-stage model takes proposals "
                             "and proposals_mask, a query-mode one neither")
        srcs, masks, poses = self.base_encoder(feats, feat_mask, duration)
        src_flat, mask_flat, pos_flat, shapes, valid_ratios = flatten_levels(
            srcs, masks, poses, tr.level_embed)
        memory = tr.encoder(src_flat, pos_flat, mask_flat, shapes, valid_ratios)

        if proposals is None:
            q = self.query_embed.weight
            query_pos = q[None, :, :a.hidden_dim].expand(B, -1, -1)
            tgt = q[None, :, a.hidden_dim:].expand(B, -1, -1)
            ref = torch.sigmoid(tr.reference_points(query_pos))      # (B,Nq,1)
            qmask = torch.ones((B, a.num_queries), dtype=torch.bool,
                               device=feats.device)
        else:
            ref = proposals                                          # (B,G,2)
            pos = tr.pos_trans_norm(tr.pos_trans(
                proposal_pos_embed(inverse_sigmoid(proposals))))
            query_pos, tgt = pos.chunk(2, dim=-1)
            qmask = proposals_mask.bool()
        refine = a.with_box_refine and proposals is None

        hs_list, ref_before_list = [], []
        out = tgt
        for lid, layer in enumerate(tr.decoder.layers):
            ref_input = expand_reference_for_levels(ref, valid_ratios)
            out = run_layer(layer, a.remat_trunk, out, query_pos, ref_input,
                            memory, mask_flat, shapes, qmask)
            hs_list.append(out)
            ref_before_list.append(ref)
            if refine:
                ref = self._refine(self.bbox_head[lid](out), ref).detach()

        logits, counts, coords, event_embeds = [], [], [], []
        for lid, h in enumerate(hs_list):
            logits.append(self.class_head[lid](h))
            counts.append(self.count_head[lid](h.amax(dim=1)))
            if proposals is None:
                coords.append(self._refine(self.bbox_head[lid](h),
                                           ref_before_list[lid]))
            else:
                coords.append(proposals)
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
    def caption_train_gpt(self, layer_id: int, query, tokens, token_mask):
        """The ClipCap loss of each (video, event) pair (gvl.py:553-563):
        query (B, Ne, C) the prefixes, tokens and token_mask (B, Ne, Lg).
        Returns (B, Ne)."""
        B, Ne, C = query.shape
        loss, _ = self.caption_head[layer_id](
            query.reshape(B * Ne, C), tokens.reshape(B * Ne, -1),
            token_mask.reshape(B * Ne, -1).float())
        return loss.reshape(B, Ne)

    def caption_sample_gpt(self, layer_id: int, query, entry_length: int = 30,
                           early_exit: bool = False):
        """Greedy ClipCap decode of every event (gvl.py:565-575): (tokens,
        probs, gen_mask), each (B, Ne, L)."""
        B, Ne, C = query.shape
        out = self.caption_head[layer_id].sample(
            query.reshape(B * Ne, C), entry_length=entry_length,
            early_exit=early_exit)
        return tuple(x.reshape(B, Ne, -1) for x in out)

    def caption_bf16(self):
        """A context in which the caption heads' parameters read as bf16
        (`bf16_cast_caption_params`, gvl_tpu/utils/amp.py:21-32). The
        caller casts the query and the memory. The LSTM heads then run bf16
        throughout; the transformer head adds f32 position encodings to its
        embeddings, so its layers promote (utils/amp.py)."""
        lstm = isinstance(self.caption_head[0], (LSTMDSACaptioner,
                                                 LightCaptioner))
        return bf16_parameters(self.caption_head, promote=not lstm)

    def caption_train(self, layer_id: int, query, reference, memory,
                      memory_mask, temporal_shapes, valid_ratios, seq,
                      ss_prob: float = 0.0, ref_prepared: bool = False,
                      generator: torch.Generator = None):
        """Teacher-forced logprobs (B, Ne, Lc-1, V+1) of the layer's caption
        head (gvl.py:474-489). Scheduled sampling (ss_prob, its draws from
        `generator`) is the LSTM-DSA head's alone; the others teacher-force.
        Prepared references (ref_prepared) are read by the LSTM-DSA head and
        ignored by the light one, which reads no reference; the other heads
        refuse them."""
        head = self.caption_head[layer_id]
        args = (query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq)
        if isinstance(head, LSTMDSACaptioner):
            return head(*args, ss_prob=ss_prob, ref_prepared=ref_prepared,
                        generator=generator)
        _refuse_prepared(head, ref_prepared)
        return head(*args)

    def caption_train_nll(self, layer_id: int, query, reference, memory,
                          memory_mask, temporal_shapes, valid_ratios, seq,
                          seq_mask, ref_prepared: bool = False):
        """Teacher-forcing NLL (B, Ne) (gvl.py:491-519): fused (picked logit
        minus logsumexp, no normalised logprob tensor) for the LSTM heads,
        caption_nll over caption_train's logprobs for the others."""
        head = self.caption_head[layer_id]
        args = (query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios, seq, seq_mask)
        if isinstance(head, LSTMDSACaptioner):
            return head.teacher_forced_nll(*args, ref_prepared=ref_prepared)
        if isinstance(head, LightCaptioner):
            return head.teacher_forced_nll(*args)
        lp = self.caption_train(layer_id, query, reference, memory,
                                memory_mask, temporal_shapes, valid_ratios,
                                seq, ref_prepared=ref_prepared)
        B, Ne = seq.shape[:2]
        return caption_nll(lp.reshape(B * Ne, *lp.shape[2:]),
                           seq[:, :, 1:].reshape(B * Ne, -1),
                           seq_mask[:, :, 1:].reshape(B * Ne, -1)
                           ).reshape(B, Ne)

    def caption_sample(self, layer_id: int, query, reference, memory,
                       memory_mask, temporal_shapes, valid_ratios,
                       beam_size: int = 1, greedy: bool = True,
                       temperature: float = 1.0,
                       generator: torch.Generator = None,
                       early_exit: bool = False,
                       ref_prepared: bool = False):
        """Decode with the layer's caption head (gvl.py:521-550): beam search
        (beam_size > 1, the LSTM-DSA head, plain references), else greedy or
        sampled, with early_exit for the LSTM-DSA, light and transformer
        heads. With ref_prepared, `reference` is already
        prepare_dsa_reference's (B, Ne, L, 2), which the fused SCST path
        concatenates across layers. The head's dropout follows its mode."""
        head = self.caption_head[layer_id]
        args = (query, reference, memory, memory_mask, temporal_shapes,
                valid_ratios)
        if beam_size > 1:
            if not isinstance(head, LSTMDSACaptioner) or ref_prepared:
                raise ValueError("beam search is implemented for the LSTM-DSA "
                                 "head over plain references")
            return head.sample_beam(*args, beam_size=beam_size)
        kwargs = dict(greedy=greedy, temperature=temperature,
                      generator=generator, early_exit=early_exit)
        if isinstance(head, LSTMDSACaptioner):
            kwargs["ref_prepared"] = ref_prepared
        else:
            _refuse_prepared(head, ref_prepared)
        return head.sample(*args, **kwargs)


def _refuse_prepared(head: nn.Module, ref_prepared: bool) -> None:
    """Only the LSTM-DSA head reads prepared references; the light head
    reads none (gvl.py:481-487)."""
    if ref_prepared and not isinstance(head, LightCaptioner):
        raise ValueError("ref_prepared is only supported by the "
                         "standard/light caption heads")


def build_model(cfg: Any, text_hidden_dim: int = 768, device=None,
                generator: torch.Generator = None,
                gpt_spec: GPT2Spec = None) -> GVLModel:
    """GVLModel for `cfg`, in eval mode, on `device`: the current CUDA device
    when none is given (raising where there is none), so a CPU caller asks
    for "cpu". text_hidden_dim is the text encoder's width (its
    `hidden_size`), read only with enable_contrastive; gpt_spec the gpt2
    head's, by default load_gpt2_spec(cfg)'s. With a generator, its
    parameters are drawn with the JAX package's initializers; without one
    they are left uninitialised for `load_state_dict`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_model: no CUDA device is available; pass "
                "device='cpu' to build the model on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.device("meta"):
        model = GVLModel(GVLArch.from_config(cfg, text_hidden_dim, gpt_spec),
                         device="meta")
    model = model.to_empty(device=device)
    if generator is not None:
        init_params(model, generator)
    return model.eval()
