"""The GVL model in query mode: PDVC-style deformable-transformer event
detector with iterative box refinement and the LSTM-DSA caption head.

Port of gvl_tpu/models/gvl.py for the dense-captioning eval path. Not ported
yet, and refused by `build_model`: contrastive projections and the text side,
caption heads other than 'standard', MLP class heads, heads shared across
decoder layers (no box refinement), and beam search. Two-stage / proposal
queries are refused by the EvalRunner. Parameter names follow the reference pdvc/pdvc.py
state_dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch import nn

from gvl_tpu_torch.models.base_encoder import BasePyramidEncoder
from gvl_tpu_torch.models.captioner import LSTMDSACaptioner
from gvl_tpu_torch.models.layers import MLP, init_params
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
    feature_dim: int = 500
    msda_band_margin: int = 32

    @classmethod
    def from_config(cls, cfg: Any) -> "GVLArch":
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
            feature_dim=cfg.feature_dim,
            msda_band_margin=int(get("msda_band_margin", 32)),
        )


def _check_ported(a: GVLArch) -> None:
    if a.enable_contrastive:
        raise NotImplementedError(
            "the contrastive text side is not ported yet (ROADMAP Queue 1); "
            "evaluate with enable_contrastive=False (eval.py "
            "--eval_disable_contrastive)")
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
    """Trunk (`forward`) and greedy caption decode (`caption_sample`).

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
        self.transformer = DeformableTransformer(
            a.hidden_dim, a.ff_dim, a.enc_layers, a.dec_layers,
            a.num_feature_levels, a.nheads, a.enc_n_points, a.dec_n_points,
            a.msda_band_margin, device=device)
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
                a.enable_pos_emb_for_captioner, device=device)

        if a.share_caption_head:
            self.caption_head = nn.ModuleList([captioner(0)] * num_pred)
        else:
            self.caption_head = nn.ModuleList(captioner(i)
                                              for i in range(num_pred))

    def flax_init_(self, generator: torch.Generator) -> None:
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

        logits, counts, coords = [], [], []
        for lid, h in enumerate(hs_list):
            logits.append(self.class_head[lid](h))
            counts.append(self.count_head[lid](h.amax(dim=1)))
            coords.append(self._refine(self.bbox_head[lid](h),
                                       ref_before_list[lid]))
        return {
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

    @staticmethod
    def _refine(tmp, ref):
        """Box delta against the (pre-sigmoid) reference (gvl.py:429-435)."""
        if ref.shape[-1] == 2:
            return torch.sigmoid(tmp + inverse_sigmoid(ref))
        center = tmp[..., :1] + inverse_sigmoid(ref)
        return torch.sigmoid(torch.cat([center, tmp[..., 1:]], dim=-1))

    # ------------------------------------------------------------ captioning
    def caption_sample(self, layer_id: int, query, reference, memory,
                       memory_mask, temporal_shapes, valid_ratios,
                       beam_size: int = 1):
        """Greedy decode with the layer's caption head (gvl.py:521-550)."""
        if beam_size > 1:
            raise NotImplementedError("beam search is not ported yet")
        return self.caption_head[layer_id].sample(
            query, reference, memory, memory_mask, temporal_shapes,
            valid_ratios)


def build_model(cfg: Any, device=None,
                generator: torch.Generator = None) -> GVLModel:
    """GVLModel for `cfg` on `device`. With a generator, its parameters are
    drawn with the JAX package's initializers; without one they are left
    uninitialised for `load_state_dict`."""
    with torch.device("meta"):
        model = GVLModel(GVLArch.from_config(cfg), device="meta")
    model = model.to_empty(device=device or "cpu")
    if generator is not None:
        init_params(model, generator)
    return model.eval()
