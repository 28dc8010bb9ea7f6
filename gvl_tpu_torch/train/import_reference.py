"""A reference GVL / PDVC checkpoint (`.pth`) into the port.

The rules of gvl_tpu/train/checkpoint.py:121-364 (`import_pytorch_state_dict`)
and :457-466 (`import_pytorch_checkpoint`), on the port's names. The port's
modules carry the reference `state_dict` names, so each key fills the
parameter of its own name (a shape that differs is refused); what the rules
change is a short list:
- the payload under `model` when there is one (:463-464);
- dropped, counted as used and not read (`DROPPED`): the bbox heads'
  aliases under `transformer.decoder.bbox_head.*`, which the reference
  registers twice (pdvc.py:140; :355-358), the caption DSA's
  `output_proj` and `attention_weights`, which the reference's raw-samples
  path never reads (:343-348), `text_encoder.*`, whose weights come from
  `load_text_encoder` (:322-323), the cosine `pos_table` buffer (:312-314),
  and the query inputs of the other mode (`_OTHER_MODE`): in a query-mode
  model the two-stage `pos_trans` and `pos_trans_norm` (:224-233), in a
  two-stage one `reference_points`, which its tree does not hold (a
  query-mode checkpoint leaves `pos_trans` unfilled there; the JAX
  importer reads `reference_points` in either mode and stops, ROADMAP
  "Deliberate divergences");
- caption heads: with share_caption_head every `caption_head.{k}` goes to
  head 0, as cloned heads each to their own; a head the model does not
  have is dropped (:325-353);
- contrastive projections with no slot of their own (shared across layers,
  one module under every index) are read from index 0 and the copies
  checked equal (:268-283).
A key that lands on no parameter is returned as unused; a parameter of the
port's model that no key fills, as unfilled. A module shared across indices
is one slot, under its first name, as it is one flax module. Where the JAX
walk stops at the first missing index of a layer list and reports the later
indices unused, this map fills them (ROADMAP, "Deliberate divergences").
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

from gvl_tpu_torch.models.gvl import GVLArch, GVLModel

DROPPED = re.compile(
    r"transformer\.decoder\.bbox_head\."
    r"|caption_head\.\d+\.core\.deformable_att\."
    r"(output_proj|attention_weights)\."
    r"|text_encoder\."
    r"|sentence_context_model\.pos_table$")
_OTHER_MODE = re.compile(
    r"transformer\.(pos_trans|pos_trans_norm|reference_points)\.")
_CAPTION = re.compile(r"caption_head\.(\d+)\.")
_PROJECTION = re.compile(r"(contrastive_projection_(event|text))\.\d+\.")


def _slots(model: torch.nn.Module) -> Dict[str, List[str]]:
    """Each parameter or buffer of `model` under its first name -> every
    state_dict name it appears under (a shared module's aliases)."""
    first: Dict[int, str] = {}
    slots: Dict[str, List[str]] = {}
    for name, t in model.state_dict(keep_vars=True).items():
        key = id(t)
        if key not in first:
            first[key] = name
            slots[name] = []
        slots[first[key]].append(name)
    return slots


def import_reference_state_dict(sd: Dict[str, torch.Tensor], arch: GVLArch,
                                share_caption_head: bool = True
                                ) -> Tuple[Dict[str, torch.Tensor], List[str],
                                           List[str]]:
    """Map a reference state_dict (pdvc.PDVC.state_dict(), or a payload
    holding it under "model") onto GVLModel(arch). Returns (the port's
    state_dict of the filled entries, f32, every alias of a shared module
    included; the reference keys left unused; the model's parameters left
    unfilled, by their first names), the lists sorted."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    src = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    with torch.device("meta"):
        model = GVLModel(arch, device="meta")
    slots = _slots(model)
    alias_of = {a: s for s, names in slots.items() for a in names}
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    heads = {m.group(1) for m in map(_CAPTION.match, alias_of) if m}
    out: Dict[str, torch.Tensor] = {}
    unused, filled = [], set()
    for key, v in src.items():
        if DROPPED.match(key) or (_OTHER_MODE.match(key)
                                  and key not in alias_of):
            continue
        dst = key
        cap = _CAPTION.match(key)
        if cap:
            k = "0" if share_caption_head else cap.group(1)
            if k not in heads:
                continue
            dst = f"caption_head.{k}.{key[cap.end():]}"
        proj = _PROJECTION.match(key)
        if proj and dst not in slots:
            first = f"{proj.group(1)}.0.weight"
            if not torch.allclose(src[f"{proj.group(0)}weight"], src[first]):
                raise ValueError(f"import_reference_state_dict: "
                                 f"{proj.group(0)[:-1]} differs from index 0 "
                                 "but the model shares one projection")
            continue
        if dst not in alias_of:
            unused.append(key)
            continue
        if tuple(v.shape) != shapes[dst]:
            raise ValueError(f"import_reference_state_dict: {key} "
                             f"{tuple(v.shape)} against {dst} {shapes[dst]}")
        slot = alias_of[dst]
        for name in slots[slot]:
            out[name] = v.detach().to("cpu", torch.float32)
        filled.add(slot)
    params = {n for n, _ in model.named_parameters()}
    unfilled = sorted(s for s in slots if s in params and s not in filled)
    return out, sorted(unused), unfilled


def import_reference_checkpoint(pth_path: str, arch: GVLArch,
                                share_caption_head: bool = True):
    """Read a reference `.pth` (on the CPU, tensors and containers only)
    and map it with import_reference_state_dict."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    return import_reference_state_dict(sd, arch, share_caption_head)
