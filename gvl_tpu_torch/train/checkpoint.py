"""Checkpoints of the port: the JAX package's CheckpointManager and
load_pretrained (gvl_tpu/train/checkpoint.py:20-118) in PyTorch's idiom.

One file per checkpoint, `<folder>/<name>.pth` (the JAX package's names:
'model-best', 'model-last', 'model-best-grounding', ...), holding
`{"model": state_dict, "text_encoder": state_dict or None, "epoch": int}`
with every tensor on the CPU and, when `save` is given the TrainState, the
train state beside it: "optimizer" and "scheduler" (the model's), and
"text_optimizer" and "text_scheduler" (None while the text encoder is
frozen) as their `state_dict()`s, and "step", the number of updates taken.
A file is written whole or not at all. `restore` puts all of it back into a
live TrainState; `restore_raw` reads a payload with `torch.load(...,
weights_only=True)`, which unpickles tensors and plain containers only, and
reads the weights-only checkpoints as well.

`load_pretrained` merges a checkpoint's model weights into a fresh model:
mode 'full', 'encoder' or 'decoder' and the remove_*_weight flags, with the
JAX package's rule, which is written on its flax top-level names; the port
maps each of its state_dict names to that top-level name (`jax_top_name`),
so it loads the image under gvl_tpu_torch.convert of the set JAX loads.

Orbax checkpoints of the JAX package cannot be read without JAX: weights
cross between the packages through gvl_tpu_torch.convert
(`jax_params_to_state_dict`, `flax_roberta_to_state_dict`).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn


# a train state's optimizers and schedules, as a checkpoint names them
_OPTIMIZERS = ("optimizer", "scheduler", "text_optimizer", "text_scheduler")


def _cpu_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _cpu_tree(node: Any) -> Any:
    """An optimizer's state_dict with its tensors copied to the CPU."""
    if isinstance(node, torch.Tensor):
        return node.detach().cpu().clone()
    if isinstance(node, dict):
        return {k: _cpu_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_cpu_tree(v) for v in node)
    return node


class CheckpointManager:
    def __init__(self, folder: str):
        self.folder = os.path.abspath(folder)
        os.makedirs(self.folder, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.folder, name + ".pth")

    def save(self, name: str, model: nn.Module,
             text_encoder: Optional[nn.Module], epoch: int,
             state: Any = None) -> str:
        """Write the checkpoint `name` (replacing one of that name) and
        return its path; the file appears whole or not at all. With the
        TrainState `state` (whose model and text encoder these are), its
        optimizers, schedules and step counter are written too (a state
        without text_optimizer, scheduler or text_scheduler attributes, as
        the TSP trainer's, has None for them)."""
        payload = {"model": _cpu_state(model),
                   "text_encoder": None if text_encoder is None
                   else _cpu_state(text_encoder),
                   "epoch": int(epoch)}
        if state is not None:
            def sd(obj):
                return None if obj is None else _cpu_tree(obj.state_dict())
            payload.update(
                {attr: sd(getattr(state, attr, None)) for attr in _OPTIMIZERS},
                step=int(state.step))
        path = self._path(name)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore(self, name: str, state: Any) -> Optional[Dict]:
        """Put checkpoint `name` back into the TrainState `state`: the
        model's and the text encoder's weights (strict), both optimizers,
        both schedules (each group's learning rate then taken from the
        state's own schedule at the restored step) and the step counter.
        Returns the payload (its "epoch" is the epoch it was saved at), or
        None when there is no such checkpoint. Raises if the checkpoint
        holds no train state."""
        payload = self.restore_raw(name)
        if payload is None:
            return None
        if "optimizer" not in payload:
            raise ValueError(f"checkpoint {name} holds weights only; resume "
                             "needs one saved with its train state")
        state.model.load_state_dict(payload["model"], strict=True)
        text = getattr(state, "text_encoder", None)
        if text is not None and payload["text_encoder"] is not None:
            text.load_state_dict(payload["text_encoder"], strict=True)
        for attr in _OPTIMIZERS:
            obj, saved = getattr(state, attr, None), payload[attr]
            if (obj is None) != (saved is None):
                raise ValueError(f"checkpoint {name}: {attr} is "
                                 f"{'missing' if saved is None else 'extra'}"
                                 " for this train state")
            if obj is not None:
                obj.load_state_dict(saved)
        for opt, sched in (("optimizer", "scheduler"),
                           ("text_optimizer", "text_scheduler")):
            if getattr(state, sched, None) is not None:
                _resync_lr(getattr(state, opt), getattr(state, sched))
        state.step = int(payload["step"])
        return payload

    def restore_raw(self, name: str) -> Optional[Dict]:
        """The payload of checkpoint `name`, its tensors on the CPU; None
        when there is none."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


def _resync_lr(optimizer, scheduler) -> None:
    """Set each group's learning rate to its schedule's value at the
    restored step, as optax computes it from the update count: a resumed
    run whose schedule changed (e.g. a longer `epoch`, and with it the
    total steps of a warm-up schedule) steps with the new one. With the
    schedule unchanged this is the saved value, bit for bit."""
    lrs = [base * fn(scheduler.last_epoch)
           for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


# the JAX package's rule (checkpoint.py:60-110), on flax top-level names
_ENCODER_PREFIXES = ("base_encoder", "encoder", "level_embed")

# port state_dict prefix -> flax top-level name; an index group \1 is kept
_JAX_TOP = (
    (r"base_encoder\.", "base_encoder"),
    (r"transformer\.level_embed$", "level_embed"),
    (r"transformer\.encoder\.", "encoder"),
    (r"transformer\.reference_points\.", "reference_points"),
    (r"transformer\.pos_trans\.", "pos_trans"),
    (r"transformer\.pos_trans_norm\.", "pos_trans_norm"),
    (r"transformer\.decoder\.layers\.(\d+)\.", r"decoder_layer_\1"),
    (r"query_embed\.", "query_embed"),
    (r"class_head\.(\d+)\.", r"class_head_\1"),
    (r"count_head\.(\d+)\.", r"count_head_\1"),
    (r"bbox_head\.(\d+)\.", r"bbox_head_\1"),
    (r"caption_head\.(\d+)\.", r"caption_head_\1"),
    (r"contrastive_projection_event\.(\d+)\.", r"cl_proj_event_\1"),
    (r"contrastive_projection_text\.(\d+)\.", r"cl_proj_text_\1"),
    (r"word_context_model\.", "word_context"),
    (r"sentence_context_model\.", "sentence_context"),
    (r"background_embed$", "background_embed"),
)


def jax_top_name(key: str) -> str:
    """The flax top-level name of the JAX parameter(s) that the port's
    state_dict entry `key` holds (gvl_tpu_torch/convert.py's mapping; a
    head shared across layers keeps the index of its port copy, which the
    rule's prefixes do not read)."""
    for pattern, top in _JAX_TOP:
        m = re.match(pattern, key)
        if m:
            return m.expand(top)
    raise KeyError(f"no JAX counterpart known for {key}")


def _resolve(path: str) -> str:
    """A .pth path, or a run directory's model-best.pth, else its
    model-last.pth (checkpoint.py:75-81)."""
    if path.endswith(".pth"):
        return path
    for cand in ("model-best.pth", "model-last.pth"):
        p = os.path.join(path, cand)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"load_pretrained: no model-best.pth or "
                            f"model-last.pth in {path}")


def load_pretrained(model: nn.Module, path: str, mode: str, cfg) -> List[str]:
    """Merge a pretrained run's model weights into `model`, in place
    (checkpoint.py:63-118).

    mode: 'full' | 'encoder' (only the pyramid, the deformable encoder and
    the level embedding; reference pdvc.py:170-175) | 'decoder' (everything
    else). remove_class_head_weight, remove_bbox_head_weight,
    remove_caption_head_weight or ft_captioner_from_scratch, and
    remove_contrastive_projection_weight drop their heads (reference
    train.py:96-148). A key whose shape differs from the model's is
    skipped. `path` is a .pth file of CheckpointManager or a run directory.
    Returns the sorted names of the entries loaded; raises when none
    matched. The text encoder is not touched."""
    if mode not in ("full", "encoder", "decoder"):
        raise ValueError(f"load_pretrained: unknown mode {mode!r}")
    src = torch.load(_resolve(path), map_location="cpu",
                     weights_only=True)["model"]
    removed = []
    if getattr(cfg, "remove_class_head_weight", False):
        removed.append("class_head")
    if getattr(cfg, "remove_bbox_head_weight", False):
        removed.append("bbox_head")
    if getattr(cfg, "remove_caption_head_weight", False) or \
            getattr(cfg, "ft_captioner_from_scratch", False):
        removed.append("caption_head")
    if getattr(cfg, "remove_contrastive_projection_weight", False):
        removed.append("cl_proj")

    def want(key: str) -> bool:
        top = jax_top_name(key)
        if any(top.startswith(p) for p in removed):
            return False
        is_enc = any(top.startswith(p) for p in _ENCODER_PREFIXES)
        if mode == "encoder":
            return is_enc
        if mode == "decoder":
            return not is_enc
        return True

    dst = model.state_dict()
    take = {k: v for k, v in src.items()
            if k in dst and want(k) and dst[k].shape == v.shape}
    if not take:
        raise ValueError(f"load_pretrained: no parameters of {path} matched "
                         "the model")
    with torch.no_grad():
        for k, v in take.items():
            dst[k].copy_(v)
    return sorted(take)
