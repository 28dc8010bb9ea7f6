"""Weights checkpoints of the port: the weights half of the JAX package's
CheckpointManager (gvl_tpu/train/checkpoint.py:20-57) in PyTorch's idiom.

One file per checkpoint, `<folder>/<name>.pth` (the JAX package's names:
'model-best', 'model-last', 'model-best-grounding', ...), holding
`{"model": state_dict, "text_encoder": state_dict or None, "epoch": int}`
with every tensor on the CPU. `restore_raw` reads it with
`torch.load(..., weights_only=True)`, which unpickles tensors and plain
containers only; the caller loads the state_dicts with
`load_state_dict(strict=True)`. Optimizer state, resume and
`load_pretrained` are not ported yet (ROADMAP Queue 1, item 5).

Orbax checkpoints of the JAX package cannot be read without JAX: weights
cross between the packages through gvl_tpu_torch.convert
(`jax_params_to_state_dict`, `flax_roberta_to_state_dict`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn


def _cpu_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


class CheckpointManager:
    def __init__(self, folder: str):
        self.folder = os.path.abspath(folder)
        os.makedirs(self.folder, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.folder, name + ".pth")

    def save(self, name: str, model: nn.Module,
             text_encoder: Optional[nn.Module], epoch: int) -> str:
        """Write the checkpoint `name` (replacing one of that name) and
        return its path; the file appears whole or not at all."""
        payload = {"model": _cpu_state(model),
                   "text_encoder": None if text_encoder is None
                   else _cpu_state(text_encoder),
                   "epoch": int(epoch)}
        path = self._path(name)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        return path

    def restore_raw(self, name: str) -> Optional[Dict]:
        """The payload of checkpoint `name`, its tensors on the CPU; None
        when there is none."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location="cpu", weights_only=True)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))
