"""Released TSP / TAC and torchvision VideoResNet checkpoints into the
port's backbone, and the JAX package's names for each of its tensors.

Port of gvl_tpu/backbone/import_torch.py (reference
video_backbone/TSP/extract_features/extract_features.py:110-128: the
state_dict under 'model', fc heads stripped). The port's modules carry
torchvision's names, so a tensor fills the entry of its own name once the
'module.' (DDP) and 'features.' (the TSP Model) prefixes are stripped;
the heads `fc` / `fc1` fill the model's first head and `fc2` its second,
as the JAX importer maps them. A key with no entry of its name is returned
as unused, a parameter or running statistic that no key fills as unfilled
(`num_batches_tracked`, which the JAX tree does not hold, is neither), as
the JAX importer reports its variables; a shape that differs raises.

`flax_path` gives the JAX TSPModel variable of each torchvision name
(gvl_tpu/backbone/import_torch.py:37-100): gvl_tpu_torch.convert
.jax_tsp_to_state_dict reads the JAX package's variables through it.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

import torch

from gvl_tpu_torch.backbone.r2plus1d import BLOCK_COUNTS, R2Plus1D, TSPModel

_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}
# the reference's head names -> the index of the model's head
_HEADS = {"fc": 0, "fc1": 0, "fc2": 1}


def flax_path(key: str, backbone: str) -> Optional[Tuple[str, Tuple, str]]:
    """The JAX TSPModel variable of the torchvision-named tensor `key` (no
    prefix; heads `fc_<i>` by _HEADS): (collection, path, 'conv' | 'dense'
    | 'none', how the array is laid out), or None for num_batches_tracked.
    Raises KeyError for a name the backbone has no place for."""
    r21d = backbone != "r3d_18"
    counts = BLOCK_COUNTS[backbone]
    parts = key.split(".")

    def bn(prefix, leaf):
        if leaf == "num_batches_tracked":
            return None
        coll, name = _BN[leaf]
        return coll, prefix + (name,), "none"

    if parts[0] == "stem":
        names = ({0: "Conv_0", 1: "BatchNorm_0", 3: "Conv_1",
                  4: "BatchNorm_1"} if r21d else {0: "Conv_0",
                                                  1: "BatchNorm_0"})
        mod = ("backbone", names[int(parts[1])])
        if mod[1].startswith("Conv"):
            return "params", mod + ("kernel",), "conv"
        return bn(mod, parts[2])
    if parts[0].startswith("layer"):
        stage, b = int(parts[0][5:]) - 1, int(parts[1])
        block = ("backbone", f"BasicBlock_{sum(counts[:stage]) + b}")
        if parts[2] == "downsample":
            if parts[3] == "0":
                return "params", block + ("Conv_0", "kernel"), "conv"
            return bn(block + ("BatchNorm_2",), parts[4])
        c = int(parts[2][4:]) - 1
        if parts[3] != "0":
            return bn(block + (f"BatchNorm_{c}",), parts[4])
        if not r21d:
            return ("params", block + (f"Conv3DSimple_{c}", "Conv_0",
                                       "kernel"), "conv")
        inner = block + (f"Conv2Plus1D_{c}",)
        sub = {"0": ("Conv_0", "conv"), "1": ("BatchNorm_0", None),
               "3": ("Conv_1", "conv")}[parts[4]]
        if sub[1] is None:
            return bn(inner + (sub[0],), parts[5])
        return "params", inner + (sub[0], "kernel"), "conv"
    if parts[0].startswith("fc_"):
        if parts[1] == "weight":
            return "params", (parts[0], "kernel"), "dense"
        return "params", (parts[0], "bias"), "none"
    raise KeyError(key)


def _strip(key: str) -> str:
    for pre in ("module.", "features."):
        if key.startswith(pre):
            key = key[len(pre):]
    return key


def import_videoresnet_state_dict(
        state_dict: Dict[str, torch.Tensor], model: torch.nn.Module
) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Map a torch state_dict (raw VideoResNet, the TSP Model's, DDP's)
    onto `model`, an R2Plus1D or a TSPModel. Returns (the model's
    state_dict entries filled, f32 on the CPU; the keys left unused; the
    model's parameters and running statistics left unfilled), the lists
    sorted."""
    heads = getattr(model, "heads", [])
    prefix = "features." if isinstance(model, TSPModel) else ""
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for key, v in state_dict.items():
        k = _strip(key)
        head = k.split(".")[0]
        if head in _HEADS:
            i = _HEADS[head]
            dst = None if i >= len(heads) else heads[i] + k[len(head):]
        else:
            dst = prefix + k
        if dst not in own:
            unused.append(key)
            continue
        if tuple(v.shape) != own[dst]:
            raise ValueError(f"{key}: shape {tuple(v.shape)} against "
                             f"{dst} {own[dst]}")
        out[dst] = v.detach().to("cpu")
        if not dst.endswith("num_batches_tracked"):
            out[dst] = out[dst].float()
    for k in own:
        if k.endswith("num_batches_tracked"):
            out.setdefault(k, torch.zeros((), dtype=torch.long))
    unfilled = sorted(k for k in own if k not in out)
    return out, sorted(unused), unfilled


def read_pth(path: str):
    """A `.pth` payload, unpickling tensors and plain containers only (and
    argparse.Namespace: a TSP checkpoint's 'args')."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_tsp_checkpoint(pth_path: str, backbone: str):
    """Weights for R2Plus1D(backbone) from `pth_path`: (state_dict, unused,
    unfilled). A reference TSP `.pth` (the state_dict under 'model') or a
    raw VideoResNet one is imported with its fc heads stripped, as the
    reference extractor strips them (:123); the `backbone.pth` that
    import_cli --backbone writes ({"backbone", "arch"}) is read as it is,
    and refused if its arch is another."""
    blob = read_pth(pth_path)
    if isinstance(blob, dict) and {"backbone", "arch"} <= set(blob):
        if blob["arch"] != backbone:
            raise ValueError(f"{pth_path!r} holds a {blob['arch']} backbone, "
                             f"not {backbone!r}")
        return blob["backbone"], [], []
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    sd = {k: v for k, v in sd.items() if "fc" not in k}
    with torch.device("meta"):
        model = R2Plus1D(backbone, device="meta")
    return import_videoresnet_state_dict(sd, model)
