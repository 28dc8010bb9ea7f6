"""Find and read HF-format model files offline, without `transformers`,
`huggingface_hub` or `safetensors`.

What `from_pretrained(name, cache_dir=...)` reads under HF_HUB_OFFLINE=1
(gvl_tpu/models/text_encoder.py:76-87, gpt_captioner.py:329-331):
- `name` is a directory: its files are read from there;
- otherwise `name` is a hub name, looked up in the hub cache layout under
  `cache_dir`: `models--<name with / as -->/refs/main` holds the revision
  and `snapshots/<revision>/` the files. A relative `cache_dir` is read
  from the working directory, as HF reads it.

Weights come from `model.safetensors` (read by this module's own reader of
the format: an 8-byte little-endian header length, a JSON header, then the
raw little-endian tensors), else from `pytorch_model.bin` (`torch.load(...,
weights_only=True)`). A directory that holds only Flax (`flax_model.msgpack`)
or TF weights is refused by name, and so is a name that resolves to no
directory; the refusal names every path that was searched. (The JAX package
falls back silently to a random offline model instead; ROADMAP, "Deliberate
divergences".)
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Optional

import torch

OTHER_WEIGHTS = ("flax_model.msgpack", "tf_model.h5", "model.ckpt.index")

# safetensors dtype names <-> torch dtypes
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
           "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _hub_folder(name: str) -> str:
    return "models--" + name.replace("/", "--")


def _candidate_dirs(name: str, cache_dir: Optional[str]) -> List[str]:
    """The directories `resolve` looks at for `name`, in its order."""
    cands = [os.path.abspath(name)]
    if cache_dir:
        root = os.path.join(os.path.abspath(cache_dir), _hub_folder(name))
        ref = os.path.join(root, "refs", "main")
        if os.path.isfile(ref):
            with open(ref) as f:
                cands.append(os.path.join(root, "snapshots", f.read().strip()))
        else:
            cands.append(os.path.join(root, "refs", "main"))
    return cands


def resolve(name: str, cache_dir: Optional[str] = None) -> str:
    """The directory holding `name`'s files: `name` itself when it is a
    directory, else its snapshot in the hub cache under `cache_dir`. Raises
    FileNotFoundError naming every path searched when neither holds
    config.json."""
    cands = _candidate_dirs(name, cache_dir)
    for d in cands:
        if os.path.isfile(os.path.join(d, "config.json")):
            return d
    raise FileNotFoundError(
        f"HF files of {name!r} not found: no config.json in any of "
        f"{', '.join(cands)} (a directory, or the hub cache layout "
        f"{_hub_folder(name)}/refs/main + snapshots/<revision>/ under "
        f"huggingface_cache_dir={cache_dir!r}); nothing is downloaded")


def read_json(folder: str, name: str) -> Optional[dict]:
    """`folder/name` as JSON, or None when it is not there."""
    path = os.path.join(folder, name)
    if not os.path.isfile(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
        data = f.read()
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {key} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             "know")
        begin, end = info["data_offsets"]
        dtype = _DTYPES[info["dtype"]]
        buf = bytearray(data[begin:end])
        t = (torch.frombuffer(buf, dtype=dtype) if buf
             else torch.empty(0, dtype=dtype))
        out[key] = t.reshape(info["shape"])
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write `tensors` (any device; contiguous copies are taken on the CPU)
    in the safetensors format, the header padded with spaces to 8 bytes."""
    header, blobs, offset = {}, [], 0
    for key in sorted(tensors):
        t = tensors[key].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"write_safetensors: {key} has dtype {t.dtype}")
        raw = (t.view(torch.uint8) if t.dtype != torch.bool
               else t.to(torch.uint8)).numpy().tobytes() if t.numel() else b""
        header[key] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    header["__metadata__"] = {"format": "pt"}
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def read_weights(folder: str) -> Dict[str, torch.Tensor]:
    """The state_dict in `folder`: model.safetensors, else
    pytorch_model.bin. Raises FileNotFoundError naming what was searched,
    and the Flax or TF weights found instead, when there is neither."""
    st = os.path.join(folder, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    pt = os.path.join(folder, "pytorch_model.bin")
    if os.path.isfile(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
        return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    other = [n for n in OTHER_WEIGHTS if os.path.isfile(os.path.join(folder,
                                                                      n))]
    found = (f"; it holds {', '.join(other)}, which the port does not read "
             "(PyTorch weights only)") if other else ""
    raise FileNotFoundError(
        f"no weights in {folder}: searched {st} and {pt}{found}")

