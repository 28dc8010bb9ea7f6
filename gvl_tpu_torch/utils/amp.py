"""bfloat16 compute for the bf16 options: the counterpart of
gvl_tpu/utils/amp.py:11-32 (`bf16_cast_tree`, `bf16_cast_caption_params`).

The JAX package casts a parameter tree to bf16 and applies the model to it;
Flax's layers then compute in the promoted type of their inputs and
parameters: bf16 arithmetic with bf16 outputs where the activations are bf16
too (the caption heads under train_caption_bf16 / eval_decode_bf16, whose
query and memory are cast), f32 where an input is f32 (the trunk's position
encodings under eval_full_bf16). `bf16_parameters` is that cast here: inside
the block every float32 parameter of the module reads as its bf16 cast, made
inside autograd, so gradients reach the f32 parameters as through JAX's
`astype`. With `promote`, F.linear and F.layer_norm first cast their
floating operands to the promoted type, as Flax does (torch raises on an f32
input against bf16 weights); without it, a mixed call raises, which the LSTM
heads, whose activations are all bf16, never make. Norm statistics stay f32
in both frameworks (torch's bf16 norms accumulate in f32).
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

BF16 = torch.bfloat16

# the parameter-taking functions that meet an f32 activation and bf16
# weights (the trunk's position-encoded queries, the transformer head's
# position-encoded embeddings), whose operands Flax promotes to one type
_PROMOTED = {F.linear, F.layer_norm}


def _floats(x, out):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        out.append(x.dtype)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _floats(y, out)


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(y, dtype) for y in x)
    return x


class _Promote(TorchFunctionMode):
    """Casts the floating operands of the functions in `_PROMOTED` to their
    promoted type, JAX's rule for Flax's layers."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            dts = []
            _floats(args, dts)
            _floats(list(kwargs.values()), dts)
            if len(set(dts)) > 1:
                dt = dts[0]
                for d in dts[1:]:
                    dt = torch.promote_types(dt, d)
                args = _cast(args, dt)
                kwargs = {k: _cast(v, dt) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def bf16_parameters(module: torch.nn.Module, promote: bool = False):
    """Inside the block every float32 parameter of `module` (a shared
    submodule once) reads as its bf16 cast, computed inside autograd;
    `promote` adds Flax's promotion of mixed operands (see the module
    docstring). The parameters are put back on exit."""
    saved = []
    try:
        for m in module.modules():
            for name, p in list(m._parameters.items()):
                if p is not None and p.dtype == torch.float32:
                    saved.append((m, name, p))
                    m._parameters[name] = p.to(BF16)
        with (_Promote() if promote else contextlib.nullcontext()):
            yield
    finally:
        for m, name, p in saved:
            m._parameters[name] = p


def cast_floats(tree: Any, src: torch.dtype, dst: torch.dtype) -> Any:
    """Every `src` tensor of a nest of dicts, lists and tuples cast to `dst`
    (the trunk's outputs back to f32 under eval_full_bf16,
    gvl_tpu/eval/evaluate.py:127-131)."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, src, dst) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, src, dst) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == src:
        return tree.to(dst)
    return tree


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """An f32 activation cast to bf16 (the `cap_cast` of the JAX step)."""
    return x.to(BF16) if x.dtype == torch.float32 else x
