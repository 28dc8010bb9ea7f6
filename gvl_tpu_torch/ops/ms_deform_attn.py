"""1-D multi-scale deformable attention (port of gvl_tpu/ops/ms_deform_attn.py).

Semantics, for each (batch b, query q, head h, level l, point p):

    x   = clip(loc * T_l - 0.5, 0, T_l - 1)
    i0  = floor(x); f = x - i0; i1 = min(i0 + 1, T_l - 1)
    tap = value[b, start_l + i0, h] * (1 - f) + value[b, start_l + i1, h] * f
    out[b, q, h] = sum_{l,p} attn[b, q, h, l, p] * tap

Shapes: value (B, S, H, Dh) with S = sum(temporal_shapes); loc, attn
(B, Lq, H, L, P); out (B, Lq, H * Dh).

`ms_deform_attn_1d` runs the hand-written CUDA kernel
(csrc/ms_deform_attn_fwd.cu, the port of the TPU kernel
gvl_tpu/ops/ms_deform_attn.py::_fwd_kernel) on a CUDA tensor and the plain
version `ms_deform_attn_1d_ref` beside it on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch


def level_tensor(values: Sequence[int], like: torch.Tensor,
                 dtype: torch.dtype = None) -> torch.Tensor:
    """Per-level constants on `like`'s device. The host-to-device copy is
    issued without a stream synchronisation, so the decode loop that calls
    this every step does not stall the GPU."""
    return torch.tensor(values, dtype=dtype or like.dtype).to(
        like.device, non_blocking=True)


def prep_taps(temporal_shapes: Sequence[int], loc: torch.Tensor,
              attn: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Global tap indices g0, g1 (int64) and lerp-folded weights w0, w1, all
    (B, Lq, H, L, P). Port of `_prep_taps` (ms_deform_attn.py:56-81)."""
    starts = [0]
    for t in temporal_shapes[:-1]:
        starts.append(starts[-1] + int(t))
    t = level_tensor(temporal_shapes, loc)[:, None]                  # (L, 1)
    starts_t = level_tensor(starts, loc, torch.long)[:, None]
    x = torch.clamp(loc * t - 0.5, torch.zeros_like(t), t - 1.0)
    i0 = torch.floor(x)
    f = x - i0.detach()
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, (t - 1.0).long())
    return i0 + starts_t, i1 + starts_t, attn * (1.0 - f), attn * f


def _gather_taps(value: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """value (B, S, H, Dh), g (B, Lq, H, L, P) -> (B, H, Lq, L*P, Dh)."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g.shape
    v = value.permute(0, 2, 1, 3).reshape(B * H, S, Dh)
    idx = g.permute(0, 2, 1, 3, 4).reshape(B * H, Lq * L * P, 1)
    return torch.take_along_dim(v, idx, dim=1).reshape(B, H, Lq, L * P, Dh)


def ms_deform_attn_1d_ref(value: torch.Tensor, temporal_shapes: Sequence[int],
                          loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Plain version: gathers and a weighted sum. Differentiable by autograd.
    Port of `ms_deform_attn_1d_ref` (ms_deform_attn.py:88-114)."""
    B, S, H, Dh = value.shape
    Lq = loc.shape[1]
    g0, g1, w0, w1 = prep_taps(temporal_shapes, loc, attn)

    def flat(w):
        return w.to(value.dtype).permute(0, 2, 1, 3, 4).reshape(
            B, H, Lq, -1, 1)

    out = (_gather_taps(value, g0) * flat(w0)
           + _gather_taps(value, g1) * flat(w1)).sum(dim=3)        # (B,H,Lq,Dh)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, H * Dh)


def ms_deform_attn_1d_sampled_values(value: torch.Tensor,
                                     temporal_shapes: Sequence[int],
                                     loc: torch.Tensor) -> torch.Tensor:
    """Raw per-tap lerped values, not weighted or summed: (B, Lq, H, L*P, Dh).
    The LSTM-DSA captioner's sampling op, as the plain gather of
    `ms_deform_attn_1d_sampled_values` (ms_deform_attn.py:117-207)."""
    g0, g1, w0, w1 = prep_taps(temporal_shapes, loc, torch.ones_like(loc))
    B, Lq, H, L, P = loc.shape

    def flat(w):
        return w.to(value.dtype).permute(0, 2, 1, 3, 4).reshape(
            B, H, Lq, L * P, 1)

    out = _gather_taps(value, g0) * flat(w0) + _gather_taps(value, g1) * flat(w1)
    return out.permute(0, 2, 1, 3, 4)


def _check_kernel_inputs(value, temporal_shapes, loc, attn):
    for name, t in (("value", value), ("loc", loc), ("attn", attn)):
        if not t.is_cuda:
            raise ValueError(f"ms_deform_attn kernel: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn kernel: {name} is {t.dtype}, "
                            "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn kernel: {name} is not contiguous")
    if value.dim() != 4 or loc.dim() != 5 or attn.shape != loc.shape:
        raise ValueError("ms_deform_attn kernel: want value (B,S,H,Dh) and "
                         f"loc, attn (B,Lq,H,L,P); got {tuple(value.shape)}, "
                         f"{tuple(loc.shape)}, {tuple(attn.shape)}")
    B, S, H, _ = value.shape
    if loc.shape[0] != B or loc.shape[2] != H:
        raise ValueError(f"ms_deform_attn kernel: loc {tuple(loc.shape)} does "
                         f"not match value {tuple(value.shape)}")
    L = loc.shape[3]
    if L != len(temporal_shapes) or not 1 <= L <= 8:
        raise ValueError(f"ms_deform_attn kernel: {L} levels in loc, "
                         f"{len(temporal_shapes)} temporal shapes (1..8 taken)")
    if sum(int(t) for t in temporal_shapes) != S:
        raise ValueError(f"ms_deform_attn kernel: shapes {temporal_shapes} do "
                         f"not sum to S={S}")
    if len({value.device, loc.device, attn.device}) != 1:
        raise ValueError("ms_deform_attn kernel: inputs on different devices")


def ms_deform_attn_1d_cuda(value: torch.Tensor, temporal_shapes: Sequence[int],
                           loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. float32 CUDA tensors only;
    raises on anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    _check_kernel_inputs(value, temporal_shapes, loc, attn)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = loc.shape
    out = torch.empty((B, Lq, H * Dh), dtype=torch.float32, device=value.device)
    shapes = (ctypes.c_int * L)(*(int(t) for t in temporal_shapes))
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().msda_fwd_f32(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            B, S, H, Dh, Lq, L, P, shapes, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: CUDA error {err}")
    ms_deform_attn_1d.launches += 1
    return out


class _MSDeformAttnCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, temporal_shapes, loc, attn):
        return ms_deform_attn_1d_cuda(value, temporal_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the ms_deform_attn backward kernel is not ported yet "
            "(ROADMAP Queue 2 item 2); run the forward under "
            "torch.inference_mode() or use ms_deform_attn_1d_ref")


def ms_deform_attn_1d(value: torch.Tensor, temporal_shapes: Sequence[int],
                      loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Deformable attention: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. As in the JAX op, value is computed in float32
    and the result cast back to value's dtype. `ms_deform_attn_1d.launches`
    counts kernel launches."""
    shapes = tuple(int(t) for t in temporal_shapes)
    v32 = value.float()
    if value.is_cuda:
        out = _MSDeformAttnCUDA.apply(v32, shapes, loc, attn)
    else:
        out = ms_deform_attn_1d_ref(v32, shapes, loc, attn)
    return out.to(value.dtype)


ms_deform_attn_1d.launches = 0
