"""1-D multi-scale deformable attention (port of gvl_tpu/ops/ms_deform_attn.py).

Semantics, for each (batch b, query q, head h, level l, point p):

    x   = clip(loc * T_l - 0.5, 0, T_l - 1)
    i0  = floor(x); f = x - i0; i1 = min(i0 + 1, T_l - 1)
    tap = value[b, start_l + i0, h] * (1 - f) + value[b, start_l + i1, h] * f
    out[b, q, h] = sum_{l,p} attn[b, q, h, l, p] * tap

Shapes: value (B, S, H, Dh) with S = sum(temporal_shapes); loc, attn
(B, Lq, H, L, P); out (B, Lq, H * Dh).

`ms_deform_attn_1d` runs the hand-written CUDA kernels on a CUDA tensor:
csrc/ms_deform_attn_fwd.cu in the forward (the port of the TPU kernel
gvl_tpu/ops/ms_deform_attn.py::_fwd_kernel) and csrc/ms_deform_attn_bwd.cu
in the backward (the port of ::_bwd_kernel_full, with the derivative of the
tap preparation folded in). On a CPU tensor it runs the plain version
`ms_deform_attn_1d_ref`, differentiated by autograd.
`ms_deform_attn_1d_bwd_ref` is the backward kernel's plain version.

Gradient of loc at the clamp: zero where the clamp is active and on its two
bounds (x = 0 and x = T_l - 1 exactly), in the kernel, in its plain version
and under autograd of `ms_deform_attn_1d_ref` alike.
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


def _inside_clamp(x_raw: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Taps whose position lies strictly between the clamp's bounds."""
    return (x_raw > 0) & (x_raw < t - 1.0)


def tap_parts(temporal_shapes: Sequence[int], loc: torch.Tensor):
    """Global tap indices g0, g1 (int64), the lerp fraction f, the unclamped
    tap position x_raw and the level lengths t (L, 1)."""
    starts = [0]
    for t in temporal_shapes[:-1]:
        starts.append(starts[-1] + int(t))
    t = level_tensor(temporal_shapes, loc)[:, None]                  # (L, 1)
    starts_t = level_tensor(starts, loc, torch.long)[:, None]
    x_raw = loc * t - 0.5
    x = torch.clamp(x_raw, torch.zeros_like(t), t - 1.0)
    if loc.requires_grad:
        # same values; the gradient is cut on the clamp's bounds as well as
        # outside them (torch.clamp alone would pass it on the bounds)
        x = torch.where(_inside_clamp(x_raw, t), x_raw, x.detach())
    i0 = torch.floor(x)
    f = x - i0.detach()
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, (t - 1.0).long())
    return i0 + starts_t, i1 + starts_t, f, x_raw, t


def prep_taps(temporal_shapes: Sequence[int], loc: torch.Tensor,
              attn: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Global tap indices g0, g1 (int64) and lerp-folded weights w0, w1, all
    (B, Lq, H, L, P). Port of `_prep_taps` (ms_deform_attn.py:56-81)."""
    g0, g1, f, _, _ = tap_parts(temporal_shapes, loc)
    return g0, g1, attn * (1.0 - f), attn * f


def _gather_taps(value: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """value (B, S, H, Dh), g (B, Lq, H, L, P) -> (B, H, Lq, L*P, Dh)."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g.shape
    v = value.permute(0, 2, 1, 3).reshape(B * H, S, Dh)
    idx = g.permute(0, 2, 1, 3, 4).reshape(B * H, Lq * L * P, 1)
    return torch.take_along_dim(v, idx, dim=1).reshape(B, H, Lq, L * P, Dh)


def weighted_tap_sum(value: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor,
                     w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """sum_k w0 * value[g0] + w1 * value[g1] over the K = L*P taps of each
    query: value (B, S, H, Dh), taps (B, Lq, H, L, P) -> (B, Lq, H*Dh)."""
    B, S, H, Dh = value.shape
    Lq = g0.shape[1]

    def flat(w):
        return w.to(value.dtype).permute(0, 2, 1, 3, 4).reshape(
            B, H, Lq, -1, 1)

    out = (_gather_taps(value, g0) * flat(w0)
           + _gather_taps(value, g1) * flat(w1)).sum(dim=3)        # (B,H,Lq,Dh)
    return out.permute(0, 2, 1, 3).reshape(B, Lq, H * Dh)


def ms_deform_attn_1d_ref(value: torch.Tensor, temporal_shapes: Sequence[int],
                          loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Plain version: gathers and a weighted sum. Differentiable by autograd.
    Port of `ms_deform_attn_1d_ref` (ms_deform_attn.py:88-114)."""
    return weighted_tap_sum(value, *prep_taps(temporal_shapes, loc, attn))


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


def tap_grads(grad_out: torch.Tensor, value: torch.Tensor, g0: torch.Tensor,
              g1: torch.Tensor, f: torch.Tensor, x_raw: torch.Tensor,
              t: torch.Tensor, attn: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(grad_value, grad_loc, grad_attn) of `weighted_tap_sum` over taps read
    at rows g0, g1 with lerp fraction f, by the backward kernels' formulas:
    per-tap dot products for loc and attn, `index_add_` for value."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g0.shape
    go = grad_out.reshape(B, Lq, H, Dh).permute(0, 2, 1, 3)        # (B,H,Lq,Dh)
    go = go[:, :, :, None, :]

    def dots(g):                          # <V[g], dOut> -> (B, Lq, H, L, P)
        d = (_gather_taps(value, g) * go).sum(-1)                  # (B,H,Lq,K)
        return d.permute(0, 2, 1, 3).reshape(B, Lq, H, L, P)

    d0, d1 = dots(g0), dots(g1)
    grad_attn = (1.0 - f) * d0 + f * d1
    grad_loc = torch.where(_inside_clamp(x_raw, t),
                           attn * t * (d1 - d0), torch.zeros_like(d0))

    grad_value = value.new_zeros((B * H * S, Dh))
    bh = torch.arange(B * H, device=value.device)[:, None] * S
    for g, w in ((g0, attn * (1.0 - f)), (g1, attn * f)):
        idx = g.permute(0, 2, 1, 3, 4).reshape(B * H, -1) + bh
        w = w.permute(0, 2, 1, 3, 4).reshape(B, H, Lq, L * P, 1)
        grad_value.index_add_(0, idx.reshape(-1), (w * go).reshape(-1, Dh))
    grad_value = grad_value.reshape(B, H, S, Dh).permute(0, 2, 1, 3)
    return grad_value.contiguous(), grad_loc, grad_attn


def ms_deform_attn_1d_bwd_ref(grad_out: torch.Tensor, value: torch.Tensor,
                              temporal_shapes: Sequence[int],
                              loc: torch.Tensor, attn: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: (grad_value, grad_loc,
    grad_attn) of `ms_deform_attn_1d_ref` for the output gradient grad_out
    (B, Lq, H*Dh)."""
    with torch.no_grad():
        g0, g1, f, x_raw, t = tap_parts(temporal_shapes, loc)
        return tap_grads(grad_out, value, g0, g1, f, x_raw, t, attn)


def check_kernel_inputs(value, temporal_shapes, loc, attn, grad_out=None):
    tensors = [("value", value), ("loc", loc), ("attn", attn)]
    if grad_out is not None:
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
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
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("ms_deform_attn kernel: inputs on different devices")
    if grad_out is not None and grad_out.shape != (
            B, loc.shape[1], H * value.shape[3]):
        raise ValueError(f"ms_deform_attn kernel: grad_out "
                         f"{tuple(grad_out.shape)} is not (B, Lq, H*Dh)")


def ms_deform_attn_1d_cuda(value: torch.Tensor, temporal_shapes: Sequence[int],
                           loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. float32 CUDA tensors only;
    raises on anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn)
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


def ms_deform_attn_1d_bwd_cuda(grad_out: torch.Tensor, value: torch.Tensor,
                               temporal_shapes: Sequence[int],
                               loc: torch.Tensor, attn: torch.Tensor,
                               need_value: bool = True
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward CUDA kernel on the current stream and return
    (grad_value, grad_loc, grad_attn); grad_value is None, and nothing is
    scattered, with need_value=False. float32 contiguous CUDA tensors only;
    raises on anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn, grad_out)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = loc.shape
    # the kernel adds into grad_value with atomics: zeroed, on this stream
    grad_value = torch.zeros_like(value) if need_value else None
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    shapes = (ctypes.c_int * L)(*(int(t) for t in temporal_shapes))
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().msda_bwd_f32(
            grad_out.data_ptr(), value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), grad_value.data_ptr() if need_value else None,
            grad_loc.data_ptr(), grad_attn.data_ptr(),
            B, S, H, Dh, Lq, L, P, shapes, stream)
    if err != 0:
        raise RuntimeError("ms_deform_attn backward kernel launch failed: "
                           f"CUDA error {err}")
    ms_deform_attn_1d.bwd_launches += 1
    return grad_value, grad_loc, grad_attn


class _MSDeformAttnCUDA(torch.autograd.Function):
    """Forward and backward are the two CUDA kernels; neither gives way to
    the plain version."""

    @staticmethod
    def forward(ctx, value, temporal_shapes, loc, attn):
        ctx.save_for_backward(value, loc, attn)
        ctx.temporal_shapes = temporal_shapes
        return ms_deform_attn_1d_cuda(value, temporal_shapes, loc, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        need_value, _, need_loc, need_attn = ctx.needs_input_grad
        if grad_out.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn backward: grad_out is "
                            f"{grad_out.dtype}, the kernel takes float32")
        # autograd hands over views (of an expand, a transpose) as often as not
        grad_value, grad_loc, grad_attn = ms_deform_attn_1d_bwd_cuda(
            grad_out.contiguous(), value, ctx.temporal_shapes, loc, attn,
            need_value=need_value)
        return (grad_value, None, grad_loc if need_loc else None,
                grad_attn if need_attn else None)


def ms_deform_attn_1d(value: torch.Tensor, temporal_shapes: Sequence[int],
                      loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Deformable attention: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. As in the JAX op, value is computed in float32
    and the result cast back to value's dtype. `ms_deform_attn_1d.launches`
    counts launches of the forward kernel, `.bwd_launches` of the backward
    kernel."""
    shapes = tuple(int(t) for t in temporal_shapes)
    v32 = value.float()
    if value.is_cuda:
        out = _MSDeformAttnCUDA.apply(v32, shapes, loc, attn)
    else:
        out = ms_deform_attn_1d_ref(v32, shapes, loc, attn)
    return out.to(value.dtype)


ms_deform_attn_1d.launches = 0
ms_deform_attn_1d.bwd_launches = 0
