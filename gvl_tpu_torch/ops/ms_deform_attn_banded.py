"""Banded 1-D multi-scale deformable attention for token queries (Lq == S):
the long-sequence encoder self-attention. Port of
gvl_tpu/ops/ms_deform_attn_banded.py.

The function is the dense op of ms_deform_attn.py with one more clamp. The
queries of each level are cut into tiles of TILE_Q = 128 consecutive
queries from the level's start (the last tile of a level is short). For each
(batch, head, tile, target level l):

    T_pad = T_l rounded up to a multiple of 8
    BS    = band_sizes(...)[l], static per (query level, target level)
    s     = 8 * floor(clip(min i0 over the tile's taps into l, 0, T_pad - BS) / 8)
    every tap row r (i0 and i1 alike) is read at clip(r, s, s + BS - 1)

and the rest is the dense op: out = sum_k w0 * V_l[row0] + w1 * V_l[row1].
The clamp is inactive whenever the band covers the tile's taps (then the
result is the dense op's), and always when BS == T_pad. The tile width and
the rounding of s decide which taps get clamped, so they are part of the
function, not of a layout. The TPU kernel pads each level with zero rows to
T_pad; T_pad enters the function only through BS and the upper limit of s.
No tap is read from a padding row: s <= every i0 of the tile, so the clamp
only ever lowers a row, and a tap row is at most T_l - 1 to begin with.

`ms_deform_attn_1d_banded` runs the hand-written CUDA kernels on a CUDA
tensor: csrc/ms_deform_attn_banded_fwd.cu in the forward (the port of the
TPU kernel ms_deform_attn_banded.py::_fwd_kernel) and
csrc/ms_deform_attn_banded_bwd.cu in the backward (::_bwd_kernel, with the
derivative of the tap preparation folded in). On a CPU tensor it runs the
plain version `ms_deform_attn_1d_banded_ref`, differentiated by autograd.
`ms_deform_attn_1d_banded_bwd_ref` is the backward kernel's plain version.
`kernel_plan` is the host side of a launch (tables, shared memory, the sizes
the kernels refuse), computed from sizes alone so that it is tested without
a card.

The gradients follow the clamped rows: grad_value is added at the clamped
row, grad_attn and grad_loc use the value read there. grad_loc is zero on
and outside the tap clamp's bounds, as in the dense op.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from gvl_tpu_torch.ops.ms_deform_attn import (check_kernel_inputs,
                                              level_tensor, prep_taps,
                                              tap_grads, tap_parts,
                                              weighted_tap_sum)

TILE_Q = 128     # queries per tile; kTileQ in csrc/ms_deform_attn_banded.cuh
_ROW_ALIGN = 8   # level lengths and band starts are multiples of this
# limits of the CUDA kernels (csrc/ms_deform_attn_banded.cuh)
KERNEL_THREADS = 512          # a block; one thread per (level, point) at least
KERNEL_MAX_DH = 128           # two 16-byte accesses per lane and row
MAX_SHARED_BYTES = 232448     # the most shared memory a block may take, sm_90


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_shapes(temporal_shapes: Sequence[int]) -> Tuple[int, ...]:
    return tuple(_round_up(int(t), _ROW_ALIGN) for t in temporal_shapes)


def band_sizes(shapes_pad: Sequence[int], Tq: int, margin: int
               ) -> Tuple[int, ...]:
    """Band size per target level for the tiles of a query level of Tq
    queries: the span of TILE_Q queries mapped into the level plus `margin`
    rows on each side, at least 16, rounded up to a multiple of 8, at most
    the padded level. Port of `_band_sizes` (ms_deform_attn_banded.py:50-56)."""
    out = []
    for Tl in shapes_pad:
        span = math.ceil(TILE_Q * Tl / max(Tq, 1)) + 2 * margin
        out.append(min(Tl, _round_up(max(span, 16), _ROW_ALIGN)))
    return tuple(out)


def band_table(temporal_shapes: Sequence[int], margin: int
               ) -> Tuple[Tuple[int, ...], ...]:
    """band_sizes for every query level: table[query level][target level]."""
    shapes_pad = padded_shapes(temporal_shapes)
    return tuple(band_sizes(shapes_pad, int(Tq), margin)
                 for Tq in temporal_shapes)


def band_starts(i0: torch.Tensor, t_pad: torch.Tensor, bs: torch.Tensor
                ) -> torch.Tensor:
    """Band start per tile of one query level. i0 (B, Tq, H, L, P) holds the
    level-local lower tap rows of the level's Tq queries; t_pad and bs (L,)
    the padded level lengths and band sizes. Returns (B, n_tiles, H, L).
    Port of `_band_start` (ms_deform_attn_banded.py:59-62); the rows past a
    short last tile never lower its minimum."""
    B, Tq, H, L, _ = i0.shape
    n_tiles = -(-Tq // TILE_Q)
    m = i0.amin(dim=-1)                                           # (B,Tq,H,L)
    fill = m.new_full((B, n_tiles * TILE_Q - Tq, H, L),
                      torch.iinfo(torch.int32).max)
    m = torch.cat([m, fill], dim=1)
    m = m.reshape(B, n_tiles, TILE_Q, H, L).amin(dim=2)
    s = torch.clamp(m, torch.zeros_like(t_pad), t_pad - bs)
    return s // _ROW_ALIGN * _ROW_ALIGN


def banded_rows(temporal_shapes: Sequence[int], g0: torch.Tensor,
                g1: torch.Tensor, margin: int) -> Tuple[torch.Tensor, ...]:
    """The value rows the banded op reads for the taps g0, g1 (rows of the
    dense op, (B, S, H, L, P), one query per token): each clamped to its
    tile's band."""
    shapes = [int(t) for t in temporal_shapes]
    shapes_pad = padded_shapes(shapes)
    starts = [0]
    for t in shapes[:-1]:
        starts.append(starts[-1] + t)
    starts_t = level_tensor(starts, g0, torch.long)[:, None]
    t_pad = level_tensor(shapes_pad, g0, torch.long)
    rows0, rows1 = [], []
    qs = 0
    for Tq in shapes:
        bs = level_tensor(band_sizes(shapes_pad, Tq, margin), g0, torch.long)
        l0 = g0[:, qs:qs + Tq] - starts_t                  # level-local rows
        l1 = g1[:, qs:qs + Tq] - starts_t
        s = band_starts(torch.minimum(l0, l1), t_pad, bs)
        s = s.repeat_interleave(TILE_Q, dim=1)[:, :Tq, :, :, None]
        hi = s + (bs[:, None] - 1)
        rows0.append(torch.clamp(l0, s, hi) + starts_t)
        rows1.append(torch.clamp(l1, s, hi) + starts_t)
        qs += Tq
    return torch.cat(rows0, dim=1), torch.cat(rows1, dim=1)


def _check_token_queries(value, temporal_shapes, loc) -> None:
    S = sum(int(t) for t in temporal_shapes)
    if not loc.shape[1] == value.shape[1] == S:
        raise ValueError(
            "banded deformable attention takes one query per token: value "
            f"has {value.shape[1]} rows, loc {loc.shape[1]} queries, the "
            f"levels {tuple(temporal_shapes)} sum to {S}")


def ms_deform_attn_1d_banded_ref(value: torch.Tensor,
                                 temporal_shapes: Sequence[int],
                                 loc: torch.Tensor, attn: torch.Tensor,
                                 margin: int = 32) -> torch.Tensor:
    """Plain version: the dense op's gathers at the band-clamped rows.
    Differentiable by autograd."""
    _check_token_queries(value, temporal_shapes, loc)
    g0, g1, w0, w1 = prep_taps(temporal_shapes, loc, attn)
    r0, r1 = banded_rows(temporal_shapes, g0, g1, margin)
    return weighted_tap_sum(value, r0, r1, w0, w1)


def ms_deform_attn_1d_banded_bwd_ref(grad_out: torch.Tensor,
                                     value: torch.Tensor,
                                     temporal_shapes: Sequence[int],
                                     loc: torch.Tensor, attn: torch.Tensor,
                                     margin: int = 32
                                     ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: (grad_value, grad_loc,
    grad_attn) of `ms_deform_attn_1d_banded_ref` for the output gradient
    grad_out (B, S, H*Dh)."""
    _check_token_queries(value, temporal_shapes, loc)
    with torch.no_grad():
        g0, g1, f, x_raw, t = tap_parts(temporal_shapes, loc)
        r0, r1 = banded_rows(temporal_shapes, g0, g1, margin)
        return tap_grads(grad_out, value, r0, r1, f, x_raw, t, attn)


def band_row_numbers(table: Sequence[Sequence[int]]
                     ) -> Tuple[Tuple[int, ...], ...]:
    """The bands of a tile numbered through, per query level: entry l is the
    number of target level l's first band row, entry L the rows of all L
    bands. The backward kernel sorts a tile's tap rows by these numbers and
    keeps one counter per number."""
    return tuple(tuple(sum(row[:l]) for l in range(len(row) + 1))
                 for row in table)


class KernelPlan(NamedTuple):
    """What a launch of the banded kernels needs beside the tensors."""
    shapes: ctypes.Array        # level lengths (L)
    bands: ctypes.Array         # band table (L x L, row = query level)
    band_base: ctypes.Array     # L x (L + 1), see band_row_numbers
    shared_fwd: int             # dynamic shared memory of a block, bytes
    shared_bwd: int             # backward with grad_value
    shared_bwd_no_value: int    # backward without


@functools.lru_cache(maxsize=64)
def kernel_plan(temporal_shapes: Tuple[int, ...], margin: int, H: int, P: int,
                Dh: int) -> KernelPlan:
    """The host side of a launch, from sizes alone (kept per set of sizes:
    the model asks for the same plan at every layer and step). Per tap the
    forward keeps two row offsets and two weights in shared memory (16
    bytes), the backward two offsets, f, attn and attn * T_l (20 bytes); with
    grad_value the backward also keeps two (query, weight) hits per tap and
    one counter per band row of the tile. Raises ValueError on sizes the
    kernels refuse."""
    shapes = [int(t) for t in temporal_shapes]
    L, K = len(shapes), len(shapes) * P
    if Dh < 4 or Dh % 4 or Dh > KERNEL_MAX_DH:
        raise ValueError(
            f"banded ms_deform_attn kernel: head width {Dh}; the kernels read "
            f"rows in 16-byte pieces and take multiples of 4 up to "
            f"{KERNEL_MAX_DH}")
    if not 1 <= L <= 8 or P < 1 or K > KERNEL_THREADS:
        raise ValueError(
            f"banded ms_deform_attn kernel: {L} levels x {P} points; 1..8 "
            f"levels and at most {KERNEL_THREADS} taps per query are taken")
    if sum(shapes) * H * Dh > 2 ** 31 - 1:
        raise ValueError(
            f"banded ms_deform_attn kernel: a batch element of {sum(shapes)} "
            f"x {H} x {Dh} floats is past the 32-bit row offsets")
    table = band_table(shapes, margin)
    band_base = band_row_numbers(table)
    taps = TILE_Q * K
    plan = KernelPlan(
        shapes=(ctypes.c_int * L)(*shapes),
        bands=(ctypes.c_int * (L * L))(*(b for row in table for b in row)),
        band_base=(ctypes.c_int * (L * (L + 1)))(
            *(n for base in band_base for n in base)),
        shared_fwd=16 * taps,
        shared_bwd=36 * taps + 4 * max(base[L] for base in band_base),
        shared_bwd_no_value=20 * taps)
    if max(plan.shared_fwd, plan.shared_bwd) > MAX_SHARED_BYTES:
        raise ValueError(
            f"banded ms_deform_attn kernel: a block would take "
            f"{max(plan.shared_fwd, plan.shared_bwd)} bytes of shared memory "
            f"for levels {tuple(shapes)} x {P} points, past the "
            f"{MAX_SHARED_BYTES} it may have")
    return plan


def _plan_for(value: torch.Tensor, temporal_shapes: Sequence[int],
              loc: torch.Tensor, margin: int,
              grad_out: torch.Tensor | None = None) -> KernelPlan:
    """The plan of a launch on these tensors; raises ValueError on a size or
    an alignment the kernels refuse. Reads the tensors' metadata only."""
    _, _, H, Dh = value.shape
    plan = kernel_plan(tuple(int(t) for t in temporal_shapes), int(margin),
                       H, loc.shape[4], Dh)
    for name, t in (("value", value), ("grad_out", grad_out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"banded ms_deform_attn kernel: {name} is not "
                             "16-byte aligned; its rows are read in 16-byte "
                             "pieces")
    return plan


def ms_deform_attn_1d_banded_cuda(value: torch.Tensor,
                                  temporal_shapes: Sequence[int],
                                  loc: torch.Tensor, attn: torch.Tensor,
                                  margin: int = 32) -> torch.Tensor:
    """Launch the banded forward CUDA kernel on the current stream, once for
    all query levels. float32 contiguous CUDA tensors only; raises on
    anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn)
    _check_token_queries(value, temporal_shapes, loc)
    B, S, H, Dh = value.shape
    _, _, _, L, P = loc.shape
    plan = _plan_for(value, temporal_shapes, loc, margin)
    out = torch.empty((B, S, H * Dh), dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().msda_banded_fwd_f32(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            B, S, H, Dh, L, P, plan.shapes, plan.bands, plan.shared_fwd,
            stream)
    if err != 0:
        raise RuntimeError("banded ms_deform_attn kernel launch failed: CUDA "
                           f"error {err}")
    ms_deform_attn_1d_banded.launches += 1
    return out


def ms_deform_attn_1d_banded_bwd_cuda(grad_out: torch.Tensor,
                                      value: torch.Tensor,
                                      temporal_shapes: Sequence[int],
                                      loc: torch.Tensor, attn: torch.Tensor,
                                      margin: int = 32,
                                      need_value: bool = True
                                      ) -> Tuple[torch.Tensor, ...]:
    """Launch the banded backward CUDA kernel on the current stream and
    return (grad_value, grad_loc, grad_attn); grad_value is None, and nothing
    is scattered, with need_value=False. float32 contiguous CUDA tensors
    only; raises on anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn, grad_out)
    _check_token_queries(value, temporal_shapes, loc)
    B, S, H, Dh = value.shape
    _, _, _, L, P = loc.shape
    plan = _plan_for(value, temporal_shapes, loc, margin, grad_out)
    # the kernel adds into grad_value with atomics: zeroed, on this stream
    grad_value = torch.zeros_like(value) if need_value else None
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().msda_banded_bwd_f32(
            grad_out.data_ptr(), value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), grad_value.data_ptr() if need_value else None,
            grad_loc.data_ptr(), grad_attn.data_ptr(),
            B, S, H, Dh, L, P, plan.shapes, plan.bands, plan.band_base,
            plan.shared_bwd if need_value else plan.shared_bwd_no_value,
            stream)
    if err != 0:
        raise RuntimeError("banded ms_deform_attn backward kernel launch "
                           f"failed: CUDA error {err}")
    ms_deform_attn_1d_banded.bwd_launches += 1
    return grad_value, grad_loc, grad_attn


class _BandedMSDeformAttnCUDA(torch.autograd.Function):
    """Forward and backward are the two banded CUDA kernels; neither gives
    way to the plain version."""

    @staticmethod
    def forward(ctx, value, temporal_shapes, loc, attn, margin):
        ctx.save_for_backward(value, loc, attn)
        ctx.temporal_shapes, ctx.margin = temporal_shapes, margin
        return ms_deform_attn_1d_banded_cuda(value, temporal_shapes, loc, attn,
                                             margin)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attn = ctx.saved_tensors
        need_value, _, need_loc, need_attn, _ = ctx.needs_input_grad
        if grad_out.dtype != torch.float32:
            raise TypeError(f"banded ms_deform_attn backward: grad_out is "
                            f"{grad_out.dtype}, the kernel takes float32")
        grad_value, grad_loc, grad_attn = ms_deform_attn_1d_banded_bwd_cuda(
            grad_out.contiguous(), value, ctx.temporal_shapes, loc, attn,
            ctx.margin, need_value=need_value)
        return (grad_value, None, grad_loc if need_loc else None,
                grad_attn if need_attn else None, None)


def ms_deform_attn_1d_banded(value: torch.Tensor,
                             temporal_shapes: Sequence[int],
                             loc: torch.Tensor, attn: torch.Tensor,
                             margin: int = 32) -> torch.Tensor:
    """Banded deformable attention, one query per token: the CUDA kernels
    for a CUDA tensor, the plain version for a CPU tensor. value is computed
    in float32 and the result cast back to value's dtype.
    `ms_deform_attn_1d_banded.launches` counts launches of the forward
    kernel, `.bwd_launches` of the backward kernel."""
    shapes = tuple(int(t) for t in temporal_shapes)
    v32 = value.float()
    if value.is_cuda:
        out = _BandedMSDeformAttnCUDA.apply(v32, shapes, loc, attn, int(margin))
    else:
        out = ms_deform_attn_1d_banded_ref(v32, shapes, loc, attn, int(margin))
    return out.to(value.dtype)


ms_deform_attn_1d_banded.launches = 0
ms_deform_attn_1d_banded.bwd_launches = 0
