"""Sequence-parallel 1-D multi-scale deformable attention: the port of
gvl_tpu/ops/ms_deform_attn_sp.py.

Each level's temporal axis is padded to a multiple of sp and cut into sp
contiguous chunks (`plan`, JAX's `_plan`); sp rank s holds chunk s of every
level, level-major (`chunk_rows`).

- Encoder mode ('tokens', `tokens_local`): the queries are the memory
  tokens, so both sides are cut. A rank serves its own queries' taps from
  its chunks plus, per level, a halo of min(chunk, max(2, ceil(halo_frac *
  Tp))) rows from each neighbour; the edge ranks zero the wrapped halo, and
  taps beyond the halo are clamped to its edge (JAX :138-243). With
  `count`, the taps the clamp moved that carry a nonzero weight are
  counted: 0 means the output is exact.
- Decoder mode ('replicated', `replicated_local`): the few queries are the
  same on every rank; each rank zeroes the weight of every tap outside its
  chunk and the partial outputs are summed over sp. Exact (JAX :245-282).

Both run the from-taps forms of kernels 1 and 2 (`ms_deform_attn_from_taps`;
the plain version on a CPU tensor) on the local taps, as JAX runs its TPU
kernels on them.

The module is in two parts. The local functions (`plan`, `chunk_rows`,
`tokens_taps`, `haloed`, `tokens_local`, `replicated_taps`,
`replicated_local`, `gather_levels`) are pure: given the sp
index, the rank's chunks and its neighbours' boundary slabs, they compute
its share, so a test drives every sp index in one process. The collective
layer (`exchange_halos`, `ms_deform_attn_1d_sp`, `gather_tokens`) moves
the slabs over the sp group as an all_gather (`parallel.gather_sp`, whose
backward returns each halo's gradient to its owner) and sums the decoder's
partial outputs (`parallel.sum_sp`).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from gvl_tpu_torch.ops.ms_deform_attn import (level_tensor,
                                              ms_deform_attn_1d,
                                              ms_deform_attn_from_taps,
                                              prep_taps, weighted_tap_sum)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=64)
def plan(temporal_shapes: Tuple[int, ...], sp: int, halo_frac: float):
    """Per level: the padded length, the chunk and the halo width (JAX's
    `_plan`, ms_deform_attn_sp.py:48-59)."""
    pads, chunks, halos = [], [], []
    for T in temporal_shapes:
        Tp = _round_up(int(T), sp)
        chunk = Tp // sp
        pads.append(Tp)
        chunks.append(chunk)
        halos.append(min(chunk, max(2, int(math.ceil(halo_frac * Tp)))))
    return tuple(pads), tuple(chunks), tuple(halos)


@functools.lru_cache(maxsize=64)
def _chunk_rows_np(temporal_shapes: Tuple[int, ...], sp: int, sidx: int):
    _, chunks, _ = plan(temporal_shapes, sp, 0.0)
    rows, valid, start = [], [], 0
    for T, chunk in zip(temporal_shapes, chunks):
        pos = sidx * chunk + np.arange(chunk)
        valid.append(pos < T)
        rows.append(start + np.minimum(pos, T - 1))
        start += T
    return np.concatenate(rows), np.concatenate(valid)


def chunk_rows(temporal_shapes: Sequence[int], sp: int, sidx: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """sp rank `sidx`'s tokens: the flat row (of the unpadded level-major
    S) of each of its sum(chunks) local rows, level by level, and whether
    the row is real (False: level padding, pointing at the level's last
    row)."""
    rows, valid = _chunk_rows_np(tuple(int(t) for t in temporal_shapes),
                                 int(sp), int(sidx))
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(valid).to(device))


def _level_rel(temporal_shapes, g: torch.Tensor) -> torch.Tensor:
    """Global flat rows -> rows within their level."""
    starts = np.cumsum([0] + list(temporal_shapes))[:-1]
    return g - level_tensor(starts, g)[:, None]


def _tap_sum(value, g0, g1, w0, w1, kernel: bool) -> torch.Tensor:
    """The from-taps op: the kernels' wrapper, or with kernel=False (the
    plain path that `set_msda_impl(..., 'ref')` selects) the plain sum."""
    if kernel:
        return ms_deform_attn_from_taps(value, g0, g1, w0, w1)
    return weighted_tap_sum(value.float(), g0, g1, w0.float(), w1.float())


def tokens_taps(sidx: int, sp: int, temporal_shapes: Sequence[int],
                halo_frac: float, loc: torch.Tensor, attn: torch.Tensor,
                count: bool = False):
    """Encoder mode's taps on sp rank `sidx`, from its queries' loc and attn
    (B, Lq_loc, H, L, P): rows g0, g1 into its haloed value (`haloed`),
    clamped to each level's window, and the weights w0, w1, 0 on the level
    padding's queries; then the count of the taps the clamp moved that
    carry a nonzero weight (0-d), or None without `count`."""
    shapes = tuple(int(t) for t in temporal_shapes)
    _, chunks, halos = plan(shapes, sp, halo_frac)
    g0, g1, w0, w1 = prep_taps(shapes, loc, attn)
    _, valid = chunk_rows(shapes, sp, sidx, loc.device)
    q_ok = valid[None, :, None, None, None]
    w0, w1 = w0 * q_ok, w1 * q_ok
    loc_starts = np.cumsum([0] + [c + 2 * h for c, h in
                                  zip(chunks, halos)])[:-1]
    lo = level_tensor(loc_starts, g0)[:, None]
    hi = lo + level_tensor([c + 2 * h - 1 for c, h in zip(chunks, halos)],
                           g0)[:, None]
    off = level_tensor([s + h - sidx * c for s, h, c in
                        zip(loc_starts, halos, chunks)], g0)[:, None]
    n_moved = None
    taps = []
    for g, w in ((g0, w0), (g1, w1)):
        gl = _level_rel(shapes, g) + off
        if count:
            n = (((gl < lo) | (gl > hi)) & (w != 0)).sum()
            n_moved = n if n_moved is None else n_moved + n
        taps.append(torch.minimum(torch.maximum(gl, lo), hi))
    return taps[0], taps[1], w0, w1, n_moved


def haloed(sidx: int, sp: int, temporal_shapes: Sequence[int],
           halo_frac: float, value: torch.Tensor, left: List[torch.Tensor],
           right: List[torch.Tensor]) -> torch.Tensor:
    """Rank `sidx`'s value with its halos, level by level [left halo,
    chunk, right halo] (B, S_loc, H, Dh); the edge ranks zero the wrapped
    halo (it holds the far end of the video)."""
    _, chunks, _ = plan(tuple(int(t) for t in temporal_shapes), sp,
                        halo_frac)
    not_first, not_last = float(sidx > 0), float(sidx < sp - 1)
    parts, q0 = [], 0
    for l, chunk in enumerate(chunks):
        parts += [left[l] * not_first, value[:, q0:q0 + chunk],
                  right[l] * not_last]
        q0 += chunk
    return torch.cat(parts, dim=1)


def tokens_local(sidx: int, sp: int, temporal_shapes: Sequence[int],
                 halo_frac: float, value: torch.Tensor,
                 left: List[torch.Tensor], right: List[torch.Tensor],
                 loc: torch.Tensor, attn: torch.Tensor, count: bool = False,
                 kernel: bool = True):
    """Encoder mode on sp rank `sidx`: value (B, Lq_loc, H, Dh) its chunks
    of every level, level-major; left[l], right[l] (B, halo_l, H, Dh) the
    last rows of level l's chunk on the rank before it and the first rows
    of the one after it (the wrapped ones too: the edge ranks zero them);
    loc, attn (B, Lq_loc, H, L, P) its queries'. Returns (out (B, Lq_loc,
    H*Dh) in value's dtype, the moved taps' count (0-d) or None without
    `count`)."""
    g0, g1, w0, w1, n = tokens_taps(sidx, sp, temporal_shapes, halo_frac,
                                    loc, attn, count)
    v = haloed(sidx, sp, temporal_shapes, halo_frac, value, left, right)
    return _tap_sum(v, g0, g1, w0, w1, kernel).to(value.dtype), n


def replicated_taps(sidx: int, sp: int, temporal_shapes: Sequence[int],
                    loc: torch.Tensor, attn: torch.Tensor):
    """Decoder mode's taps on sp rank `sidx` for loc and attn (B, Lq, H, L,
    P): rows g0, g1 into its chunks (B, sum(chunks), H, Dh), and weights
    w0, w1, 0 where the tap lies outside its chunk."""
    shapes = tuple(int(t) for t in temporal_shapes)
    _, chunks, _ = plan(shapes, sp, 0.0)
    g0, g1, w0, w1 = prep_taps(shapes, loc, attn)
    t0 = level_tensor([sidx * c for c in chunks], g0)[:, None]
    size = level_tensor(chunks, g0)[:, None]
    first = level_tensor(np.cumsum([0] + list(chunks))[:-1], g0)[:, None]
    taps, ws = [], []
    for g, w in ((g0, w0), (g1, w1)):
        rel = _level_rel(shapes, g) - t0
        inside = (rel >= 0) & (rel < size)
        taps.append(torch.minimum(torch.maximum(rel, torch.zeros_like(rel)),
                                  size - 1) + first)
        ws.append(torch.where(inside, w, torch.zeros_like(w)))
    return taps[0], taps[1], ws[0], ws[1]


def replicated_local(sidx: int, sp: int, temporal_shapes: Sequence[int],
                     value: torch.Tensor, loc: torch.Tensor,
                     attn: torch.Tensor, kernel: bool = True) -> torch.Tensor:
    """Decoder mode on sp rank `sidx`: value (B, sum(chunks), H, Dh) its
    chunk of every level, level-major; loc, attn (B, Lq, H, L, P) the
    queries every rank holds. The partial output (B, Lq, H*Dh) float32,
    whose sum over the ranks is the op's."""
    return _tap_sum(value, *replicated_taps(sidx, sp, temporal_shapes, loc,
                                            attn), kernel)


def gather_levels(blocks: torch.Tensor, temporal_shapes: Sequence[int],
                  sp: int) -> torch.Tensor:
    """(sp, B, sum(chunks), ...) every rank's tokens -> (B, S, ...) in the
    level-major order, unpadded."""
    shapes = tuple(int(t) for t in temporal_shapes)
    _, chunks, _ = plan(shapes, sp, 0.0)
    out, q0 = [], 0
    for T, chunk in zip(shapes, chunks):
        lvl = blocks[:, :, q0:q0 + chunk].transpose(0, 1)  # (B, sp, chunk,..)
        out.append(lvl.reshape(lvl.shape[0], sp * chunk,
                               *lvl.shape[3:])[:, :T])
        q0 += chunk
    return torch.cat(out, dim=1)


# ------------------------------------------------------------- collectives

def exchange_halos(value: torch.Tensor, temporal_shapes: Sequence[int],
                   ctx) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """This rank's left and right halos of every level (`tokens_local`'s
    `left`, `right`): each rank's first and last halo rows of each chunk,
    all_gathered over the sp group (gather_sp: the gradient of a halo goes
    back to the rank that owns its rows)."""
    from gvl_tpu_torch import parallel as dp
    shapes = tuple(int(t) for t in temporal_shapes)
    sp, sidx = ctx.sp, ctx.sp_rank
    _, chunks, halos = plan(shapes, sp, ctx.halo_frac)
    send, q0 = [], 0
    for chunk, hl in zip(chunks, halos):
        send += [value[:, q0:q0 + hl], value[:, q0 + chunk - hl:q0 + chunk]]
        q0 += chunk
    got = dp.gather_sp(torch.cat(send, dim=1))       # (sp, B, sum 2h, H, Dh)
    before, after = got[(sidx - 1) % sp], got[(sidx + 1) % sp]
    left, right, p0 = [], [], 0
    for hl in halos:
        right.append(after[:, p0:p0 + hl])
        left.append(before[:, p0 + hl:p0 + 2 * hl])
        p0 += 2 * hl
    return left, right


def ms_deform_attn_1d_sp(value: torch.Tensor, temporal_shapes: Sequence[int],
                         loc: torch.Tensor, attn: torch.Tensor, ctx,
                         queries: str = "tokens", kernel: bool = True):
    """The sp op on this rank (ctx: parallel.sp.SpContext). 'tokens':
    value, loc and attn are the rank's chunks (`chunk_rows`); returns (its
    queries' out, the moved taps' count or None without
    ctx.clamp_monitor). 'replicated': value is the rank's chunks, loc and
    attn every query; returns (the out summed over sp, a count of 0 with
    ctx.clamp_monitor, else None). At sp 1 the chunks are the whole levels:
    `ms_deform_attn_1d` (JAX :114-117)."""
    from gvl_tpu_torch import parallel as dp
    zero = (torch.zeros((), dtype=torch.long, device=value.device)
            if ctx.clamp_monitor else None)
    if ctx.sp == 1:
        return ms_deform_attn_1d(value, temporal_shapes, loc, attn), zero
    if queries == "tokens":
        left, right = exchange_halos(value, temporal_shapes, ctx)
        return tokens_local(ctx.sp_rank, ctx.sp, temporal_shapes,
                            ctx.halo_frac, value, left, right, loc, attn,
                            count=ctx.clamp_monitor, kernel=kernel)
    if queries == "replicated":
        part = replicated_local(ctx.sp_rank, ctx.sp, temporal_shapes, value,
                                loc, attn, kernel=kernel)
        return dp.sum_sp(part).to(value.dtype), zero
    raise ValueError(f"unknown queries mode {queries!r}")


def gather_tokens(x: torch.Tensor, temporal_shapes: Sequence[int], ctx
                  ) -> torch.Tensor:
    """Every sp rank's tokens (B, sum(chunks), ...) gathered over the sp
    group into the whole sequence (B, S, ...), level-major and unpadded;
    the gradient of each rank's tokens is summed over sp."""
    from gvl_tpu_torch import parallel as dp
    return gather_levels(dp.gather_sp(x), temporal_shapes, ctx.sp)
