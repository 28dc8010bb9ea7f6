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
`bwd_plan` is the host side of a backward launch (its blocks and shared
memory), computed from sizes alone so that it is tested without a card.
`ms_deform_attn_1d_embedding_bag` computes the forward by one library
call, the yardstick the kernels are timed against.

`ms_deform_attn_from_taps` is the op on taps the caller prepared (rows and
lerp-folded weights), the TPU kernels' own interface
(`_msda_pallas_from_taps`), which the sequence-parallel op
(ops/ms_deform_attn_sp.py) calls on taps moved into a shard's window: the
from-taps forms of kernels 1 and 2 on a CUDA tensor, `weighted_tap_sum` and
`taps_grads` their plain versions.

Gradient of loc at the clamp: zero where the clamp is active and on its two
bounds (x = 0 and x = T_l - 1 exactly), in the kernel, in its plain version
and under autograd of `ms_deform_attn_1d_ref` alike.

bf16 taps. loc and attn may each be float32 or bfloat16 (eval_full_bf16
gives the decoder a bf16 attn beside an f32 loc; train_caption_bf16 the
transformer caption head's cross-attention). The taps then follow the JAX
rule, which the jitted JAX step keeps (tests/test_torch_decode_options.py):
the position, clamp and lerp fraction in loc's type, every operation rounded
to it; the weights in the promoted type of attn and loc; then the weights
widened to f32 for the sum, value upcast to f32 (ms_deform_attn.py:56-81,
349-364). `prep_taps` computes that by torch's promotion, which is JAX's for
these tensors; on the card bf16 taps go to the kernel's bf16-tap form
(`msda_fwd_bf16taps`, counted by `ms_deform_attn_1d.bf16_launches`), never
to an f32 form. The bf16-tap form is a forward: its backward runs kernel 2
on attn widened, which is exact when loc is f32, and refuses a bf16 loc.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

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


def embedding_bag_inputs(value: torch.Tensor, g0: torch.Tensor,
                         g1: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """The arguments of one `F.embedding_bag(idx, table, mode="sum",
    per_sample_weights=w)` that computes `weighted_tap_sum`: value's rows as
    the table (B*S*H, Dh), a view; one bag per (b, q, h) of its 2K rows
    (b*S + g)*H + h, the lower rows first; the lerp-folded weights."""
    B, S, H, Dh = value.shape
    Lq = g0.shape[1]
    dev = value.device
    first = (torch.arange(B, device=dev) * S)[:, None, None, None, None]
    head = torch.arange(H, device=dev)[None, None, :, None, None]

    def bags(x):
        return x.reshape(B * Lq * H, -1)

    idx = torch.cat([bags((first + g) * H + head) for g in (g0, g1)], dim=1)
    w = torch.cat([bags(w0), bags(w1)], dim=1).to(value.dtype)
    return value.reshape(B * S * H, Dh), idx, w


def ms_deform_attn_1d_embedding_bag(value: torch.Tensor,
                                    temporal_shapes: Sequence[int],
                                    loc: torch.Tensor,
                                    attn: torch.Tensor) -> torch.Tensor:
    """The dense op as one library call: `prep_taps`, then `F.embedding_bag`
    over the taps' rows of value, no copy of value. Its autograd backward
    gives grad_value and the per-tap dot products (the gradient of the
    weights). The yardstick `chip_smoke.py` times beside the kernels; no
    main path calls it."""
    table, idx, w = embedding_bag_inputs(
        value, *prep_taps(temporal_shapes, loc, attn))
    out = torch.nn.functional.embedding_bag(idx, table, mode="sum",
                                            per_sample_weights=w)
    B, Lq, H = loc.shape[:3]
    return out.reshape(B, Lq, H * value.shape[3])


def ms_deform_attn_1d_sampled_values(value: torch.Tensor,
                                     temporal_shapes: Sequence[int],
                                     loc: torch.Tensor) -> torch.Tensor:
    """Raw per-tap lerped values, not weighted or summed: (B, Lq, H, L*P, Dh).
    The LSTM-DSA captioner's sampling op, as the plain gather of
    `ms_deform_attn_1d_sampled_values` (ms_deform_attn.py:117-207): the
    lerp in f32 and the result in value's dtype, as its 'twohot' matmul
    computes it."""
    g0, g1, w0, w1 = prep_taps(temporal_shapes, loc, torch.ones_like(loc))
    B, Lq, H, L, P = loc.shape
    v32 = value.float()

    def flat(w):
        return w.float().permute(0, 2, 1, 3, 4).reshape(B, H, Lq, L * P, 1)

    out = _gather_taps(v32, g0) * flat(w0) + _gather_taps(v32, g1) * flat(w1)
    return out.permute(0, 2, 1, 3, 4).to(value.dtype)


def taps_grads(grad_out: torch.Tensor, value: torch.Tensor, g0: torch.Tensor,
               g1: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """(grad_value, grad_w0, grad_w1) of `weighted_tap_sum` over given taps
    (rows g0, g1, int64, and weights w0, w1), by the backward kernels'
    formulas: `index_add_` of w * dOut for value, the per-tap dot products
    <V[g0], dOut> and <V[g1], dOut> for the weights. The plain version of
    the from-taps backward (the semantics of _bwd_kernel_full,
    ms_deform_attn.py:236-268)."""
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g0.shape
    go = grad_out.reshape(B, Lq, H, Dh).permute(0, 2, 1, 3)        # (B,H,Lq,Dh)
    go = go[:, :, :, None, :]

    def dots(g):                          # <V[g], dOut> -> (B, Lq, H, L, P)
        d = (_gather_taps(value, g) * go).sum(-1)                  # (B,H,Lq,K)
        return d.permute(0, 2, 1, 3).reshape(B, Lq, H, L, P)

    grad_value = value.new_zeros((B * H * S, Dh))
    bh = torch.arange(B * H, device=value.device)[:, None] * S
    for g, w in ((g0, w0), (g1, w1)):
        idx = g.permute(0, 2, 1, 3, 4).reshape(B * H, -1) + bh
        w = w.permute(0, 2, 1, 3, 4).reshape(B, H, Lq, L * P, 1)
        grad_value.index_add_(0, idx.reshape(-1), (w * go).reshape(-1, Dh))
    grad_value = grad_value.reshape(B, H, S, Dh).permute(0, 2, 1, 3)
    return grad_value.contiguous(), dots(g0), dots(g1)


def tap_grads(grad_out: torch.Tensor, value: torch.Tensor, g0: torch.Tensor,
              g1: torch.Tensor, f: torch.Tensor, x_raw: torch.Tensor,
              t: torch.Tensor, attn: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(grad_value, grad_loc, grad_attn) of `weighted_tap_sum` over taps read
    at rows g0, g1 with lerp fraction f, by the backward kernels' formulas:
    per-tap dot products for loc and attn, `index_add_` for value."""
    grad_value, d0, d1 = taps_grads(grad_out, value, g0, g1,
                                    attn * (1.0 - f), attn * f)
    grad_attn = (1.0 - f) * d0 + f * d1
    grad_loc = torch.where(_inside_clamp(x_raw, t),
                           attn * t * (d1 - d0), torch.zeros_like(d0))
    return grad_value, grad_loc, grad_attn


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


# limits of the CUDA kernels (csrc/ms_deform_attn_common.cuh)
KERNEL_THREADS = 512          # a block of the banded and value kernels
KERNEL_WARPS = KERNEL_THREADS // 32
KERNEL_MAX_DH = 512           # eight 16-byte accesses per lane and row
BANDED_MAX_DH = 128           # the banded kernels': two
KERNEL_MAX_TAPS = KERNEL_THREADS   # taps per query: one thread per tap at least
MAX_SHARED_BYTES = 232448     # the most shared memory a block may take, sm_90
# The backward's value kernel (csrc/ms_deform_attn_bwd.cu) gives a block
# a (b, h) and a range of at most BWD_RANGE_ROWS value rows; it sorts the
# taps of a chunk of queries at a time, in shared memory of 32 bytes per tap
# and 4 per float of dOut, at most BWD_CHUNK_BYTES, and KERNEL_WARPS + 1
# counters per row. Its dot kernel takes BWD_DOT_WARPS (b, q, h) a block.
BWD_RANGE_ROWS = 256
BWD_CHUNK_BYTES = 160 * 1024
BWD_DOT_WARPS = 8


def check_aligned(**tensors) -> None:
    """Raises unless each tensor given (None skips) starts on 16 bytes: the
    kernels read its rows in 16-byte pieces. Reads the data pointer only."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"ms_deform_attn kernel: {name} is not 16-byte "
                             "aligned; its rows are read in 16-byte pieces")


def bf16_taps(loc: torch.Tensor, attn: torch.Tensor) -> bool:
    """Whether loc or attn is bfloat16: the taps of the bf16-tap form."""
    return torch.bfloat16 in (loc.dtype, attn.dtype)


def check_bf16_levels(temporal_shapes: Sequence[int]) -> None:
    """Raises unless every level length T and T - 1 is a bfloat16 value: with
    a bf16 loc the JAX rule computes the clamp in bf16, where a longer level
    would round (T <= 257 always passes)."""
    for t in temporal_shapes:
        t = int(t)
        for v in (t, t - 1):
            if float(torch.tensor(float(v), dtype=torch.bfloat16)) != v:
                raise ValueError(
                    f"ms_deform_attn kernel: level length {t} with a bf16 loc;"
                    f" {v} is not a bfloat16 value, so the clamp would round")


def check_kernel_inputs(value, temporal_shapes, loc, attn, grad_out=None,
                        bf16_taps_ok: bool = False):
    """Raises on what the CUDA kernels do not take: shapes that do not match,
    sizes past the kernels' limits, rows that do not start on 16 bytes, and
    tensors that are not contiguous float32 on one CUDA device; with
    bf16_taps_ok (the forwards' bf16-tap form) loc and attn may also be
    bfloat16, and a bf16 loc needs levels `check_bf16_levels` passes."""
    if value.dim() != 4 or loc.dim() != 5 or attn.shape != loc.shape:
        raise ValueError("ms_deform_attn kernel: want value (B,S,H,Dh) and "
                         f"loc, attn (B,Lq,H,L,P); got {tuple(value.shape)}, "
                         f"{tuple(loc.shape)}, {tuple(attn.shape)}")
    B, S, H, Dh = value.shape
    if loc.shape[0] != B or loc.shape[2] != H:
        raise ValueError(f"ms_deform_attn kernel: loc {tuple(loc.shape)} does "
                         f"not match value {tuple(value.shape)}")
    L, P = loc.shape[3], loc.shape[4]
    if L != len(temporal_shapes) or not 1 <= L <= 8:
        raise ValueError(f"ms_deform_attn kernel: {L} levels in loc, "
                         f"{len(temporal_shapes)} temporal shapes (1..8 taken)")
    if sum(int(t) for t in temporal_shapes) != S:
        raise ValueError(f"ms_deform_attn kernel: shapes {temporal_shapes} do "
                         f"not sum to S={S}")
    if Dh < 4 or Dh % 4 or Dh > KERNEL_MAX_DH:
        raise ValueError(
            f"ms_deform_attn kernel: head width {Dh}; the kernels read rows "
            f"in 16-byte pieces and take multiples of 4 up to {KERNEL_MAX_DH}")
    if L * P > KERNEL_MAX_TAPS:
        raise ValueError(
            f"ms_deform_attn kernel: {L} levels x {P} points; at most "
            f"{KERNEL_MAX_TAPS} taps per query, one per thread of a block")
    if max(S, loc.shape[1]) * H * Dh > 2 ** 31 - 1:
        raise ValueError(
            f"ms_deform_attn kernel: a batch element of {max(S, loc.shape[1])}"
            f" x {H} x {Dh} floats is past the 32-bit row offsets")
    if grad_out is not None and grad_out.shape != (
            B, loc.shape[1], H * value.shape[3]):
        raise ValueError(f"ms_deform_attn kernel: grad_out "
                         f"{tuple(grad_out.shape)} is not (B, Lq, H*Dh)")
    check_aligned(value=value, grad_out=grad_out)
    tensors = [("value", value), ("loc", loc), ("attn", attn)]
    if grad_out is not None:
        tensors.append(("grad_out", grad_out))
    if bf16_taps_ok and loc.dtype == torch.bfloat16:
        check_bf16_levels(temporal_shapes)
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"ms_deform_attn kernel: {name} is on {t.device}")
        if bf16_taps_ok and name in ("loc", "attn") and \
                t.dtype == torch.bfloat16:
            pass
        elif t.dtype != torch.float32:
            raise TypeError(f"ms_deform_attn kernel: {name} is {t.dtype}, "
                            "the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn kernel: {name} is not contiguous")
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("ms_deform_attn kernel: inputs on different devices")


class BwdPlan(NamedTuple):
    """The host side of a launch of the backward kernels."""
    chunk: int               # queries a value block sorts at once
    rows: int                # value rows of a value block
    value_blocks: int        # with grad_value
    dot_blocks: int
    shared: int              # dynamic shared memory of a value block, bytes


@functools.lru_cache(maxsize=64)
def bwd_plan(B: int, S: int, H: int, Dh: int, Lq: int, K: int) -> BwdPlan:
    """The blocks of the backward kernels: one dot block per BWD_DOT_WARPS
    (b, q, h), and with grad_value one value block per (b, h) and range of
    rows, which walks all Lq queries a chunk at a time and stores its rows
    of grad_value whole. Kept per set of sizes: the model asks for the same
    plan at every layer and step. Raises ValueError on sizes the kernels do
    not take."""
    n_rr = -(-S // BWD_RANGE_ROWS)
    rows = -(-S // n_rr)
    chunk = min(max(1, Lq), max(1, BWD_CHUNK_BYTES // (32 * K + 4 * Dh)))
    plan = BwdPlan(chunk=chunk, rows=rows, value_blocks=B * H * n_rr,
                   dot_blocks=-(-B * Lq * H // BWD_DOT_WARPS),
                   shared=(32 * K + 4 * Dh) * chunk
                   + 4 * (KERNEL_WARPS + 1) * rows)
    if max(plan.value_blocks, plan.dot_blocks) > 2 ** 31 - 1:
        raise ValueError(f"ms_deform_attn backward kernel: "
                         f"{max(plan.value_blocks, plan.dot_blocks)} blocks, "
                         "past the grid's 2^31 - 1")
    return plan


def _level_array(temporal_shapes: Sequence[int]) -> ctypes.Array:
    return (ctypes.c_int * len(temporal_shapes))(
        *(int(t) for t in temporal_shapes))


def ms_deform_attn_1d_cuda(value: torch.Tensor, temporal_shapes: Sequence[int],
                           loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: the f32 form, or the
    bf16-tap form when loc or attn is bfloat16. value float32, contiguous
    CUDA tensors only; raises on anything else, and if the launch is
    refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn, bf16_taps_ok=True)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = loc.shape
    out = torch.empty((B, Lq, H * Dh), dtype=torch.float32, device=value.device)
    half = bf16_taps(loc, attn)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (value.data_ptr(), loc.data_ptr(), attn.data_ptr(),
                out.data_ptr(), B, S, H, Dh, Lq, L, P,
                _level_array(temporal_shapes))
        if half:
            err = library().msda_fwd_bf16taps(
                *args, int(loc.dtype == torch.bfloat16),
                int(attn.dtype == torch.bfloat16), stream)
        else:
            err = library().msda_fwd_f32(*args, stream)
    if err != 0:
        raise RuntimeError(f"ms_deform_attn kernel launch failed: CUDA error {err}")
    if half:
        ms_deform_attn_1d.bf16_launches += 1
    else:
        ms_deform_attn_1d.launches += 1
    return out


def ms_deform_attn_1d_bwd_cuda(grad_out: torch.Tensor, value: torch.Tensor,
                               temporal_shapes: Sequence[int],
                               loc: torch.Tensor, attn: torch.Tensor,
                               need_value: bool = True
                               ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward CUDA kernels on the current stream and return
    (grad_value, grad_loc, grad_attn); grad_value is None, and nothing is
    scattered, with need_value=False. float32 contiguous CUDA tensors only;
    raises on anything else, and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_kernel_inputs(value, temporal_shapes, loc, attn, grad_out)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = loc.shape
    plan = bwd_plan(B, S, H, Dh, Lq, L * P)
    # the value kernel stores every row of grad_value
    grad_value = torch.empty_like(value) if need_value else None
    grad_loc = torch.empty_like(loc)
    grad_attn = torch.empty_like(attn)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().msda_bwd_f32(
            grad_out.data_ptr(), value.data_ptr(), loc.data_ptr(),
            attn.data_ptr(), grad_value.data_ptr() if need_value else None,
            grad_loc.data_ptr(), grad_attn.data_ptr(),
            B, S, H, Dh, Lq, L, P, _level_array(temporal_shapes), plan.chunk,
            plan.rows, plan.shared if need_value else 0, stream)
    if err != 0:
        raise RuntimeError("ms_deform_attn backward kernel launch failed: "
                           f"CUDA error {err}")
    ms_deform_attn_1d.bwd_launches += 1
    return grad_value, grad_loc, grad_attn


def bf16_attn_backward(loc: torch.Tensor, attn: torch.Tensor,
                       what: str) -> torch.Tensor:
    """The f32 attn the backward kernels take in place of a bf16 one: exact
    when loc is f32, since the JAX rule then prepares the taps in f32 over
    attn widened; a bf16 loc is refused (the bf16-tap form is a forward)."""
    if loc.dtype != torch.float32:
        raise NotImplementedError(
            f"{what} backward: a bf16 loc has no backward kernel (the bf16-"
            "tap form is a forward)")
    return attn.float()


class _MSDeformAttnCUDA(torch.autograd.Function):
    """Forward and backward are the two CUDA kernels; neither gives way to
    the plain version. A bf16 attn goes back through kernel 2 widened, its
    gradient rounded back to bf16."""

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
        attn32 = attn if attn.dtype == torch.float32 else \
            bf16_attn_backward(loc, attn, "ms_deform_attn")
        # autograd hands over views (of an expand, a transpose) as often as not
        grad_value, grad_loc, grad_attn = ms_deform_attn_1d_bwd_cuda(
            grad_out.contiguous(), value, ctx.temporal_shapes, loc, attn32,
            need_value=need_value)
        return (grad_value, None, grad_loc if need_loc else None,
                grad_attn.to(attn.dtype) if need_attn else None)


# ------------------------------------------------------------ from-taps forms

def check_taps_inputs(value, g0, g1, w0, w1, grad_out=None) -> None:
    """Raises on what the from-taps kernels do not take: taps of differing
    shapes or not (B, Lq, H, L, P) over value (B, S, H, Dh), rows that are
    not int32 or weights that are not float32, the head widths and tap
    counts the dense kernels refuse, tensors that are not contiguous on one
    CUDA device, rows that do not start on 16 bytes. A row outside [0, S)
    is the kernels' to catch: it stops the launch on the device (no host
    synchronisation here), and the next synchronisation raises."""
    if value.dim() != 4 or g0.dim() != 5 or not (
            g0.shape == g1.shape == w0.shape == w1.shape):
        raise ValueError("ms_deform_attn from-taps kernel: want value "
                         "(B,S,H,Dh) and g0, g1, w0, w1 (B,Lq,H,L,P); got "
                         f"{tuple(value.shape)}, {tuple(g0.shape)}, "
                         f"{tuple(g1.shape)}, {tuple(w0.shape)}, "
                         f"{tuple(w1.shape)}")
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g0.shape
    if g0.shape[0] != B or g0.shape[2] != H:
        raise ValueError(f"ms_deform_attn from-taps kernel: taps "
                         f"{tuple(g0.shape)} do not match value "
                         f"{tuple(value.shape)}")
    if Dh < 4 or Dh % 4 or Dh > KERNEL_MAX_DH:
        raise ValueError(
            f"ms_deform_attn from-taps kernel: head width {Dh}; the kernels "
            f"read rows in 16-byte pieces and take multiples of 4 up to "
            f"{KERNEL_MAX_DH}")
    if L * P > KERNEL_MAX_TAPS:
        raise ValueError(f"ms_deform_attn from-taps kernel: {L} x {P} taps "
                         f"per query; at most {KERNEL_MAX_TAPS}")
    if max(S, Lq) * H * Dh > 2 ** 31 - 1:
        raise ValueError(
            f"ms_deform_attn from-taps kernel: a batch element of "
            f"{max(S, Lq)} x {H} x {Dh} floats is past the 32-bit row offsets")
    if grad_out is not None and grad_out.shape != (B, Lq, H * Dh):
        raise ValueError(f"ms_deform_attn from-taps kernel: grad_out "
                         f"{tuple(grad_out.shape)} is not (B, Lq, H*Dh)")
    check_aligned(value=value, grad_out=grad_out)
    tensors = [("value", value, torch.float32), ("g0", g0, torch.int32),
               ("g1", g1, torch.int32), ("w0", w0, torch.float32),
               ("w1", w1, torch.float32)]
    if grad_out is not None:
        tensors.append(("grad_out", grad_out, torch.float32))
    for name, t, dtype in tensors:
        if not t.is_cuda:
            raise ValueError(f"ms_deform_attn from-taps kernel: {name} is on "
                             f"{t.device}")
        if t.dtype != dtype:
            raise TypeError(f"ms_deform_attn from-taps kernel: {name} is "
                            f"{t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ms_deform_attn from-taps kernel: {name} is not "
                             "contiguous")
    if len({t.device for _, t, _ in tensors}) != 1:
        raise ValueError("ms_deform_attn from-taps kernel: inputs on "
                         "different devices")


def ms_deform_attn_taps_cuda(value: torch.Tensor, g0: torch.Tensor,
                             g1: torch.Tensor, w0: torch.Tensor,
                             w1: torch.Tensor) -> torch.Tensor:
    """Launch the from-taps form of the forward kernel on the current
    stream: (B, Lq, H*Dh) float32. Raises on inputs it does not take
    (`check_taps_inputs`) and if the launch is refused."""
    from gvl_tpu_torch.ops._build import library

    check_taps_inputs(value, g0, g1, w0, w1)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g0.shape
    out = torch.empty((B, Lq, H * Dh), dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        err = library().msda_taps_fwd_f32(
            value.data_ptr(), g0.data_ptr(), g1.data_ptr(), w0.data_ptr(),
            w1.data_ptr(), out.data_ptr(), B, S, H, Dh, Lq, L, P,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("ms_deform_attn from-taps kernel launch failed: "
                           f"CUDA error {err}")
    ms_deform_attn_1d.taps_launches += 1
    return out


def ms_deform_attn_taps_bwd_cuda(grad_out: torch.Tensor, value: torch.Tensor,
                                 g0: torch.Tensor, g1: torch.Tensor,
                                 w0: torch.Tensor, w1: torch.Tensor,
                                 need_value: bool = True
                                 ) -> Tuple[torch.Tensor, ...]:
    """Launch the from-taps form of the backward kernels on the current
    stream: (grad_value, grad_w0, grad_w1), grad_value None with
    need_value=False. Raises on inputs it does not take and if the launch
    is refused."""
    from gvl_tpu_torch.ops._build import library

    check_taps_inputs(value, g0, g1, w0, w1, grad_out)
    B, S, H, Dh = value.shape
    _, Lq, _, L, P = g0.shape
    plan = bwd_plan(B, S, H, Dh, Lq, L * P)
    grad_value = torch.empty_like(value) if need_value else None
    dw0, dw1 = torch.empty_like(w0), torch.empty_like(w1)
    with torch.cuda.device(value.device):
        err = library().msda_taps_bwd_f32(
            grad_out.data_ptr(), value.data_ptr(), g0.data_ptr(),
            g1.data_ptr(), w0.data_ptr(), w1.data_ptr(),
            grad_value.data_ptr() if need_value else None, dw0.data_ptr(),
            dw1.data_ptr(), B, S, H, Dh, Lq, L, P, plan.chunk, plan.rows,
            plan.shared if need_value else 0,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("ms_deform_attn from-taps backward kernel launch "
                           f"failed: CUDA error {err}")
    ms_deform_attn_1d.taps_bwd_launches += 1
    return grad_value, dw0, dw1


class _MSDeformAttnTapsCUDA(torch.autograd.Function):
    """The from-taps forms of kernels 1 and 2, forward and backward; the
    rows carry no gradient."""

    @staticmethod
    def forward(ctx, value, g0, g1, w0, w1):
        ctx.save_for_backward(value, g0, g1, w0, w1)
        return ms_deform_attn_taps_cuda(value, g0, g1, w0, w1)

    @staticmethod
    def backward(ctx, grad_out):
        value, g0, g1, w0, w1 = ctx.saved_tensors
        need_value = ctx.needs_input_grad[0]
        grad_value, dw0, dw1 = ms_deform_attn_taps_bwd_cuda(
            grad_out.contiguous().float(), value, g0, g1, w0, w1,
            need_value=need_value)
        return grad_value, None, None, dw0, dw1


def ms_deform_attn_from_taps(value: torch.Tensor, g0: torch.Tensor,
                             g1: torch.Tensor, w0: torch.Tensor,
                             w1: torch.Tensor) -> torch.Tensor:
    """sum_k w0 * value[g0] + w1 * value[g1] over given taps: value
    (B, S, H, Dh), rows g0, g1 and weights w0, w1 (B, Lq, H, L, P); returns
    (B, Lq, H*Dh) float32. Port of `_msda_pallas_from_taps`
    (ms_deform_attn.py:330-345): value and the weights in float32. On a
    CUDA tensor the from-taps forms of kernels 1 and 2
    (`ms_deform_attn_1d.taps_launches`, `.taps_bwd_launches`); on a CPU
    tensor the plain version, `weighted_tap_sum` under autograd."""
    value, w0, w1 = value.float(), w0.float(), w1.float()
    if value.is_cuda:
        return _MSDeformAttnTapsCUDA.apply(
            value.contiguous(), g0.int().contiguous(), g1.int().contiguous(),
            w0.contiguous(), w1.contiguous())
    return weighted_tap_sum(value, g0.long(), g1.long(), w0, w1)


def ms_deform_attn_1d(value: torch.Tensor, temporal_shapes: Sequence[int],
                      loc: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """Deformable attention: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. As in the JAX op, value is computed in float32
    and the result cast back to value's dtype. `ms_deform_attn_1d.launches`
    counts launches of the forward kernel's f32 form, `.bf16_launches` of its
    bf16-tap form (bf16 loc or attn; see the module docstring),
    `.bwd_launches` of the backward kernel (`.taps_launches` and
    `.taps_bwd_launches` count their from-taps forms,
    `ms_deform_attn_from_taps`)."""
    shapes = tuple(int(t) for t in temporal_shapes)
    v32 = value.float()
    if value.is_cuda:
        out = _MSDeformAttnCUDA.apply(v32, shapes, loc, attn)
    else:
        out = ms_deform_attn_1d_ref(v32, shapes, loc, attn)
    return out.to(value.dtype)


ms_deform_attn_1d.launches = 0
ms_deform_attn_1d.bf16_launches = 0
ms_deform_attn_1d.bwd_launches = 0
ms_deform_attn_1d.taps_launches = 0
ms_deform_attn_1d.taps_bwd_launches = 0
