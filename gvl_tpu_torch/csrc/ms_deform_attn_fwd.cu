// 1-D multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn.py::_fwd_kernel. That
// kernel builds a (S, 128) interpolation matrix in VMEM with iota-compares and
// contracts it with the (S, Dh) value slice on the MXU, because gathers were
// slow on the TPU. Here the taps are gathered directly.
//
// What it computes, for each (b, q, h) and channel c (exact f32, the same
// clamp/floor/lerp as _prep_taps in the JAX module):
//   x   = clamp(loc * T_l - 0.5, 0, T_l - 1)
//   i0  = floor(x), f = x - i0, i1 = min(i0 + 1, T_l - 1)
//   out = sum_{l,p} attn * ((1 - f) * V[start_l + i0] + f * V[start_l + i1])
//
// What bounds it: instructions per gathered row, not the bytes. At the
// flagship encoder shape (B=16, S=Lq=188, H=8, Dh=64, L=P=4) one call reads
// 6.2 MB of value and 3.1 MB of loc/attn and writes 6.2 MB, but it gathers
// 770 K rows of 256 B (197 MB) from L1/L2. The first form of this kernel
// (one lane per channel; every lane computed all 16 taps once per channel it
// held, with a 64-bit address and a 4-byte load per row; run-time L and P,
// so the tap loop was not unrolled) was bound by its instruction count, as
// the banded forward's first form was.
//
// Design: one warp per (b, q, h), no shared memory and no barrier. Lanes i
// and i + 16 load loc and attn of tap i (16 contiguous floats, one access)
// and prepare the tap once; the lower half keeps the lower row's offset and
// weight, the upper half the upper row's. Then, tap by tap, two shuffles
// hand a row and its weight to each half and half a warp reads the row in
// 16-byte loads (ms_deform_attn_common.cuh), so one instruction fetches both
// rows of a tap. With K = 16, the case of every model, the tap loop is
// unrolled at compile time so that the row loads are in flight before they
// are summed; other K run in chunks of 16 taps. The halves' sums meet in one
// shuffle, and the lower half stores the output row in 16-byte stores. The
// taps are summed in another order than the plain version's (lower rows and
// upper rows apart); the results agree to a few ulp. No atomics: each output
// element is written once.
//
// Layouts (all contiguous f32, value and out 16-byte aligned): value
// (B, S, H, Dh); loc, attn (B, Lq, H, L, P); out (B, Lq, H * Dh). Dh is a
// multiple of 4, at most 512.
//
// The from-taps form (msda_taps_fwd_f32) is the same kernel over taps the
// caller prepared: rows g0, g1 and weights w0, w1 read where kernel 1 reads
// loc and attn (GivenTaps, ms_deform_attn_common.cuh). It is the interface
// of the TPU kernel itself (_msda_core_pallas, ms_deform_attn.py:270-345),
// which the sequence-parallel op calls on taps moved into a shard's window
// (gvl_tpu_torch/ops/ms_deform_attn_sp.py). It moves 8 bytes more per tap
// than kernel 1 (four arrays, not two) and is bound as kernel 1 is.
//
// The bf16-tap form (msda_fwd_bf16taps) is the same kernel with loc and attn
// read as float or bf16 each and the tap prepared by the JAX rule for those
// types (tap_weights, ms_deform_attn_common.cuh): under eval_full_bf16 the
// decoder's attn is bf16 (its query is), loc f32 (the reference points are
// scaled by the f32 valid ratios). The value and the sum stay f32.

#include <climits>

#include "ms_deform_attn_common.cuh"

using namespace msda;

namespace {

constexpr int kFwdWarps = 8;   // (b, q, h) per block

// kK16: K = L * P = 16, known at compile time. Src: where the taps come
// from (LocAttnTaps, GivenTaps; ms_deform_attn_common.cuh).
template <int NV, bool kK16, typename Src>
__global__ void __launch_bounds__(kFwdWarps * 32)
msda_fwd_kernel(const float* __restrict__ value, Src src,
                float* __restrict__ out, int B, int S, int H, int Dh, int Lq,
                int L, int P, Levels lv) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kFwdWarps + threadIdx.x / 32;
  if (warp >= static_cast<long long>(B) * Lq * H) return;  // whole warps
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(warp % H);
  const int b = static_cast<int>(warp / (static_cast<long long>(Lq) * H));
  const int K = kK16 ? 16 : L * P;
  const RowLane me = row_lane();
  const int row = H * Dh;  // stride of a value row
  const float* v_bh =
      value + static_cast<long long>(b) * S * row + h * Dh + me.c0;

  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 16) {
    // lane i and lane i + 16 prepare tap k0 + i: the lower half its lower
    // row, the upper half its upper row, each as an offset and a weight
    const int k = k0 + lane % 16;
    int off = 0;
    float w = 0.f;
    if (kK16 || k < K) {
      const int l = k / P;
      const TapRows t =
          src.rows(warp * K + k, pick(lv.T, l), pick(lv.start, l));
      off = (me.half ? t.r1 : t.r0) * row;
      w = me.half ? t.w1 : t.w0;
    }
    const int n = kK16 ? 16 : min(16, K - k0);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (kK16 || i < n) {
        const int from = (lane & 16) | i;
        const int o = __shfl_sync(kFull, off, from);
        const float wi = __shfl_sync(kFull, w, from);
        float4 r[NV];
        load_row<NV>(r, v_bh + o, me.c0, Dh);
#pragma unroll
        for (int v = 0; v < NV; ++v) fma4(acc[v], wi, r[v]);
      }
    }
  }
  float* o = out + warp * Dh + me.c0;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    add_halves(acc[v]);
    if (me.half == 0 && me.c0 + 64 * v < Dh)
      *reinterpret_cast<float4*>(o + 64 * v) = acc[v];
  }
}

template <int NV, bool kK16, typename Src>
cudaError_t launch(const float* value, Src src, float* out, int B, int S,
                   int H, int Dh, int Lq, int L, int P, const Levels& lv,
                   cudaStream_t stream) {
  const long long warps = static_cast<long long>(B) * Lq * H;
  const long long blocks = (warps + kFwdWarps - 1) / kFwdWarps;
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  msda_fwd_kernel<NV, kK16, Src>
      <<<static_cast<int>(blocks), kFwdWarps * 32, 0, stream>>>(
          value, src, out, B, S, H, Dh, Lq, L, P, lv);
  return cudaGetLastError();
}

template <int NV, typename Src>
cudaError_t launch_nv(const float* value, Src src, float* out, int B, int S,
                      int H, int Dh, int Lq, int L, int P, const Levels& lv,
                      cudaStream_t st) {
  return L * P == 16
      ? launch<NV, true>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st)
      : launch<NV, false>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st);
}

// NV, the 16-byte pieces of a lane's row, from Dh.
template <typename Src>
cudaError_t dispatch(const float* value, Src src, float* out, int B, int S,
                     int H, int Dh, int Lq, int L, int P, const Levels& lv,
                     cudaStream_t st) {
  if (Dh <= 64)
    return launch_nv<1>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st);
  if (Dh <= 128)
    return launch_nv<2>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st);
  if (Dh <= 256)
    return launch_nv<4>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st);
  return launch_nv<8>(value, src, out, B, S, H, Dh, Lq, L, P, lv, st);
}

cudaError_t check_sizes(int S, int H, int Dh, int L, int P,
                        const int* level_T, Levels* lv) {
  if (P < 1 || Dh < 4 || Dh % 4 != 0 || Dh > 64 * kMaxVec ||
      static_cast<long long>(S) * H * Dh > INT_MAX)
    return cudaErrorInvalidValue;
  return make_levels(L, S, level_T, lv);
}

}  // namespace

// Plain C entries for ctypes. `level_T` is a host array of L level lengths.
// Each launches on `stream` and returns the CUDA error of the launch (0 =
// launched); refuses sizes the kernel does not take.
extern "C" int msda_fwd_f32(const float* value, const float* loc,
                            const float* attn, float* out, int B, int S,
                            int H, int Dh, int Lq, int L, int P,
                            const int* level_T, void* stream) {
  Levels lv;
  cudaError_t err = check_sizes(S, H, Dh, L, P, level_T, &lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch(value, LocAttnTaps<float, float>{loc, attn},
                                   out, B, S, H, Dh, Lq, L, P, lv,
                                   static_cast<cudaStream_t>(stream)));
}

// The bf16-tap form: loc is bf16 when loc_bf16, else f32; attn likewise.
extern "C" int msda_fwd_bf16taps(const float* value, const void* loc,
                                 const void* attn, float* out, int B, int S,
                                 int H, int Dh, int Lq, int L, int P,
                                 const int* level_T, int loc_bf16,
                                 int attn_bf16, void* stream) {
  Levels lv;
  cudaError_t err = check_sizes(S, H, Dh, L, P, level_T, &lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (loc_bf16 && attn_bf16)
    err = dispatch(value, LocAttnTaps<bf, bf>{static_cast<const bf*>(loc),
                                              static_cast<const bf*>(attn)},
                   out, B, S, H, Dh, Lq, L, P, lv, st);
  else if (loc_bf16)
    err = dispatch(value,
                   LocAttnTaps<bf, float>{static_cast<const bf*>(loc),
                                          static_cast<const float*>(attn)},
                   out, B, S, H, Dh, Lq, L, P, lv, st);
  else if (attn_bf16)
    err = dispatch(value,
                   LocAttnTaps<float, bf>{static_cast<const float*>(loc),
                                          static_cast<const bf*>(attn)},
                   out, B, S, H, Dh, Lq, L, P, lv, st);
  else
    err = cudaErrorInvalidValue;    // the f32 form is msda_fwd_f32
  return static_cast<int>(err);
}

// The from-taps form: the taps given as rows g0, g1 (int32, rows of a batch
// element's S; a row outside [0, S) stops the launch, GivenTaps) and their
// weights w0, w1 (f32), each (B, Lq, H, L, P);
// out[b, q, h] = sum_k w0 V[g0] + w1 V[g1].
extern "C" int msda_taps_fwd_f32(const float* value, const int* g0,
                                 const int* g1, const float* w0,
                                 const float* w1, float* out, int B, int S,
                                 int H, int Dh, int Lq, int L, int P,
                                 void* stream) {
  if (L < 1 || P < 1 || Dh < 4 || Dh % 4 != 0 || Dh > 64 * kMaxVec ||
      static_cast<long long>(S) * H * Dh > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv{};      // the given rows carry their levels
  return static_cast<int>(dispatch(value, GivenTaps{g0, g1, w0, w1, S}, out,
                                   B, S, H, Dh, Lq, L, P, lv,
                                   static_cast<cudaStream_t>(stream)));
}
