// Banded 1-D multi-scale deformable attention for token queries, backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn_banded.py::_bwd_kernel.
// That kernel rebuilds the banded interpolation matrix per tile, adds
// dV_band = W . dOut into the value gradient by a read-modify-write over the
// sequential tile grid, and returns the per-tap dw0/dw1 so that autodiff
// carries them through the tap preparation. Here the taps are gathered
// directly, as in the forward, and the tap preparation's derivative is
// folded in: the kernel returns the gradients of value, loc and attn.
//
// What it computes, for each (b, h), each tile of kTileQ consecutive
// queries of one level and each target level l (exact f32; x, i0, i1, f, the
// band start s and the clamped rows r0, r1 as in
// ms_deform_attn_banded_fwd.cu):
//   d0  = <V_l[r0], dOut>, d1 = <V_l[r1], dOut>                  (over Dh)
//   grad_attn = (1 - f) * d0 + f * d1
//   grad_loc  = attn * T_l * (d1 - d0)  where 0 < loc * T_l - 0.5 < T_l - 1,
//               0 where the tap clamp is active (and on its bounds)
//   grad_value_l[r0] += attn * (1 - f) * dOut
//   grad_value_l[r1] += attn * f * dOut
//
// What bounds it: memory and latency, not FLOPs. At the long-video encoder
// shape of the train step (B=4, S=1500, H=8, Dh=64, L=P=4) one call reads
// value and dOut (12.3 MB each) and loc/attn (6.1 MB) and writes grad_value
// (12.3 MB) and grad_loc/grad_attn (6.1 MB), for ~400 MFLOP.
//
// Design: one block per (b, h, tile), all query levels in one launch, as
// the forward. Phase A: the tile's taps (i0, f, attn, and attn * T_l where
// the tap clamp passes a gradient) go to shared memory once, with the
// smallest i0 per target level. Phase B: one warp per query, lanes over the
// Dh channels; a warp-shuffle reduction gives d0/d1 per tap and lane 0
// writes grad_loc/grad_attn, each exactly once. grad_value is a scatter
// with data-dependent rows, and the bands of neighbouring tiles overlap:
// f32 atomicAdd into a buffer the wrapper zeroes on the same stream. The
// order in which the atomics of different warps land is not fixed, so
// grad_value's sums vary in the last bits from run to run. `grad_value` may
// be null: then nothing is scattered.
//
// Layouts (all contiguous f32): value, grad_value (B, S, H, Dh); loc, attn,
// grad_loc, grad_attn (B, S, H, L, P); grad_out (B, S, H * Dh).

#include "ms_deform_attn_banded.cuh"

using namespace msda_banded;

namespace {

__global__ void __launch_bounds__(kThreads)
msda_banded_bwd_kernel(const float* __restrict__ grad_out,
                       const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ grad_value,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_attn, int S, int H, int Dh,
                       int L, int P, Geometry gm) {
  extern __shared__ unsigned char smem[];
  __shared__ int s_band[kMaxLevels];  // smallest i0, then the band start
  const int K = L * P;
  int* s_i0 = reinterpret_cast<int*>(smem);
  float* s_f = reinterpret_cast<float*>(smem) + kTileQ * K;
  float* s_a = s_f + kTileQ * K;
  float* s_aT = s_a + kTileQ * K;     // attn * T_l inside the tap clamp, else 0

  const Tile t = tile_of_block(gm, L, H);
  const int b = t.b, h = t.h, lq = t.lq, q_first = t.q_first, nq = t.nq;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x < L) s_band[threadIdx.x] = INT_MAX;
  __syncthreads();

  // phase A: taps of the tile, and the smallest i0 per target level
  const int n_taps = nq * K;
  for (int base = 0; base < n_taps; base += kThreads) {
    const int idx = base + threadIdx.x;
    const bool live = idx < n_taps;
    int l = -1, i0 = INT_MAX;
    if (live) {
      const int q = idx / K;
      const int k = idx % K;
      l = k / P;
      const long long g =
          ((static_cast<long long>(b) * S + q_first + q) * H + h) * K + k;
      const float Tf = static_cast<float>(gm.T[l]);
      const Tap tap = tap_at(loc[g], Tf);
      const float a = attn[g];
      i0 = tap.i0;
      s_i0[idx] = i0;
      s_f[idx] = tap.f;
      s_a[idx] = a;
      s_aT[idx] = (tap.x_raw > 0.f && tap.x_raw < Tf - 1.f) ? a * Tf : 0.f;
    }
    lower_band_min(s_band, live, l, i0);
  }
  __syncthreads();
  band_starts(s_band, gm, lq, L);
  __syncthreads();

  // phase B: one warp per query, lanes over the channels
  const long long row = static_cast<long long>(H) * Dh;  // stride of one s
  const long long v_off = static_cast<long long>(b) * S * row +
                          static_cast<long long>(h) * Dh;
  for (int q = threadIdx.x / 32; q < nq; q += kThreads / 32) {
    const long long qg = (static_cast<long long>(b) * S + q_first + q) * H + h;
    const float* go = grad_out + qg * Dh;
    for (int l = 0; l < L; ++l) {
      const int T = gm.T[l];
      const int s = s_band[l];
      const int hi = s + gm.band[lq][l] - 1;
      const float* v_l = value + v_off + gm.start[l] * row;
      float* gv_l = grad_value ? grad_value + v_off + gm.start[l] * row
                               : nullptr;
      for (int p = 0; p < P; ++p) {
        const int k = q * K + l * P + p;
        const int i0 = s_i0[k];
        const float f = s_f[k];
        const float a = s_a[k];
        const int r0 = min(max(i0, s), hi);
        const int r1 = min(max(min(i0 + 1, T - 1), s), hi);
        const float w0 = a * (1.f - f);
        const float w1 = a * f;
        float d0 = 0.f, d1 = 0.f;
        for (int c = lane; c < Dh; c += 32) {
          const float g = go[c];
          d0 += v_l[r0 * row + c] * g;
          d1 += v_l[r1 * row + c] * g;
          if (gv_l) {
            atomicAdd(gv_l + r0 * row + c, w0 * g);
            atomicAdd(gv_l + r1 * row + c, w1 * g);
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          d0 += __shfl_xor_sync(0xffffffffu, d0, off);
          d1 += __shfl_xor_sync(0xffffffffu, d1, off);
        }
        if (lane == 0) {
          const long long g = qg * K + l * P + p;
          grad_attn[g] = (1.f - f) * d0 + f * d1;
          grad_loc[g] = s_aT[k] * (d1 - d0);
        }
      }
    }
  }
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths,
// `band` a host array of L * L band sizes, row = query level. One query per
// value row (Lq == S). `grad_value` must be zeroed on `stream` before the
// call, or be null when the gradient of value is not wanted. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int msda_banded_bwd_f32(const float* grad_out, const float* value,
                                   const float* loc, const float* attn,
                                   float* grad_value, float* grad_loc,
                                   float* grad_attn, int B, int S, int H,
                                   int Dh, int L, int P, const int* level_T,
                                   const int* band, void* stream) {
  Geometry gm;
  int blocks = 0;
  const long long shared = 4LL * kTileQ * L * P * sizeof(float);
  cudaError_t err = make_geometry(S, L, P, level_T, band, &gm);
  if (err == cudaSuccess) err = plan_launch(gm, B, H, L, shared, &blocks);
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  msda_banded_bwd_kernel<<<blocks, kThreads,
                           static_cast<size_t>(shared),
                           static_cast<cudaStream_t>(stream)>>>(
      grad_out, value, loc, attn, grad_value, grad_loc, grad_attn, S, H, Dh, L,
      P, gm);
  return static_cast<int>(cudaGetLastError());
}
