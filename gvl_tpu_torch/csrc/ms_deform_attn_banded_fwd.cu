// Banded 1-D multi-scale deformable attention for token queries, forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn_banded.py::_fwd_kernel.
// That kernel exists because the dense TPU kernel builds an (S, 128)
// interpolation matrix per tile of 128 queries; for token queries (one query
// per value row, S >= 512) it builds the matrix only over a band of BS_l rows
// of each level, starting at the tile's smallest tap row, and contracts it
// with that window of the value on the MXU. Taps outside the band are clamped
// to its edge. Here the taps are gathered directly, so the band saves no
// work; what is carried over is the function, clamp included.
//
// What it computes, for each (b, h), each tile of kTileQ consecutive
// queries of one level (the last tile of a level is short) and each target
// level l (exact f32, the tap as in ms_deform_attn_fwd.cu):
//   x   = clamp(loc * T_l - 0.5, 0, T_l - 1)
//   i0  = floor(x), f = x - i0, i1 = min(i0 + 1, T_l - 1)
//   s   = the tile's band start into l (ms_deform_attn_banded.cuh)
//   r0  = clamp(i0, s, s + BS - 1), r1 = clamp(i1, s, s + BS - 1)
//   out = sum_{l,p} attn * ((1 - f) * V_l[r0] + f * V_l[r1])
// with BS = band[query level][l], given by the caller.
//
// What bounds it: memory and latency, not FLOPs. At the long-video encoder
// shape (B=8, S=1500, H=8, Dh=64, L=P=4) one call reads 24.6 MB of value
// and 12.3 MB of loc/attn, writes 24.6 MB, and does ~400 MFLOP.
//
// Design: one block per (b, h, tile), all query levels in one launch. Phase
// A: the block's threads compute the tile's taps once (i0 and the two
// lerp-folded weights) into shared memory and reduce the smallest i0 per
// target level: lanes of a warp that hold the same level reduce among
// themselves (__match_any_sync / __reduce_min_sync), one shared-memory
// atomicMin per group. Phase B: one warp per query, lanes over the Dh
// channels, so each tap row is one coalesced read of Dh floats; the tap
// scalars come from shared memory, so the 2 * L * P row loads of a query do
// not depend on one another. No tensor cores, no global atomics: each output
// element is written once.
//
// Layouts (all contiguous f32): value (B, S, H, Dh); loc, attn
// (B, S, H, L, P); out (B, S, H * Dh).

#include "ms_deform_attn_banded.cuh"

using namespace msda_banded;

namespace {

__global__ void __launch_bounds__(kThreads)
msda_banded_fwd_kernel(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ out, int S, int H, int Dh, int L,
                       int P, Geometry gm) {
  extern __shared__ unsigned char smem[];
  __shared__ int s_band[kMaxLevels];  // smallest i0, then the band start
  const int K = L * P;
  int* s_i0 = reinterpret_cast<int*>(smem);
  float* s_w0 = reinterpret_cast<float*>(smem) + kTileQ * K;
  float* s_w1 = s_w0 + kTileQ * K;

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
      const Tap tap = tap_at(loc[g], static_cast<float>(gm.T[l]));
      const float a = attn[g];
      i0 = tap.i0;
      s_i0[idx] = i0;
      s_w0[idx] = a * (1.f - tap.f);
      s_w1[idx] = a * tap.f;
    }
    lower_band_min(s_band, live, l, i0);
  }
  __syncthreads();
  band_starts(s_band, gm, lq, L);
  __syncthreads();

  // phase B: one warp per query, lanes over the channels
  const long long row = static_cast<long long>(H) * Dh;  // stride of one s
  const float* v_b = value + static_cast<long long>(b) * S * row +
                     static_cast<long long>(h) * Dh;
  for (int q = threadIdx.x / 32; q < nq; q += kThreads / 32) {
    const int* t_i0 = s_i0 + q * K;
    const float* t_w0 = s_w0 + q * K;
    const float* t_w1 = s_w1 + q * K;
    float* o = out + ((static_cast<long long>(b) * S + q_first + q) * H + h) * Dh;
    for (int c = lane; c < Dh; c += 32) {
      float acc = 0.f;
      for (int l = 0; l < L; ++l) {
        const int T = gm.T[l];
        const int s = s_band[l];
        const int hi = s + gm.band[lq][l] - 1;
        const float* v_l = v_b + gm.start[l] * row + c;
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          const int k = l * P + p;
          const int i0 = t_i0[k];
          const int r0 = min(max(i0, s), hi);
          const int r1 = min(max(min(i0 + 1, T - 1), s), hi);
          acc += t_w0[k] * v_l[r0 * row] + t_w1[k] * v_l[r1 * row];
        }
      }
      o[c] = acc;
    }
  }
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths,
// `band` a host array of L * L band sizes, row = query level. One query per
// value row (Lq == S). Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int msda_banded_fwd_f32(const float* value, const float* loc,
                                   const float* attn, float* out, int B, int S,
                                   int H, int Dh, int L, int P,
                                   const int* level_T, const int* band,
                                   void* stream) {
  Geometry gm;
  int blocks = 0;
  const long long shared = 3LL * kTileQ * L * P * sizeof(float);
  cudaError_t err = make_geometry(S, L, P, level_T, band, &gm);
  if (err == cudaSuccess) err = plan_launch(gm, B, H, L, shared, &blocks);
  if (err != cudaSuccess || blocks == 0) return static_cast<int>(err);
  msda_banded_fwd_kernel<<<blocks, kThreads,
                           static_cast<size_t>(shared),
                           static_cast<cudaStream_t>(stream)>>>(
      value, loc, attn, out, S, H, Dh, L, P, gm);
  return static_cast<int>(cudaGetLastError());
}
