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
// What bounds it: instructions and latency per gathered row; neither the
// bytes nor, any more, the atomics. At the long-video encoder shape of the
// train step (B=4, S=1500, H=8, Dh=64, L=P=4) one call reads value and dOut
// (12.3 MB each) and loc/attn (6.1 MB) and writes grad_value (12.3 MB) and
// grad_loc/grad_attn (6.1 MB), but gathers 1.54 M rows of 256 B for the dot
// products and scatters as many. The first form of this kernel (one lane per
// channel, ten shuffle steps per tap, lane 0 writing a query's 32 results one
// by one) was bound by its instruction count, and its 98 M scalar atomics
// cost a fifth of its time. With that cured, one atomic per tap row became
// half of the kernel, in 16-byte pieces as much as in 4-byte ones: an H100
// (700 W) adds about 0.9 T floats a second into L2. So the scatter is summed
// per tile first.
//
// Design: one block per (b, h, tile), all query levels in one launch, as
// the forward, and the same phase A, which here keeps f, attn and attn * T_l
// (0 where the tap clamp passes no gradient) beside the two rows.
// Phase B, grad_value: the bands of a tile hold 4.7 times fewer rows than
// its taps name (at the shape above), so the tile's tap rows are sorted by
// band row, a counting sort in shared memory with integer atomics, and half
// a warp per band row sums w * dOut over the row's hits in registers, four
// loads of dOut in flight, and adds the sum to device memory once: one
// 16-byte atomicAdd per lane (red.global.add.v4.f32, atomic per element)
// into a buffer the wrapper zeroes on the same stream. That step stays
// atomic because the bands of neighbouring tiles and of the query levels
// overlap. Rows that no tap names, the rows past a level among them, are
// skipped. Summing the band in shared memory instead would need f32
// atomicAdd on shared memory, which sm_90 runs as a compare-and-swap loop.
// The order in which the hits of a row are listed and the atomics of
// different blocks land is not fixed, so grad_value's sums vary in the last
// bits from run to run. `grad_value` may be null: then phase B is skipped.
// Phase C, grad_attn and grad_loc: one warp per query, half a warp per row in
// 16-byte loads, dOut's channels of the lane in registers for the whole
// query. A lane holds one partial dot product per tap; sixteen taps at a time
// are reduced together by a transposing reduction over the half warp (15
// shuffles for 16 sums), after which lane i of the lower half holds d0 of
// tap i and lane i of the upper half d1. One more shuffle swaps them, the
// lower half writes grad_attn and the upper half grad_loc, 16 consecutive
// floats each, each element exactly once.
//
// Layouts (all contiguous f32, 16-byte aligned): value, grad_value
// (B, S, H, Dh); loc, attn, grad_loc, grad_attn (B, S, H, L, P); grad_out
// (B, S, H * Dh).

#include "ms_deform_attn_banded.cuh"

using namespace msda_banded;

namespace {

// One tap row's share of grad_value: w * dOut[q] goes to the row.
struct Hit {
  int q;      // query of the tile
  float w;    // attn * (1 - f) or attn * f
};

template <int NV>
__global__ void __launch_bounds__(kThreads)
msda_banded_bwd_kernel(const float* __restrict__ grad_out,
                       const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ grad_value,
                       float* __restrict__ grad_loc,
                       float* __restrict__ grad_attn, int S, int H, int Dh,
                       int L, int P, Geometry gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_band[kMaxLevels];  // smallest i0, then the band start
  __shared__ int s_warp[kWarps];
  const int K = L * P;
  int2* s_row = reinterpret_cast<int2*>(smem);   // i0, then the two rows
  float2* s_fa = reinterpret_cast<float2*>(smem) + kTileQ * K;   // (f, attn)
  float* s_aT = reinterpret_cast<float*>(smem) + 4 * kTileQ * K;
                                      // attn * T_l inside the tap clamp, else 0
  // only with grad_value: the tile's tap rows sorted by band row. The bands
  // of the L target levels are numbered through (gm.base).
  Hit* s_hit = reinterpret_cast<Hit*>(s_aT + kTileQ * K);   // 2 per tap
  int* s_end = reinterpret_cast<int*>(s_hit + 2 * kTileQ * K);
                                      // per band row: where its hits end

  const Tile t = tile_of_block(gm, L, H);
  const int b = t.b, h = t.h, lq = t.lq, q_first = t.q_first, nq = t.nq;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x < L) s_band[threadIdx.x] = INT_MAX;
  __syncthreads();
  const int n_rows = grad_value ? gm.base[lq][L] : 0;
  for (int j = threadIdx.x; j < n_rows; j += kThreads) s_end[j] = 0;

  // phase A: taps of the tile, and the smallest i0 per target level, as in
  // the forward
  const TapOwner me = tap_owner(K, P);
  {
    const float Tf = static_cast<float>(gm.T[me.live ? me.l : 0]);
    int i0_min = INT_MAX;
    if (me.live) {
#pragma unroll 4
      for (int q = me.q0; q < nq; q += me.q_step) {
        const int idx = q * K + me.k;
        const long long g =
            ((static_cast<long long>(b) * S + q_first + q) * H + h) * K + me.k;
        const Tap tap = tap_at(loc[g], Tf);
        const float a = attn[g];
        i0_min = min(i0_min, tap.i0);
        s_row[idx] = make_int2(tap.i0, 0);
        s_fa[idx] = make_float2(tap.f, a);
        s_aT[idx] = (tap.x_raw > 0.f && tap.x_raw < Tf - 1.f) ? a * Tf : 0.f;
      }
    }
    const bool has_tap = i0_min != INT_MAX;
    lower_band_min(s_band, has_tap, has_tap ? me.l : -1, i0_min);
  }
  __syncthreads();
  band_starts(s_band, gm, lq, L);
  __syncthreads();
  clamp_rows_to_band(s_row, s_band, gm, lq, me, nq, K, 1);
  __syncthreads();
  const int row = H * Dh;  // stride of a value row

  const int half = lane / 16;
  const int c0 = (lane % 16) * 4;
  const long long bh_off = static_cast<long long>(b) * S * row +
                           static_cast<long long>(h) * Dh + c0;

  // phase B: grad_value. A counting sort of the tile's tap rows by band row,
  // then half a warp per band row sums w * dOut over the row's hits in
  // registers and adds the sum to device memory once.
  if (grad_value) {
    for (int pass = 0; pass < 2; ++pass) {
      if (me.live) {
        const int to_band = gm.base[lq][me.l] - gm.start[me.l] - s_band[me.l];
        for (int q = me.q0; q < nq; q += me.q_step) {
          const int2 rows = s_row[q * K + me.k];
          const int j0 = rows.x + to_band, j1 = rows.y + to_band;
          if (pass == 0) {
            atomicAdd(&s_end[j0], 1);
            atomicAdd(&s_end[j1], 1);
          } else {
            const float2 fa = s_fa[q * K + me.k];
            s_hit[atomicAdd(&s_end[j0], 1)] = Hit{q, fa.y * (1.f - fa.x)};
            s_hit[atomicAdd(&s_end[j1], 1)] = Hit{q, fa.y * fa.x};
          }
        }
      }
      __syncthreads();
      if (pass == 0) block_exclusive_scan(s_end, n_rows, s_warp);
    }
    const float* go_bh = grad_out +
                         (static_cast<long long>(b) * S + q_first) * row +
                         static_cast<long long>(h) * Dh + c0;
    float* gv_bh = grad_value + bh_off;
    for (int j = threadIdx.x / 16; j < n_rows; j += kThreads / 16) {
      const int beg = j ? s_end[j - 1] : 0;
      const int end = s_end[j];
      if (beg == end) continue;
      float4 acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      // four hits at a time, so that four loads of dOut are in flight; a
      // slot past the row's last hit repeats it with weight 0
      for (int i = beg; i < end; i += 4) {
        Hit hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hit[u] = s_hit[min(i + u, end - 1)];
          if (i + u >= end) hit[u].w = 0.f;
        }
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (c0 + 64 * v < Dh) {
            float4 g[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              g[u] = __ldg(reinterpret_cast<const float4*>(
                  go_bh + hit[u].q * row + 64 * v));
#pragma unroll
            for (int u = 0; u < 4; ++u) fma4(acc[v], hit[u].w, g[u]);
          }
      }
      int l = 0;
      while (j >= gm.base[lq][l + 1]) ++l;
      float* dst = gv_bh + (gm.start[l] + s_band[l] + j - gm.base[lq][l]) * row;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (c0 + 64 * v < Dh)
          atomicAdd(reinterpret_cast<float4*>(dst + 64 * v), acc[v]);
    }
  }

  // phase C: grad_attn and grad_loc, one warp per query, half a warp per row
  const float* v_bh = value + bh_off;
  for (int q = threadIdx.x / 32; q < nq; q += kWarps) {
    const long long qg = (static_cast<long long>(b) * S + q_first + q) * H + h;
    const int* t_row = reinterpret_cast<const int*>(s_row + q * K) + half;
    float4 go[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      go[v] = c0 + 64 * v < Dh
          ? __ldg(reinterpret_cast<const float4*>(grad_out + qg * Dh + c0 +
                                                  64 * v))
          : make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      float part[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        part[i] = 0.f;
        const int k = k0 + i;
        if (k < K) {
          const float* src = v_bh + t_row[2 * k] * row;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            if (c0 + 64 * v < Dh)
              part[i] += dot4(
                  __ldg(reinterpret_cast<const float4*>(src + 64 * v)), go[v]);
        }
      }
      // lane i of the lower half: d0 of tap k0 + i; of the upper half: d1
      const float mine = reduce16(part, lane);
      const float other = __shfl_xor_sync(0xffffffffu, mine, 16);
      const int k = k0 + lane % 16;
      if (k < K) {
        if (half == 0) {
          const float f = s_fa[q * K + k].x;
          grad_attn[qg * K + k] = (1.f - f) * mine + f * other;
        } else {
          grad_loc[qg * K + k] = s_aT[q * K + k] * (mine - other);
        }
      }
    }
  }
}

// Dynamic shared memory of one block: five words per tap, and with
// grad_value two hits per tap and one int per band row of the query level
// with the longest bands.
inline long long shared_needed(const Geometry& gm, int L, int P,
                               bool with_value) {
  const long long bytes = 20LL * kTileQ * L * P;
  if (!with_value) return bytes;
  int rows = 0;
  for (int lq = 0; lq < L; ++lq)
    if (gm.base[lq][L] > rows) rows = gm.base[lq][L];
  return bytes + 16LL * kTileQ * L * P + 4LL * rows;
}

template <int NV>
cudaError_t launch(const float* grad_out, const float* value, const float* loc,
                   const float* attn, float* grad_value, float* grad_loc,
                   float* grad_attn, int B, int S, int H, int Dh, int L, int P,
                   const Geometry& gm, long long shared, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = plan_launch(
      gm, B, H, L, shared, shared_needed(gm, L, P, grad_value != nullptr),
      msda_banded_bwd_kernel<NV>, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  msda_banded_bwd_kernel<NV><<<blocks, kThreads, static_cast<size_t>(shared),
                               stream>>>(grad_out, value, loc, attn,
                                         grad_value, grad_loc, grad_attn, S, H,
                                         Dh, L, P, gm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths,
// `band` a host array of L * L band sizes, row = query level. One query per
// value row (Lq == S). Dh is a multiple of 4, at most 128. `grad_value` must
// be zeroed on `stream` before the call, or be null when the gradient of
// value is not wanted. `band_base` holds, per query level, the L + 1 running
// sums of its band sizes; `shared` is the dynamic shared memory of a block
// (shared_needed above). Launches on `stream` and returns the CUDA error of
// the launch (0 = launched).
extern "C" int msda_banded_bwd_f32(const float* grad_out, const float* value,
                                   const float* loc, const float* attn,
                                   float* grad_value, float* grad_loc,
                                   float* grad_attn, int B, int S, int H,
                                   int Dh, int L, int P, const int* level_T,
                                   const int* band, const int* band_base,
                                   int shared, void* stream) {
  Geometry gm;
  cudaError_t err =
      make_geometry(S, H, Dh, L, P, level_T, band, band_base, &gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = Dh <= 64
      ? launch<1>(grad_out, value, loc, attn, grad_value, grad_loc, grad_attn,
                  B, S, H, Dh, L, P, gm, shared, st)
      : launch<2>(grad_out, value, loc, attn, grad_value, grad_loc, grad_attn,
                  B, S, H, Dh, L, P, gm, shared, st);
  return static_cast<int>(err);
}
