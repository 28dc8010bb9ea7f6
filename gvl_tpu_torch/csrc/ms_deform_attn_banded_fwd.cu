// Banded 1-D multi-scale deformable attention for token queries, forward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn_banded.py::_fwd_kernel.
// That kernel exists because the dense TPU kernel builds an (S, 128)
// interpolation matrix per tile of 128 queries; for token queries (one query
// per value row, S >= 512) it builds the matrix only over a band of BS_l rows
// of each level, starting at the tile's smallest tap row, and contracts it
// with that window of the value on the MXU. Taps outside the band are clamped
// to its edge. Here the taps are gathered directly; what is carried over is
// the function, clamp included.
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
// What bounds it: instructions and latency per gathered row, not the bytes.
// At the long-video encoder shape (B=8, S=1500, H=8, Dh=64, L=P=4) one call
// reads 24.6 MB of value and 12.3 MB of loc/attn and writes 24.6 MB, but it
// gathers 3.07 M rows of 256 B, 786 MB, from L1/L2. The first form of this
// kernel (4-byte loads, one lane per channel, the clamps and a 64-bit
// address per tap and lane) ran no faster with every row load made an L1
// hit: it was bound by its instruction count. This form runs a quarter of
// the instructions and takes a third of the time (0.066 ms on an H100 at 700
// W); with every row load an L1 hit it gains nothing more, and phase A is a
// quarter of it. The rows alone, 786 MB through the SMs' 128-byte-a-clock L1
// paths, take 0.027 ms.
//
// Design: one block per (b, h, tile), all query levels in one launch. Phase
// A: a thread keeps one (level, point) and walks the tile's queries, so its
// loads of loc and attn are independent; it writes i0 and the two
// lerp-folded weights of each tap to shared memory and keeps the smallest
// i0, then the lanes of a warp that hold the same level reduce among
// themselves (__match_any_sync / __reduce_min_sync), one shared-memory
// atomicMin per group. Then every tap's two rows are clamped to the band
// once and kept as offsets. Phase B: one warp per query; half a warp covers a
// row in 16-byte loads, so one instruction fetches both rows of a tap, and a
// tap costs two scalar loads from shared memory, one address, one load and
// four FMAs per lane. The two halves' sums meet in one shuffle at the end.
// The taps are thus summed in another order than the plain version's (lower
// rows and upper rows apart); the results agree to a few ulp, well inside
// the 1e-5 they are held to. No tensor cores, no global atomics: each output
// element is written once.
// The band is not staged in shared memory. A form that copies each band in
// chunks (cp.async, two buffers) and gathers from the chunks takes 2.6
// times as long on this card, or more: what it could save, the row loads
// that miss L1, is next to nothing, and it pays with a scan of the tile's
// taps per chunk and two block-wide barriers per chunk.
//
// Layouts (all contiguous f32, 16-byte aligned): value (B, S, H, Dh); loc,
// attn (B, S, H, L, P); out (B, S, H * Dh).

#include "ms_deform_attn_banded.cuh"

using namespace msda_banded;

namespace {

// Three blocks of 512 threads on an SM, 40 registers a thread: left to
// itself ptxas takes 32 for a fourth block, spills, and the kernel runs 15%
// slower.
template <int NV>
__global__ void __launch_bounds__(kThreads, 3)
msda_banded_fwd_kernel(const float* __restrict__ value,
                       const float* __restrict__ loc,
                       const float* __restrict__ attn,
                       float* __restrict__ out, int S, int H, int Dh, int L,
                       int P, Geometry gm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_band[kMaxLevels];  // smallest i0, then the band start
  const int K = L * P;
  int2* s_row = reinterpret_cast<int2*>(smem);   // i0, then the rows' offsets
  float2* s_w = reinterpret_cast<float2*>(smem) + kTileQ * K;   // (w0, w1)

  const Tile t = tile_of_block(gm, L, H);
  const int b = t.b, h = t.h, lq = t.lq, q_first = t.q_first, nq = t.nq;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x < L) s_band[threadIdx.x] = INT_MAX;
  __syncthreads();

  // phase A: taps of the tile, and the smallest i0 per target level. A
  // thread keeps one (level, point) and walks the queries, so its level is
  // fixed and its loads do not wait on one another.
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
        s_w[idx] = make_float2(a * (1.f - tap.f), a * tap.f);
      }
    }
    const bool has_tap = i0_min != INT_MAX;
    lower_band_min(s_band, has_tap, has_tap ? me.l : -1, i0_min);
  }
  __syncthreads();
  band_starts(s_band, gm, lq, L);
  __syncthreads();
  const int row = H * Dh;  // stride of a value row
  clamp_rows_to_band(s_row, s_band, gm, lq, me, nq, K, row);
  __syncthreads();

  // phase B: one warp per query, half a warp per row
  const int half = lane / 16;
  const int c0 = (lane % 16) * 4;
  const float* v_bh = value + static_cast<long long>(b) * S * row +
                      static_cast<long long>(h) * Dh + c0;
  for (int q = threadIdx.x / 32; q < nq; q += kWarps) {
    const int* t_row = reinterpret_cast<const int*>(s_row + q * K) + half;
    const float* t_w = reinterpret_cast<const float*>(s_w + q * K) + half;
    float4 acc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float* src = v_bh + t_row[2 * k];
      const float w = t_w[2 * k];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (c0 + 64 * v < Dh)
          fma4(acc[v], w, __ldg(reinterpret_cast<const float4*>(src + 64 * v)));
    }
    float* o = out +
               ((static_cast<long long>(b) * S + q_first + q) * H + h) * Dh + c0;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      acc[v].x += __shfl_xor_sync(0xffffffffu, acc[v].x, 16);
      acc[v].y += __shfl_xor_sync(0xffffffffu, acc[v].y, 16);
      acc[v].z += __shfl_xor_sync(0xffffffffu, acc[v].z, 16);
      acc[v].w += __shfl_xor_sync(0xffffffffu, acc[v].w, 16);
      if (half == 0 && c0 + 64 * v < Dh)
        *reinterpret_cast<float4*>(o + 64 * v) = acc[v];
    }
  }
}

template <int NV>
cudaError_t launch(const float* value, const float* loc, const float* attn,
                   float* out, int B, int S, int H, int Dh, int L, int P,
                   const Geometry& gm, long long shared, cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = plan_launch(gm, B, H, L, shared,
                                      16LL * kTileQ * L * P,
                                      msda_banded_fwd_kernel<NV>, &blocks);
  if (err != cudaSuccess || blocks == 0) return err;
  msda_banded_fwd_kernel<NV><<<blocks, kThreads, static_cast<size_t>(shared),
                               stream>>>(value, loc, attn, out, S, H, Dh, L, P,
                                         gm);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths,
// `band` a host array of L * L band sizes, row = query level. One query per
// value row (Lq == S). Dh is a multiple of 4, at most 128. `shared` is the
// dynamic shared memory of a block, 16 bytes per tap of a tile. Launches on
// `stream` and returns the CUDA error of the launch (0 = launched).
extern "C" int msda_banded_fwd_f32(const float* value, const float* loc,
                                   const float* attn, float* out, int B, int S,
                                   int H, int Dh, int L, int P,
                                   const int* level_T, const int* band,
                                   int shared, void* stream) {
  Geometry gm;
  cudaError_t err = make_geometry(S, H, Dh, L, P, level_T, band, nullptr, &gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = Dh <= 64
      ? launch<1>(value, loc, attn, out, B, S, H, Dh, L, P, gm, shared, st)
      : launch<2>(value, loc, attn, out, B, S, H, Dh, L, P, gm, shared, st);
  return static_cast<int>(err);
}
