// 1-D multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn.py::_bwd_kernel_full.
// That kernel rebuilds the (S, 128) interpolation matrix W per query tile,
// keeps one (b, h)'s dV = W . dOut in VMEM across the sequential grid axis
// of query tiles, and returns the per-tap dw0/dw1 so that autodiff carries
// them through the tap preparation. Here the taps are gathered directly, as
// in the forward, and the tap preparation's derivative is folded into the
// kernel: it returns the gradients of value, loc and attn themselves.
//
// What it computes, for each (b, q, h), level l, point p (exact f32, the
// same clamp/floor/lerp as the forward):
//   x   = clamp(loc * T_l - 0.5, 0, T_l - 1)
//   i0  = floor(x), f = x - i0, i1 = min(i0 + 1, T_l - 1)
//   d0  = <V[start_l + i0], dOut>, d1 = <V[start_l + i1], dOut>   (over Dh)
//   grad_attn = (1 - f) * d0 + f * d1
//   grad_loc  = attn * T_l * (d1 - d0)  where 0 < loc * T_l - 0.5 < T_l - 1,
//               0 where the clamp is active (and on its bounds)
//   grad_value[start_l + i0] += attn * (1 - f) * dOut
//   grad_value[start_l + i1] += attn * f * dOut
//
// What bounds it: instructions per gathered row and where the rows come
// from, not the bytes. At the flagship encoder shape (B=16, S=Lq=188, H=8,
// Dh=64, L=P=4) it reads value and dOut (6.2 MB each) and loc/attn (3.1 MB)
// and writes grad_value (6.2 MB) and grad_loc/grad_attn (3.1 MB), but it
// gathers 770 K rows of value for the dot products and as many of dOut for
// grad_value, 197 MB each. The first form of this kernel (one lane per
// channel, two dependent 5-step shuffle reductions and four scalar atomics
// per lane and tap) spent 87% of its time without grad_value: its
// instruction count, not the atomics, bound it.
//
// Design: two kernels, launched one after the other on the caller's stream.
// The dot kernel (grad_attn, grad_loc): one warp per (b, q, h), as the
// forward, no shared memory. Lanes i and i + 16 prepare tap i; the lower
// half keeps its lower row, the upper half its upper row. Half a warp reads
// a row in 16-byte loads (ms_deform_attn_common.cuh), dOut's channels of the
// lane in registers, so a lane holds one partial dot product per tap;
// sixteen taps at a time are reduced together by the transposing reduction
// (15 shuffles for 16 sums), after which lane i of the lower half holds d0
// of tap i and lane i of the upper half d1. One more shuffle swaps them, the
// lower half writes grad_attn and the upper half grad_loc, 16 consecutive
// floats each.
// The value kernel (grad_value; not launched when grad_value is null): one
// block of 512 threads per (b, h) and range of at most 256 of its rows, the
// TPU kernel's blocking cut by rows. It walks the (b, h)'s queries in
// chunks (one at every main path's shape): it prepares the chunk's taps in
// shared memory with the chunk's rows of dOut, and sorts the tap rows that
// fall in its range by row, a counting sort that keeps their order: each
// warp counts its run of the chunk's hits per row with integer atomics on
// counters of its own, a block-wide scan turns the counts into places in
// the order (row, warp), and each warp lists its run's hits in their order
// (__match_any_sync ranks the lanes that share a row). Then half a warp per
// row sums w * dOut over the row's hits in registers, dOut read from shared
// memory, and stores the row; in a later chunk it reads the row back and
// goes on summing. So a row's hits are summed in the order of the taps,
// each row is written by one block, rows no tap names are stored as zeros
// at the end: no zeroing pass, no float atomic, and grad_value is the same,
// bit for bit, in every run (the "owner" form; adding each chunk's sums
// into a zeroed buffer by atomics was slower at every main path's shape).
//
// The from-taps form (msda_taps_bwd_f32) is the same two kernels over taps
// the caller prepared (rows g0, g1 and weights w0, w1, GivenTaps and
// DotGiven): the value kernel scatters w0 * dOut and w1 * dOut as kernel 2
// does, the dot kernel writes d0 and d1 themselves, the gradients of w0 and
// w1. It is the backward of the TPU kernel's own interface
// (_bwd_kernel_full returns dV, dw0, dw1), which the sequence-parallel op
// runs on taps moved into a shard's window; autograd carries dw0 and dw1 to
// loc and attn through the port's prep_taps.
//
// Layouts (all contiguous f32, value, grad_value and grad_out 16-byte
// aligned): value, grad_value (B, S, H, Dh); loc, attn, grad_loc, grad_attn
// (B, Lq, H, L, P); grad_out (B, Lq, H * Dh). Dh is a multiple of 4, at most
// 512.

#include <climits>

#include "ms_deform_attn_common.cuh"

using namespace msda;

namespace {

constexpr int kDotWarps = 8;       // (b, q, h) per dot block
// counters of a row: one per warp and one that stays 0, so that a warp's
// counters of 32 rows lie in 32 banks and the row's last entry is its end
constexpr int kRowStride = kWarps + 1;

// The value blocks of a launch: (b, h) x row ranges, the range the fastest
// index.
struct Grid {
  int rows;     // rows of a range; the last range may be short
  int n_rr;     // ranges of the S rows
  int chunk;    // queries a block sorts at once
};

// Dynamic shared memory of a value block: 32 bytes per tap and 4 per float
// of dOut of a chunk, kRowStride counters per row of the range.
inline long long value_shared(int K, int Dh, const Grid& gr) {
  return 32LL * gr.chunk * K + 4LL * gr.chunk * Dh +
         4LL * kRowStride * gr.rows;
}

// One tap row's share of grad_value: w * dOut[q] goes to the row.
struct Hit {
  int q;      // query of the chunk
  float w;    // attn * (1 - f) or attn * f
};

// Src: where the taps come from (LocAttnTaps<float, float> for kernel 2,
// GivenTaps for its from-taps form; ms_deform_attn_common.cuh).
template <int NV, typename Src>
__global__ void __launch_bounds__(kThreads)
msda_bwd_value_kernel(const float* __restrict__ grad_out, Src src,
                      float* __restrict__ grad_value, int S, int H, int Dh,
                      int Lq, int L, int P, Levels lv, Grid gr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp[kWarps];
  const int K = L * P;
  const int cap = gr.chunk * K;
  int2* s_row = reinterpret_cast<int2*>(smem);          // a tap's two rows
  float2* s_w = reinterpret_cast<float2*>(s_row + cap);  // and their weights
  Hit* s_hit = reinterpret_cast<Hit*>(s_w + cap);        // 2 per tap
  // the chunk's rows of dOut
  float* s_go = reinterpret_cast<float*>(s_hit + 2 * cap);
  // per row and warp, row-major (kRowStride a row): the count of the row's
  // hits in the warp's run, then the place of its next one
  int* s_pos = reinterpret_cast<int*>(s_go + gr.chunk * Dh);

  const int rr = blockIdx.x % gr.n_rr;
  const int bh = blockIdx.x / gr.n_rr;
  const int h = bh % H, b = bh / H;
  const int lo = rr * gr.rows;                     // first row of the range
  const int nr = min(gr.rows, S - lo);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int hw = threadIdx.x / 16;      // the half warp: rows hw + 32 m
  const RowLane rl = row_lane();
  const int row = H * Dh;  // stride of a value row
  const float* go_b = grad_out + static_cast<long long>(b) * Lq * row + h * Dh;
  float* gv_bh = grad_value + (static_cast<long long>(b) * S + lo) * row +
                 h * Dh + rl.c0;
  const TapOwner me = tap_owner(K, P);
  const int T = pick(lv.T, me.l);
  const int first = pick(lv.start, me.l);

  // bit m: row hw + 32 m is stored (at most 64 of them)
  unsigned long long stored = 0;
  for (int c0 = 0; c0 < Lq; c0 += gr.chunk) {
    const int nc = min(gr.chunk, Lq - c0);
    // the chunk's taps
    if (me.live) {
#pragma unroll 4
      for (int q = me.q0; q < nc; q += me.q_step) {
        const long long g =
            ((static_cast<long long>(b) * Lq + c0 + q) * H + h) * K +
            me.k;
        const TapRows t = src.rows(g, T, first);
        s_row[q * K + me.k] = make_int2(t.r0, t.r1);
        s_w[q * K + me.k] = make_float2(t.w0, t.w1);
      }
    }
#pragma unroll 4
    for (int j = threadIdx.x; j < nc * Dh / 4; j += kThreads) {
      const int q = j / (Dh / 4), c = 4 * (j % (Dh / 4));
      *reinterpret_cast<float4*>(s_go + q * Dh + c) = __ldg(
          reinterpret_cast<const float4*>(go_b + (c0 + q) * row + c));
    }
    for (int j = threadIdx.x; j < nr * kRowStride; j += kThreads)
      s_pos[j] = 0;
    __syncthreads();
    // hit j is row j % 2 (lower, upper) of tap j / 2, as s_row lists them;
    // warp w takes the run [h0, h1) of the chunk's hits
    const int* hit_row = reinterpret_cast<const int*>(s_row);
    const float* hit_w = reinterpret_cast<const float*>(s_w);
    const int n_hit = 2 * nc * K;
    const int per = (n_hit + kWarps - 1) / kWarps;
    const int h0 = min(n_hit, warp * per), h1 = min(n_hit, h0 + per);
    for (int j = h0 + lane; j < h1; j += 32) {
      const int r = hit_row[j] - lo;
      if (r >= 0 && r < nr) atomicAdd(&s_pos[r * kRowStride + warp], 1);
    }
    __syncthreads();
    block_exclusive_scan(s_pos, nr * kRowStride, s_warp);
    // each warp lists its hits, in their order, after those of the warps
    // before it: a row's hits stand in the order of the taps
    for (int j0 = h0; j0 < h1; j0 += 32) {
      const int j = j0 + lane;
      const int r = j < h1 ? hit_row[j] - lo : -1;
      const bool in = r >= 0 && r < nr;
      const unsigned peers = __match_any_sync(kFull, in ? r : -1);
      if (in)
        s_hit[s_pos[r * kRowStride + warp] +
              __popc(peers & ((1u << lane) - 1u))] =
            Hit{(j >> 1) / K, hit_w[j]};
      __syncwarp();
      if (in && lane == __ffs(peers) - 1)
        s_pos[r * kRowStride + warp] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // now a row's last entry is where its hits end. Half
    // a warp sums its rows' hits in order, four at a time (a slot past the
    // row's last hit repeats it with weight 0), and continues the sum it
    // stored for an earlier chunk.
    for (int m = 0; hw + 32 * m < nr; ++m) {
      const int r = hw + 32 * m;
      const int end = s_pos[r * kRowStride + kWarps];
      const int beg = r ? s_pos[r * kRowStride - 1] : 0;
      if (beg == end) continue;
      float* dst = gv_bh + static_cast<long long>(r) * row;
      float4 acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        acc[v] = (stored >> m & 1ull) && rl.c0 + 64 * v < Dh
            ? *reinterpret_cast<const float4*>(dst + 64 * v)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = beg; i < end; i += 4) {
        Hit hit[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          hit[u] = s_hit[min(i + u, end - 1)];
          if (i + u >= end) hit[u].w = 0.f;
        }
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (rl.c0 + 64 * v < Dh) {
            float4 g[4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              g[u] = *reinterpret_cast<const float4*>(
                  s_go + hit[u].q * Dh + rl.c0 + 64 * v);
#pragma unroll
            for (int u = 0; u < 4; ++u) fma4(acc[v], hit[u].w, g[u]);
          }
      }
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (rl.c0 + 64 * v < Dh)
          *reinterpret_cast<float4*>(dst + 64 * v) = acc[v];
      stored |= 1ull << m;
    }
    __syncthreads();   // before the next chunk takes the shared memory
  }
  // the rows no tap names
  for (int m = 0; hw + 32 * m < nr; ++m) {
    if (stored >> m & 1ull) continue;
    float* dst = gv_bh + static_cast<long long>(hw + 32 * m) * row;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (rl.c0 + 64 * v < Dh)
        *reinterpret_cast<float4*>(dst + 64 * v) =
            make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The dot kernel's taps: the row of tap i that half a warp reads (half 0
// the lower row, 1 the upper), and what it stores from the tap's two dot
// products d (its own row's) and other (the other half's). DotLocAttn is
// kernel 2's: the gradients of loc and attn. DotGiven the from-taps form's:
// the gradients of the given weights w0 and w1, d0 and d1 themselves.
struct DotLocAttn {
  const float* loc;
  const float* attn;
  float* grad_loc;
  float* grad_attn;
  struct Aux {
    float f, aT;
  };
  __device__ int row(long long i, int T, int first, int half, Aux& x) const {
    const float Tf = static_cast<float>(T);
    const Tap t = tap_at(__ldg(loc + i), Tf);
    const float a = __ldg(attn + i);
    x.f = t.f;
    x.aT = (t.x_raw > 0.f && t.x_raw < Tf - 1.f) ? a * Tf : 0.f;
    return first + (half ? min(t.i0 + 1, T - 1) : t.i0);
  }
  __device__ void store(long long i, int half, float d, float other,
                        const Aux& x) const {
    if (half == 0)
      grad_attn[i] = (1.f - x.f) * d + x.f * other;
    else
      grad_loc[i] = x.aT * (d - other);
  }
};

struct DotGiven {
  const int* g0;
  const int* g1;
  float* dw0;
  float* dw1;
  int S;
  struct Aux {};
  __device__ int row(long long i, int, int, int half, Aux&) const {
    const int r = __ldg((half ? g1 : g0) + i);
    if (outside(r, S)) __trap();     // as GivenTaps
    return r;
  }
  __device__ void store(long long i, int half, float d, float,
                        const Aux&) const {
    (half ? dw1 : dw0)[i] = d;
  }
};

// The dot products of one (b, q, h), by one warp.
template <int NV, bool kK16, typename DotSrc>
__device__ void dot_warp(long long warp, const float* __restrict__ grad_out,
                         const float* __restrict__ value, const DotSrc& src,
                         int S, int H, int Dh, int Lq, int L, int P,
                         const Levels& lv) {
  const int lane = threadIdx.x % 32;
  const int h = static_cast<int>(warp % H);
  const int b = static_cast<int>(warp / (static_cast<long long>(Lq) * H));
  const int K = kK16 ? 16 : L * P;
  const RowLane me = row_lane();
  const int row = H * Dh;
  const float* v_bh =
      value + static_cast<long long>(b) * S * row + h * Dh + me.c0;
  float4 go[NV];
  load_row<NV>(go, grad_out + warp * Dh + me.c0, me.c0, Dh);
  for (int k0 = 0; k0 < K; k0 += 16) {
    // lane i and lane i + 16 prepare tap k0 + i: the lower half reads its
    // lower row, the upper half its upper row
    const int k = k0 + lane % 16;
    int off = 0;
    typename DotSrc::Aux x{};
    if (kK16 || k < K) {
      const int l = k / P;
      off = src.row(warp * K + k, pick(lv.T, l), pick(lv.start, l), me.half,
                    x) * row;
    }
    const int n = kK16 ? 16 : min(16, K - k0);
    float part[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      part[i] = 0.f;
      if (kK16 || i < n) {
        float4 r[NV];
        load_row<NV>(r, v_bh + __shfl_sync(kFull, off, (lane & 16) | i),
                     me.c0, Dh);
#pragma unroll
        for (int v = 0; v < NV; ++v) part[i] += dot4(r[v], go[v]);
      }
    }
    // lane i of the lower half: d0 of tap k0 + i; of the upper half: d1
    const float d = reduce16(part, lane);
    const float other = __shfl_xor_sync(kFull, d, 16);
    if (kK16 || k < K) src.store(warp * K + k, me.half, d, other, x);
  }
}

// kK16: K = L * P = 16, known at compile time.
template <int NV, bool kK16, typename DotSrc>
__global__ void __launch_bounds__(kDotWarps * 32)
msda_bwd_dot_kernel(const float* __restrict__ grad_out,
                    const float* __restrict__ value, DotSrc src, int B, int S,
                    int H, int Dh, int Lq, int L, int P, Levels lv) {
  const long long warp =
      static_cast<long long>(blockIdx.x) * kDotWarps + threadIdx.x / 32;
  if (warp < static_cast<long long>(B) * Lq * H)  // whole warps
    dot_warp<NV, kK16>(warp, grad_out, value, src, S, H, Dh, Lq, L, P, lv);
}

template <int NV, typename Src, typename DotSrc>
cudaError_t launch(const float* grad_out, const float* value, Src src,
                   DotSrc dsrc, float* grad_value, int B, int S, int H,
                   int Dh, int Lq, int L, int P, const Levels& lv,
                   const Grid& gr, long long value_blocks,
                   long long dot_blocks, int shared, cudaStream_t stream) {
  if (value_blocks > 0) {
    msda_bwd_value_kernel<NV, Src><<<static_cast<int>(value_blocks), kThreads,
                                     static_cast<size_t>(shared), stream>>>(
        grad_out, src, grad_value, S, H, Dh, Lq, L, P, lv, gr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dot_blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(dot_blocks)), block(kDotWarps * 32);
  if (L * P == 16)
    msda_bwd_dot_kernel<NV, true, DotSrc><<<grid, block, 0, stream>>>(
        grad_out, value, dsrc, B, S, H, Dh, Lq, L, P, lv);
  else
    msda_bwd_dot_kernel<NV, false, DotSrc><<<grid, block, 0, stream>>>(
        grad_out, value, dsrc, B, S, H, Dh, Lq, L, P, lv);
  return cudaGetLastError();
}

// The value kernel's shared memory allowed, then both kernels launched.
template <int NV, typename Src, typename DotSrc>
cudaError_t launch_nv(const float* grad_out, const float* value, Src src,
                      DotSrc dsrc, float* grad_value, int B, int S, int H,
                      int Dh, int Lq, int L, int P, const Levels& lv,
                      const Grid& gr, long long value_blocks,
                      long long dot_blocks, int shared, cudaStream_t st) {
  if (value_blocks > 0) {
    const cudaError_t err =
        allow_shared(msda_bwd_value_kernel<NV, Src>, shared);
    if (err != cudaSuccess) return err;
  }
  return launch<NV>(grad_out, value, src, dsrc, grad_value, B, S, H, Dh, Lq,
                    L, P, lv, gr, value_blocks, dot_blocks, shared, st);
}

// The sizes checked, the blocks counted and the launches of one backward,
// NV (the 16-byte pieces of a lane's row) from Dh. Returns the CUDA error
// (0 = launched).
template <typename Src, typename DotSrc>
cudaError_t run(const float* grad_out, const float* value, Src src,
                DotSrc dsrc, float* grad_value, int B, int S, int H, int Dh,
                int Lq, int L, int P, const Levels& lv, int chunk, int rows,
                int shared, cudaStream_t st) {
  if (P < 1 || L * P > kThreads || Dh < 4 || Dh % 4 != 0 ||
      Dh > 64 * kMaxVec || chunk < 1 || chunk > (Lq > 1 ? Lq : 1) ||
      rows < 1 || rows > 32 * 64 ||
      static_cast<long long>(S) * H * Dh > INT_MAX ||
      static_cast<long long>(Lq) * H * Dh > INT_MAX)
    return cudaErrorInvalidValue;
  const Grid gr{rows, (S + rows - 1) / rows, chunk};
  const long long value_blocks =
      grad_value ? static_cast<long long>(B) * H * gr.n_rr : 0;
  const long long dot_blocks =
      (static_cast<long long>(B) * Lq * H + kDotWarps - 1) / kDotWarps;
  if (value_blocks > INT_MAX || dot_blocks > INT_MAX ||
      (grad_value && shared < value_shared(L * P, Dh, gr)))
    return cudaErrorInvalidValue;
  if (Dh <= 64)
    return launch_nv<1>(grad_out, value, src, dsrc, grad_value, B, S, H, Dh,
                        Lq, L, P, lv, gr, value_blocks, dot_blocks, shared,
                        st);
  if (Dh <= 128)
    return launch_nv<2>(grad_out, value, src, dsrc, grad_value, B, S, H, Dh,
                        Lq, L, P, lv, gr, value_blocks, dot_blocks, shared,
                        st);
  if (Dh <= 256)
    return launch_nv<4>(grad_out, value, src, dsrc, grad_value, B, S, H, Dh,
                        Lq, L, P, lv, gr, value_blocks, dot_blocks, shared,
                        st);
  return launch_nv<8>(grad_out, value, src, dsrc, grad_value, B, S, H, Dh,
                      Lq, L, P, lv, gr, value_blocks, dot_blocks, shared, st);
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths.
// The plan (ops/ms_deform_attn.py bwd_plan): a value block sorts its
// (b, h)'s queries `chunk` at a time and owns `rows` value rows (at most
// 2048), in `shared` bytes of dynamic shared memory (at least value_shared;
// anything without grad_value). grad_value is stored whole: it need not be
// zeroed. `grad_value` may be null when the gradient of value is not
// wanted. Launches on `stream` and returns the CUDA error of the launches
// (0 = launched); refuses sizes the kernels do not take.
extern "C" int msda_bwd_f32(const float* grad_out, const float* value,
                            const float* loc, const float* attn,
                            float* grad_value, float* grad_loc,
                            float* grad_attn, int B, int S, int H, int Dh,
                            int Lq, int L, int P, const int* level_T,
                            int chunk, int rows, int shared,
                            void* stream) {
  Levels lv;
  const cudaError_t err = make_levels(L, S, level_T, &lv);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      run(grad_out, value, LocAttnTaps<float, float>{loc, attn},
          DotLocAttn{loc, attn, grad_loc, grad_attn}, grad_value, B, S, H,
          Dh, Lq, L, P, lv, chunk, rows, shared,
          static_cast<cudaStream_t>(stream)));
}

// The from-taps form: the backward of msda_taps_fwd_f32 (the semantics of
// _bwd_kernel_full, gvl_tpu/ops/ms_deform_attn.py:236-268): grad_value as
// kernel 2's, scattering w0 * dOut to row g0 and w1 * dOut to row g1, and
// dw0 = <V[g0], dOut>, dw1 = <V[g1], dOut>, each (B, Lq, H, L, P). The plan
// as msda_bwd_f32's; `grad_value` may be null. A row outside [0, S) stops
// the launch (GivenTaps).
extern "C" int msda_taps_bwd_f32(const float* grad_out, const float* value,
                                 const int* g0, const int* g1,
                                 const float* w0, const float* w1,
                                 float* grad_value, float* dw0, float* dw1,
                                 int B, int S, int H, int Dh, int Lq, int L,
                                 int P, int chunk, int rows, int shared,
                                 void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv{};      // the given rows carry their levels
  return static_cast<int>(
      run(grad_out, value, GivenTaps{g0, g1, w0, w1, S},
          DotGiven{g0, g1, dw0, dw1, S}, grad_value, B, S, H, Dh, Lq, L, P, lv,
          chunk, rows, shared, static_cast<cudaStream_t>(stream)));
}
