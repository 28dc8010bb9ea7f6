// What the four deformable-attention kernels share: the tap of a sampling
// location, the layout of a value row over the lanes of a warp, the float4
// arithmetic on it, the transposing reduction of 16 dot products and the
// block-wide scan of the backward kernels' counting sorts.
//
// A value row of one head is Dh contiguous floats. Half a warp covers 64 of
// them in one 16-byte access per lane, so one warp instruction reaches both
// rows of a tap: lanes 0-15 the lower row, lanes 16-31 the upper one. A
// row of Dh floats takes ceil(Dh / 64) such accesses: the dense kernels take
// Dh up to 512 (kMaxVec; the transformer caption head's one head of 512),
// the banded ones up to 128 (kBandedMaxVec). Dh must be a multiple of 4, and
// every row must start on 16 bytes (the wrappers check the tensors).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace msda {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 512;    // a block of the backward and banded kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;       // 16-byte pieces of a lane's row: Dh <= 512
constexpr int kBandedMaxVec = 2;  // the banded kernels': Dh <= 128
constexpr long long kSharedOptIn = 48 * 1024;    // dynamic, without opting in
constexpr long long kSharedLimit = 232448;       // a block's most on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Tap {
  float x_raw;  // loc * T - 0.5, before the tap clamp
  float f;      // weight of the upper row
  int i0;       // lower row, level-local
};

// The tap of a sampling location into a level of T rows:
//   x = clamp(loc * T - 0.5, 0, T - 1), i0 = floor(x), f = x - i0
// __fmul_rn/__fsub_rn keep nvcc from contracting into an FMA, so the tap
// position rounds exactly as the plain version's does.
__device__ inline Tap tap_at(float loc, float Tf) {
  Tap t;
  t.x_raw = __fsub_rn(__fmul_rn(loc, Tf), 0.5f);
  const float x = fminf(fmaxf(t.x_raw, 0.f), Tf - 1.f);
  const float fl = floorf(x);
  t.f = x - fl;
  t.i0 = static_cast<int>(fl);
  return t;
}

// The bf16-tap forms of the forward kernels (1 and 3) read loc and attn as
// float or bf16 each, and prepare a tap by the JAX package's rule for those
// types (_prep_taps, gvl_tpu/ops/ms_deform_attn.py:56-81, with the weights
// packed to f32 afterwards, :349-358): the position, its clamp and the lerp
// fraction are computed in loc's type, each operation rounded to it; the
// weights attn * (1 - f) and attn * f in the promoted type of attn and loc,
// then widened to f32. With f32 loc that is the f32 tap over attn widened,
// the case of the decoder under eval_full_bf16. With bf16 loc the caller
// checks that every T and T - 1 is a bf16 value, so no level length rounds.
__device__ inline float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T ldg_t(const T* p) { return __ldg(p); }
template <>
__device__ inline __nv_bfloat16 ldg_t<__nv_bfloat16>(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __ushort_as_bfloat16(bits);
}

// A tap's lower row (level-local) and the weights of its two rows.
struct TapW {
  int i0;
  float w0, w1;
};

template <typename LocT, typename AttnT>
__device__ inline TapW tap_weights(LocT loc, AttnT attn, int T) {
  constexpr bool kLoc16 = !std::is_same<LocT, float>::value;
  constexpr bool kAttn16 = !std::is_same<AttnT, float>::value;
  const float a = to_f32(attn);
  const float Tf = static_cast<float>(T);
  TapW w;
  if (!kLoc16) {
    const Tap t = tap_at(to_f32(loc), Tf);
    w.i0 = t.i0;
    w.w0 = a * (1.f - t.f);
    w.w1 = a * t.f;
    return w;
  }
  // every step rounded to bf16, as XLA computes the bf16 chain
  const float xr =
      round_bf16(__fsub_rn(round_bf16(__fmul_rn(to_f32(loc), Tf)), 0.5f));
  const float x = fminf(fmaxf(xr, 0.f), Tf - 1.f);
  const float fl = floorf(x);
  const float f = x - fl;                 // exact in bf16
  const float om = round_bf16(1.f - f);
  w.i0 = static_cast<int>(fl);
  w.w0 = kAttn16 ? round_bf16(__fmul_rn(a, om)) : __fmul_rn(a, om);
  w.w1 = kAttn16 ? round_bf16(__fmul_rn(a, f)) : __fmul_rn(a, f);
  return w;
}

// A tap's two value rows (rows of the whole value tensor's batch element,
// level offsets added) and their weights.
struct TapRows {
  int r0, r1;
  float w0, w1;
};

// Where the dense kernels' taps come from; each kernel is written once for
// either source. LocAttnTaps: prepared from a sampling location and an
// attention weight (kernels 1 and 2; LocT, AttnT float, or bf16 for the
// bf16-tap form). GivenTaps: the rows and weights the caller prepared, the
// interface of the TPU kernels themselves (_msda_pallas_from_taps,
// gvl_tpu/ops/ms_deform_attn.py:330-345), which the sequence-parallel op
// calls on the taps it moved into a shard's window (the from-taps forms).
// rows(i, T, first): tap i, of a level of T rows whose first row is first.
// A given row outside [0, S) stops the launch (__trap: the next
// synchronisation raises) instead of reading past the value tensor; the
// wrapper checks the rows on the device this way, without a host sync.
template <typename LocT, typename AttnT>
struct LocAttnTaps {
  const LocT* loc;
  const AttnT* attn;
  __device__ TapRows rows(long long i, int T, int first) const {
    const TapW t = tap_weights(ldg_t(loc + i), ldg_t(attn + i), T);
    return TapRows{first + t.i0, first + min(t.i0 + 1, T - 1), t.w0, t.w1};
  }
};

// Whether row r lies outside a batch element's S rows.
__device__ inline bool outside(int r, int S) {
  return static_cast<unsigned>(r) >= static_cast<unsigned>(S);
}

struct GivenTaps {
  const int* g0;
  const int* g1;
  const float* w0;
  const float* w1;
  int S;
  __device__ TapRows rows(long long i, int, int) const {
    const TapRows t{__ldg(g0 + i), __ldg(g1 + i), __ldg(w0 + i),
                    __ldg(w1 + i)};
    if (outside(t.r0, S) || outside(t.r1, S)) __trap();
    return t;
  }
};

// Entry l of a table that a kernel takes by value, read without indexing
// it at run time: an indexed read makes every thread copy the whole table to
// local memory first.
template <int N>
__device__ inline int pick(const int (&table)[N], int l) {
  int v = table[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (j == l) v = table[j];
  return v;
}

// The levels of the dense kernels: their lengths and first rows.
struct Levels {
  int T[kMaxLevels];
  int start[kMaxLevels];
};

// Host: fills `lv` from L level lengths that must sum to S.
inline cudaError_t make_levels(int L, int S, const int* level_T, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return cudaErrorInvalidValue;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    if (level_T[l] < 1) return cudaErrorInvalidValue;
    lv->T[l] = level_T[l];
    lv->start[l] = start;
    start += level_T[l];
  }
  return start == S ? cudaSuccess : cudaErrorInvalidValue;
}

// Where a lane sits in the half-warp row layout: which row of a tap it
// reads (0 lower, 1 upper) and its first channel.
struct RowLane {
  int half;
  int c0;
};

__device__ inline RowLane row_lane() {
  const int lane = threadIdx.x % 32;
  return RowLane{lane / 16, (lane % 16) * 4};
}

// The lane's share of a row: channels c0 + 64 v .. + 3, v < NV, while they
// lie below Dh; the rest read as zeros.
template <int NV>
__device__ inline void load_row(float4 (&dst)[NV], const float* row_c0,
                                int c0, int Dh) {
#pragma unroll
  for (int v = 0; v < NV; ++v)
    dst[v] = c0 + 64 * v < Dh
        ? __ldg(reinterpret_cast<const float4*>(row_c0 + 64 * v))
        : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ inline float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ inline void fma4(float4& acc, float w, float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}

// Adds the other half warp's float4 to this one's (lane i and i + 16).
__device__ inline void add_halves(float4& acc) {
  acc.x += __shfl_xor_sync(kFull, acc.x, 16);
  acc.y += __shfl_xor_sync(kFull, acc.y, 16);
  acc.z += __shfl_xor_sync(kFull, acc.z, 16);
  acc.w += __shfl_xor_sync(kFull, acc.w, 16);
}

// One step of reduce16: lanes that differ in bit W of the lane index trade
// the halves of part[0 .. 2W): each keeps the half its bit names and adds
// its partner's copy of it.
template <int W>
__device__ inline void reduce16_step(float (&part)[16], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const float lo = part[t], hi = part[t + W];
    part[t] = (upper ? hi : lo) + __shfl_xor_sync(kFull, upper ? lo : hi, W);
  }
}

// Sums part[t] over the 16 lanes of each half warp, for the 16 values of t
// together: afterwards lane i of a half holds the sum of part[i]. Step by
// step a lane hands the half of its values that its partner keeps to the
// partner and adds what it gets to the half it keeps: 15 shuffles for 16
// sums, where one reduction per value would take 64.
__device__ inline float reduce16(float (&part)[16], int lane) {
  reduce16_step<8>(part, lane);
  reduce16_step<4>(part, lane);
  reduce16_step<2>(part, lane);
  reduce16_step<1>(part, lane);
  return part[0];
}

// Exclusive prefix sum of s_n[0 .. n) in place, by a whole block of
// kThreads; s_warp holds kWarps ints. Each thread sums a run of consecutive
// elements, the runs' totals are scanned by shuffles within a warp and
// through s_warp across warps. Every thread calls it; it synchronises before
// it returns.
__device__ inline void block_exclusive_scan(int* s_n, int n, int* s_warp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  int total = 0;
  for (int i = lo; i < hi; ++i) total += s_n[i];
  int incl = total;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int run = incl - total;
  for (int w = 0; w < warp; ++w) run += s_warp[w];
  for (int i = lo; i < hi; ++i) {
    const int c = s_n[i];
    s_n[i] = run;
    run += c;
  }
  __syncthreads();
}

// Which taps of a block's queries a thread prepares: point k of the
// queries q0, q0 + q_step, ... The first (kThreads / K) * K threads are
// live; consecutive threads hold consecutive (q, k), so their loads of loc
// and attn are contiguous, and a thread's level stays fixed.
struct TapOwner {
  bool live;
  int k, l;         // (level, point) index and its level
  int q0, q_step;
};

__device__ inline TapOwner tap_owner(int K, int P) {
  TapOwner o;
  o.q_step = kThreads / K;
  o.k = threadIdx.x % K;
  o.l = o.k / P;
  o.q0 = threadIdx.x / K;
  o.live = o.q0 < o.q_step;
  return o;
}

// Host: opts `kernel` in to `shared` bytes of dynamic shared memory where it
// needs more than 48 KB; refuses more than a block may have.
template <typename KernelT>
inline cudaError_t allow_shared(KernelT kernel, long long shared) {
  if (shared < 0 || shared > kSharedLimit) return cudaErrorInvalidValue;
  if (shared <= kSharedOptIn) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(shared));
}

}  // namespace msda
