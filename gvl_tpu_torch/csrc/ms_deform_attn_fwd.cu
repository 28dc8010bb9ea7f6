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
// What bounds it: memory and launches, not FLOPs. At the flagship encoder
// shape (B=16, S=Lq=188, H=8, Dh=64, L=P=4) one call reads ~6 MB of value
// rows and ~3 MB of loc/attn and does ~50 MFLOP.
//
// Design: one warp per (b, q, h); lanes walk the Dh channels, so each tap row
// is one coalesced read of Dh floats. Every lane computes the tap scalars
// itself (loc/attn reads are warp-broadcast). No shared memory, no tensor
// cores, no atomics: each output element is written once.
//
// Layouts (all contiguous f32): value (B, S, H, Dh); loc, attn
// (B, Lq, H, L, P); out (B, Lq, H * Dh).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int T[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void msda_fwd_kernel(const float* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                float* __restrict__ out, int B, int S, int H,
                                int Dh, int Lq, int L, int P, Levels lv) {
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * H) return;
  const int h = warp % H;
  const int b = warp / (Lq * H);

  const long long tap_base = static_cast<long long>(warp) * L * P;
  const float* v_b = value + static_cast<long long>(b) * S * H * Dh +
                     static_cast<long long>(h) * Dh;
  const long long row = static_cast<long long>(H) * Dh;  // stride of one s
  float* o = out + static_cast<long long>(warp) * Dh;

  for (int c = lane; c < Dh; c += 32) {
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int T = lv.T[l];
      const float Tf = static_cast<float>(T);
      for (int p = 0; p < P; ++p) {
        const long long k = tap_base + l * P + p;
        // __fmul_rn/__fsub_rn keep nvcc from contracting into an FMA, so the
        // tap position rounds exactly as the plain version's does
        float x = __fsub_rn(__fmul_rn(loc[k], Tf), 0.5f);
        x = fminf(fmaxf(x, 0.f), Tf - 1.f);
        const float fl = floorf(x);
        const float f = x - fl;
        const int i0 = static_cast<int>(fl);
        const int i1 = min(i0 + 1, T - 1);
        const float a = attn[k];
        const float w0 = a * (1.f - f);
        const float w1 = a * f;
        const float v0 = v_b[(lv.start[l] + i0) * row + c];
        const float v1 = v_b[(lv.start[l] + i1) * row + c];
        acc += w0 * v0 + w1 * v1;
      }
    }
    o[c] = acc;
  }
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths.
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int msda_fwd_f32(const float* value, const float* loc,
                            const float* attn, float* out, int B, int S,
                            int H, int Dh, int Lq, int L, int P,
                            const int* level_T, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  int start = 0;
  for (int l = 0; l < L; ++l) {
    lv.T[l] = level_T[l];
    lv.start[l] = start;
    start += level_T[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = static_cast<long long>(B) * Lq * H;
  if (warps == 0) return static_cast<int>(cudaSuccess);
  const int blocks =
      static_cast<int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      value, loc, attn, out, B, S, H, Dh, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}
