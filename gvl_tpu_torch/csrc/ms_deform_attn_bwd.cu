// 1-D multi-scale deformable attention, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gvl_tpu/ops/ms_deform_attn.py::_bwd_kernel_full.
// That kernel rebuilds the (S, 128) interpolation matrix W per query tile,
// accumulates dV = W . dOut over the sequential tile grid, and returns the
// per-tap dw0/dw1 so that autodiff carries them through the tap preparation.
// Here the taps are gathered directly, as in the forward, and the tap
// preparation's derivative is folded into the kernel: it returns the
// gradients of value, loc and attn themselves.
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
// What bounds it: memory, not FLOPs. At the flagship encoder shape (B=16,
// S=Lq=188, H=8, Dh=64, L=P=4) it reads value and dOut (6.2 MB each) and
// loc/attn (3.1 MB) and writes grad_value (6.2 MB) and grad_loc/grad_attn
// (3.1 MB), for ~150 MFLOP.
//
// Design: one warp per (b, q, h), lanes over the Dh channels, mirroring the
// forward. A warp-shuffle reduction gives d0/d1 per tap and lane 0 writes
// grad_loc/grad_attn, each exactly once. grad_value is a scatter with
// data-dependent rows: f32 atomicAdd into a buffer the wrapper zeroes on the
// same stream. The order in which the atomics of different warps land is
// not fixed, so grad_value's sums vary in the last bits from run to run.
// `grad_value` may be null: then nothing is scattered.
//
// Layouts (all contiguous f32): value, grad_value (B, S, H, Dh); loc, attn,
// grad_loc, grad_attn (B, Lq, H, L, P); grad_out (B, Lq, H * Dh).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarpsPerBlock = 8;

struct Levels {
  int T[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void msda_bwd_kernel(const float* __restrict__ grad_out,
                                const float* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                float* __restrict__ grad_value,
                                float* __restrict__ grad_loc,
                                float* __restrict__ grad_attn, int B, int S,
                                int H, int Dh, int Lq, int L, int P,
                                Levels lv) {
  const int warp = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= B * Lq * H) return;  // whole warps leave together
  const int h = warp % H;
  const int b = warp / (Lq * H);

  const long long tap_base = static_cast<long long>(warp) * L * P;
  const long long v_off = static_cast<long long>(b) * S * H * Dh +
                          static_cast<long long>(h) * Dh;
  const float* v_b = value + v_off;
  float* gv_b = grad_value ? grad_value + v_off : nullptr;
  const long long row = static_cast<long long>(H) * Dh;  // stride of one s
  const float* go = grad_out + static_cast<long long>(warp) * Dh;

  for (int l = 0; l < L; ++l) {
    const int T = lv.T[l];
    const float Tf = static_cast<float>(T);
    for (int p = 0; p < P; ++p) {
      const long long k = tap_base + l * P + p;
      // the tap position rounds exactly as in the forward kernel and in the
      // plain version: no FMA contraction
      const float xr = __fsub_rn(__fmul_rn(loc[k], Tf), 0.5f);
      const float x = fminf(fmaxf(xr, 0.f), Tf - 1.f);
      const float fl = floorf(x);
      const float f = x - fl;
      const int i0 = static_cast<int>(fl);
      const int i1 = min(i0 + 1, T - 1);
      const float a = attn[k];
      const float w0 = a * (1.f - f);
      const float w1 = a * f;
      const long long r0 = (lv.start[l] + i0) * row;
      const long long r1 = (lv.start[l] + i1) * row;

      float d0 = 0.f, d1 = 0.f;
      for (int c = lane; c < Dh; c += 32) {
        const float g = go[c];
        d0 += v_b[r0 + c] * g;
        d1 += v_b[r1 + c] * g;
        if (gv_b) {
          atomicAdd(gv_b + r0 + c, w0 * g);
          atomicAdd(gv_b + r1 + c, w1 * g);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      }
      if (lane == 0) {
        grad_attn[k] = (1.f - f) * d0 + f * d1;
        const bool inside = xr > 0.f && xr < Tf - 1.f;
        grad_loc[k] = inside ? a * Tf * (d1 - d0) : 0.f;
      }
    }
  }
}

}  // namespace

// Plain C entry for ctypes. `level_T` is a host array of L level lengths.
// `grad_value` must be zeroed on `stream` before the call, or be null when
// the gradient of value is not wanted. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int msda_bwd_f32(const float* grad_out, const float* value,
                            const float* loc, const float* attn,
                            float* grad_value, float* grad_loc,
                            float* grad_attn, int B, int S, int H, int Dh,
                            int Lq, int L, int P, const int* level_T,
                            void* stream) {
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
  msda_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      grad_out, value, loc, attn, grad_value, grad_loc, grad_attn, B, S, H,
      Dh, Lq, L, P, lv);
  return static_cast<int>(cudaGetLastError());
}
