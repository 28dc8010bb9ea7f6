// What the banded forward and backward kernels share: the tiling of the
// queries, the band table, the tap of a (query, level, point), and the band
// start of a tile.
//
// Queries are tokens (one per value row). The queries of each level are cut
// into tiles of kTileQ consecutive queries from the level's start; the
// last tile of a level is short. One block works on one (b, h, tile). For
// each target level l the band of the tile starts at
//   s = 8 * floor(clamp(min i0 over the tile's taps into l, 0, Tp - BS) / 8)
// with Tp = T_l rounded up to a multiple of 8 and BS = band[query level][l],
// and every tap row is clamped to [s, s + BS - 1]. The TPU kernels pad each
// level with zero rows to Tp; no tap is read from them (s <= every i0 of the
// tile, so the clamp only lowers a row, and a tap row is at most T_l - 1),
// so Tp enters only through BS and the upper limit of s.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace msda_banded {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 512;
constexpr int kTileQ = 128;  // queries per tile: part of the function, as is
                             // the rounding of the band start to 8 rows
constexpr long long kSharedLimit = 48 * 1024;  // dynamic, without opting in

struct Geometry {
  int T[kMaxLevels];                  // level lengths
  int start[kMaxLevels];              // first value row (= query) of a level
  int tile0[kMaxLevels + 1];          // first tile of a query level
  int band[kMaxLevels][kMaxLevels];   // band size [query level][target level]
};

struct Tile {
  int b, h;      // batch and head
  int lq;        // query level
  int q_first;   // first query (= value row) of the tile
  int nq;        // queries in the tile
};

// Host: checks the sizes and fills `gm`. `level_T` holds L level lengths
// that sum to S, `band` L * L band sizes, row = query level.
inline cudaError_t make_geometry(int S, int L, int P, const int* level_T,
                                 const int* band, Geometry* gm) {
  if (L < 1 || L > kMaxLevels || P < 1) return cudaErrorInvalidValue;
  *gm = Geometry{};
  int start = 0, tiles = 0;
  for (int l = 0; l < L; ++l) {
    if (level_T[l] < 1) return cudaErrorInvalidValue;
    gm->T[l] = level_T[l];
    gm->start[l] = start;
    gm->tile0[l] = tiles;
    start += level_T[l];
    tiles += (level_T[l] + kTileQ - 1) / kTileQ;
  }
  gm->tile0[L] = tiles;
  if (start != S) return cudaErrorInvalidValue;
  for (int lq = 0; lq < L; ++lq)
    for (int l = 0; l < L; ++l) {
      const int bs = band[lq * L + l];
      if (bs < 1 || bs > (level_T[l] + 7) / 8 * 8) return cudaErrorInvalidValue;
      gm->band[lq][l] = bs;
    }
  return cudaSuccess;
}

// Host: the grid of a launch, one block per (b, h, tile); 0 blocks = nothing
// to do. `shared` is the dynamic shared memory one block takes.
inline cudaError_t plan_launch(const Geometry& gm, int B, int H, int L,
                               long long shared, int* blocks) {
  const long long n = static_cast<long long>(B) * H * gm.tile0[L];
  if (n > INT_MAX || shared > kSharedLimit) return cudaErrorInvalidValue;
  *blocks = static_cast<int>(n);
  return cudaSuccess;
}

__device__ inline Tile tile_of_block(const Geometry& gm, int L, int H) {
  const int n_tiles = gm.tile0[L];
  const int tile = blockIdx.x % n_tiles;
  const int bh = blockIdx.x / n_tiles;
  Tile t;
  t.h = bh % H;
  t.b = bh / H;
  t.lq = 0;
  while (tile >= gm.tile0[t.lq + 1]) ++t.lq;
  t.q_first = gm.start[t.lq] + (tile - gm.tile0[t.lq]) * kTileQ;
  t.nq = min(kTileQ, gm.start[t.lq] + gm.T[t.lq] - t.q_first);
  return t;
}

struct Tap {
  float x_raw;  // loc * T - 0.5, before the tap clamp
  float f;      // weight of the upper row
  int i0;       // lower row, level-local
};

// The tap of a sampling location into a level of T rows, as in
// ms_deform_attn_fwd.cu. __fmul_rn/__fsub_rn keep nvcc from contracting into
// an FMA, so the tap position, and with it the band start, rounds exactly as
// the plain version's does.
__device__ inline Tap tap_at(float loc, float Tf) {
  Tap t;
  t.x_raw = __fsub_rn(__fmul_rn(loc, Tf), 0.5f);
  const float x = fminf(fmaxf(t.x_raw, 0.f), Tf - 1.f);
  const float fl = floorf(x);
  t.f = x - fl;
  t.i0 = static_cast<int>(fl);
  return t;
}

// Lowers s_band[l] to i0. Every lane of the warp calls it together; a lane
// without a tap passes live = false, l = -1, i0 = INT_MAX. Lanes that hold
// the same level reduce among themselves, then one shared-memory atomicMin
// per group.
__device__ inline void lower_band_min(int* s_band, bool live, int l, int i0) {
  const unsigned peers = __match_any_sync(0xffffffffu, l);
  const int m = __reduce_min_sync(peers, i0);
  if (live && (threadIdx.x % 32) == __ffs(peers) - 1) atomicMin(&s_band[l], m);
}

// Turns the smallest i0 per target level in s_band into the band starts.
// Called by every thread of the block, between two __syncthreads().
__device__ inline void band_starts(int* s_band, const Geometry& gm, int lq,
                                   int L) {
  if (threadIdx.x < L) {
    const int l = threadIdx.x;
    const int Tp = (gm.T[l] + 7) / 8 * 8;
    const int s = min(max(s_band[l], 0), Tp - gm.band[lq][l]);
    s_band[l] = s / 8 * 8;
  }
}

}  // namespace msda_banded
