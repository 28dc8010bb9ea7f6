// What the banded forward and backward kernels share beyond
// ms_deform_attn_common.cuh: the tiling of the queries, the band table, the
// band start of a tile and the clamp of a tap's rows to it.
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

#include "ms_deform_attn_common.cuh"

namespace msda_banded {

using namespace msda;

constexpr int kTileQ = 128;  // queries per tile: part of the function, as is
                             // the rounding of the band start to 8 rows

struct Geometry {
  int T[kMaxLevels];                  // level lengths
  int start[kMaxLevels];              // first value row (= query) of a level
  int tile0[kMaxLevels + 1];          // first tile of a query level
  int band[kMaxLevels][kMaxLevels];   // band size [query level][target level]
  int base[kMaxLevels][kMaxLevels + 1];
  // backward only: the bands of a tile numbered through, base[query level][l]
  // the number of level l's first band row, base[query level][L] their count
};

struct Tile {
  int b, h;      // batch and head
  int lq;        // query level
  int q_first;   // first query (= value row) of the tile
  int nq;        // queries in the tile
};

// Host: checks the sizes and fills `gm`. `level_T` holds L level lengths
// that sum to S, `band` L * L band sizes, row = query level, `band_base`
// L * (L + 1) running sums of the rows of `band` (null in the forward). Row
// offsets inside one batch element are kept in 32 bits.
inline cudaError_t make_geometry(int S, int H, int Dh, int L, int P,
                                 const int* level_T, const int* band,
                                 const int* band_base, Geometry* gm) {
  if (L < 1 || L > kMaxLevels || P < 1 || L * P > kThreads)
    return cudaErrorInvalidValue;
  if (Dh < 4 || Dh % 4 != 0 || Dh > 64 * kBandedMaxVec)
    return cudaErrorInvalidValue;
  if (static_cast<long long>(S) * H * Dh > INT_MAX)
    return cudaErrorInvalidValue;
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
  if (band_base == nullptr) return cudaSuccess;
  for (int lq = 0; lq < L; ++lq) {
    const int* base = band_base + lq * (L + 1);
    if (base[0] != 0) return cudaErrorInvalidValue;
    for (int l = 0; l < L; ++l)
      if (base[l + 1] - base[l] != gm->band[lq][l])
        return cudaErrorInvalidValue;
    for (int l = 0; l <= L; ++l) gm->base[lq][l] = base[l];
  }
  return cudaSuccess;
}

// Host: the grid of a launch, one block per (b, h, tile); 0 blocks = nothing
// to do. `shared` is the dynamic shared memory the caller plans for one
// block, `needed` what the kernel uses; above 48 KB `kernel` is opted in.
template <typename KernelT>
inline cudaError_t plan_launch(const Geometry& gm, int B, int H, int L,
                               long long shared, long long needed,
                               KernelT kernel, int* blocks) {
  const long long n = static_cast<long long>(B) * H * gm.tile0[L];
  if (n > INT_MAX || shared < needed) return cudaErrorInvalidValue;
  *blocks = static_cast<int>(n);
  return allow_shared(kernel, shared);
}

// The tile of a block. Blocks are handed out in the order of blockIdx.x, so
// the tile is the slow index and runs backwards: the coarse query levels,
// whose bands are the longest, start first.
__device__ inline Tile tile_of_block(const Geometry& gm, int L, int H) {
  const int n_tiles = gm.tile0[L];
  const int n_bh = gridDim.x / n_tiles;
  const int tile = n_tiles - 1 - blockIdx.x / n_bh;
  const int bh = blockIdx.x % n_bh;
  Tile t;
  t.h = bh % H;
  t.b = bh / H;
  t.lq = 0;
  while (tile >= gm.tile0[t.lq + 1]) ++t.lq;
  t.q_first = gm.start[t.lq] + (tile - gm.tile0[t.lq]) * kTileQ;
  t.nq = min(kTileQ, gm.start[t.lq] + gm.T[t.lq] - t.q_first);
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

// Replaces the lower tap row i0 that phase A left in s_row[idx].x by the two
// band-clamped rows of the tap, as value rows of the batch element (the
// level's first row added) times `scale`: 1 keeps rows, the stride of a
// value row makes them offsets in floats. Every thread calls it for the taps
// it prepared in phase A, after band_starts and a __syncthreads(); the caller
// synchronises again before other threads read the rows.
__device__ inline void clamp_rows_to_band(int2* s_row, const int* s_band,
                                          const Geometry& gm, int lq,
                                          const TapOwner& me, int nq, int K,
                                          int scale) {
  if (!me.live) return;
  const int T = gm.T[me.l];
  const int s = s_band[me.l];
  const int hi = s + gm.band[lq][me.l] - 1;
  const int first = gm.start[me.l];
  for (int q = me.q0; q < nq; q += me.q_step) {
    const int i0 = s_row[q * K + me.k].x;
    s_row[q * K + me.k] =
        make_int2((first + min(max(i0, s), hi)) * scale,
                  (first + min(max(min(i0 + 1, T - 1), s), hi)) * scale);
  }
}

}  // namespace msda_banded
