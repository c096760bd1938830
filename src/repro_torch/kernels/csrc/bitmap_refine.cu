// Eq. 2 candidate refinement over packed bitmaps, for Hopper (sm_90a).
//
//   out[i, w] = cand[i, w] & AND_{p : active[i,p] != 0 && frontier[i,p] >= 0}
//               adj[min(frontier[i,p], V - 1), w]
//
// Replaces the TPU kernel src/repro/kernels/bitmap_refine.py
// (_make_refine_kernel / _refine_rows_call, public refine_bitmap_rows).
// The Pallas version keeps the whole padded adjacency block in VMEM and
// walks (8, W_pad) row blocks with a sequential position loop; none of
// that layout carries over.
//
// What bounds it on this card: latency, not bytes. Per call it reads
// cand (F*W words), the adjacency rows of every active position and
// writes out (F*W words): 0.26 us of HBM traffic on the main path
// (human-like graph: V = 4674, W = 147, F = 512, NP = 64, about one
// active position a row), and the 2.7 MB adjacency can stay in the 50 MB
// L2 across calls. A row is a chain of two dependent reads, frontier ->
// adjacency rows, then the stores: the time is the launch, those two
// round trips and the stores' drain, as long as a row's loads are all in
// flight together.
//
// Design: a warp per output row, 2 rows a block, no block barrier.
//   1. The warp reads its 64 frontier and active lanes (two a lane), then
//      issues its 16-byte loads of cand behind them, and compacts the
//      active, clamped vertices with a ballot and a prefix popcount into
//      its own shared list.
//   2. The row is walked in tiles of 160 words on the 16-byte grid of
//      cand's addresses (the main path's rows take one tile). A lane
//      gathers words lane, lane + 32, ... of the tile with coalesced
//      4-byte loads, for 8 positions at a time (a loop over further
//      groups of 8), so a row of the main path (at most 7 positions for
//      8-vertex queries) has all its gathers in flight with its cand
//      loads before the first AND. The rows gathered start at any word
//      mod 4 of the grid, so they are not loaded as int4; the row is
//      L2-resident and the number of loads in flight, not their width,
//      sets the time.
//   3. The ANDed words go through the warp's shared tile, and each lane
//      ANDs one or two 16-byte units of it with its cand units and
//      stores them: a scalar head up to the first 16-byte boundary, an
//      int4 body and a scalar tail (cand and out must share their
//      address mod 16; otherwise all of it is scalar).
// frontier, active, cand and out are read or written once a call, so
// their accesses are marked streaming (evict first), which keeps the
// adjacency in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;                 // rows (warps) per block
constexpr int kThreads = 32 * kRows;
constexpr int kMaxPositions = 64;        // N_PAD of the engine
constexpr int kGroup = 8;                // positions gathered at once
constexpr int kSlots = 5;                // tile words a lane gathers
constexpr int kTile = 32 * kSlots;       // words of a tile
constexpr int kTileUnits = kTile / 4;    // 16-byte units of a tile
constexpr int kUnitSlots = (kTileUnits + 31) / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool inside(int w, int n) {
  return (unsigned)w < (unsigned)n;
}

// Words w .. w + 3 of the row at p, those in [0, n) (the rest 0): one
// 16-byte load when vec and all four are in.
__device__ __forceinline__ int4 load_unit(const int* __restrict__ p, int w,
                                          int n, bool vec) {
  if (vec && w >= 0 && w + 4 <= n) {
    return __ldcs(reinterpret_cast<const int4*>(p + w));
  }
  int4 x = make_int4(0, 0, 0, 0);
  if (inside(w, n)) x.x = __ldcs(p + w);
  if (inside(w + 1, n)) x.y = __ldcs(p + w + 1);
  if (inside(w + 2, n)) x.z = __ldcs(p + w + 2);
  if (inside(w + 3, n)) x.w = __ldcs(p + w + 3);
  return x;
}

__device__ __forceinline__ void store_unit(int* p, int w, int n, bool vec,
                                           int4 x) {
  if (vec && w >= 0 && w + 4 <= n) {
    __stcs(reinterpret_cast<int4*>(p + w), x);
    return;
  }
  if (inside(w, n)) __stcs(p + w, x.x);
  if (inside(w + 1, n)) __stcs(p + w + 1, x.y);
  if (inside(w + 2, n)) __stcs(p + w + 2, x.z);
  if (inside(w + 3, n)) __stcs(p + w + 3, x.w);
}

__global__ void __launch_bounds__(kThreads) refine_rows_kernel(
    const int* __restrict__ adj, const int* __restrict__ cand,
    const int* __restrict__ frontier, const int* __restrict__ active,
    int* __restrict__ out, int n_vertices, int n_words, int n_rows,
    int n_positions, int vec) {
  __shared__ int s_verts[kRows][kMaxPositions];
  __shared__ __align__(16) int s_tile[kRows][kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  if (row >= n_rows) return;
  const long long base = (long long)row * n_words;
  const int* crow = cand + base;
  int* orow = out + base;
  // Tiles start on the 16-byte grid of cand's addresses: the first one
  // `lead` words before the row.
  const int lead =
      vec ? (int)((reinterpret_cast<uintptr_t>(crow) >> 2) & 3) : 0;
  int t0 = -lead;

  // 1. the row's positions, then cand's first tile in flight behind
  // them, then the positions compacted.
  int* verts = s_verts[warp];
  bool on[2];
  int v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
    on[h] = false;
    v[h] = 0;
    if (p < n_positions) {
      const long long k = (long long)row * n_positions + p;
      const int f = __ldcs(frontier + k);
      on[h] = __ldcs(active + k) != 0 && f >= 0;
      v[h] = min(f, n_vertices - 1);
    }
  }
  int4 c[kUnitSlots];
#pragma unroll
  for (int k = 0; k < kUnitSlots; ++k) {
    const int q = lane + 32 * k;
    c[k] = q < kTileUnits ? load_unit(crow, t0 + 4 * q, n_words, vec)
                          : make_int4(0, 0, 0, 0);
  }
  const unsigned m0 = __ballot_sync(kFull, on[0]);
  const unsigned m1 = __ballot_sync(kFull, on[1]);
  const unsigned below = (1u << lane) - 1;
  if (on[0]) verts[__popc(m0 & below)] = v[0];
  if (on[1]) verts[__popc(m0) + __popc(m1 & below)] = v[1];
  const int na = __popc(m0) + __popc(m1);
  __syncwarp();

  int* tile = s_tile[warp];
  while (true) {
    // 2. the tile's gathers, 8 positions at a time.
    int acc[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) acc[j] = -1;
    for (int g = 0; g < na; g += kGroup) {
      int x[kGroup][kSlots];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const bool use = g + i < na;
        const int* src = adj + (long long)(use ? verts[g + i] : 0) * n_words;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int w = t0 + lane + 32 * j;
          x[i][j] = use && inside(w, n_words) ? __ldg(src + w) : -1;
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
#pragma unroll
        for (int j = 0; j < kSlots; ++j) acc[j] &= x[i][j];
      }
    }
    // 3. through the shared tile into 16-byte units, ANDed with cand.
#pragma unroll
    for (int j = 0; j < kSlots; ++j) tile[lane + 32 * j] = acc[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kUnitSlots; ++k) {
      const int q = lane + 32 * k;
      if (q < kTileUnits) {
        const int4 a = *reinterpret_cast<const int4*>(tile + 4 * q);
        const int4 r = make_int4(c[k].x & a.x, c[k].y & a.y, c[k].z & a.z,
                                 c[k].w & a.w);
        store_unit(orow, t0 + 4 * q, n_words, vec, r);
      }
    }
    t0 += kTile;
    if (t0 >= n_words) break;
    __syncwarp();                 // the tile is read before it is reused
#pragma unroll
    for (int k = 0; k < kUnitSlots; ++k) {
      const int q = lane + 32 * k;
      c[k] = q < kTileUnits ? load_unit(crow, t0 + 4 * q, n_words, vec)
                            : make_int4(0, 0, 0, 0);
    }
  }
}

}  // namespace

extern "C" int refine_bitmap_rows_launch(const int* adj, const int* cand,
                                         const int* frontier,
                                         const int* active, int* out,
                                         int n_vertices, int n_words,
                                         int n_rows, int n_positions,
                                         void* stream) {
  if (n_positions > kMaxPositions || n_vertices < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_words == 0) return 0;
  // cand and out share their 16-byte grid: int4 units line up in both
  const int vec = ((reinterpret_cast<uintptr_t>(cand)
                    ^ reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  refine_rows_kernel<<<(n_rows + kRows - 1) / kRows, kThreads, 0,
                       (cudaStream_t)stream>>>(
      adj, cand, frontier, active, out, n_vertices, n_words, n_rows,
      n_positions, vec);
  return (int)cudaGetLastError();
}
