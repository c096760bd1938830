// Eq. 2 candidate refinement over the two-level (hierarchical) adjacency
// layout, for Hopper (sm_90a). Same result as bitmap_refine.cu on the
// dense bitmap of the same graph, for frontier values in [-1, V):
//
//   sacc[i]   = cand_summary[i] & AND_{p active} summary[min(f[i,p], V-1)]
//   out[i, w] = cand[i, w] & live(sacc[i], w / C)
//               & AND_{p active, f[i,p] < V} row(f[i,p])[w]
//
// where bit c of cand_summary[i] is set iff chunk c (words [c*C, c*C+C))
// of cand[i] has a nonzero word, and row(v) is vertex v's packed
// adjacency rebuilt from its stored chunks chunk_data[chunk_ptr[v] ..
// chunk_ptr[v+1]) at words chunk_id[k]*C. A frontier value past V - 1
// ANDs summary[V-1] and no chunk, as the reference's kernel does.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_refine.py
// (_make_refine_hier_kernel / _refine_rows_hier_call, public
// refine_bitmap_rows_hier) together with its jnp prelude
// summary_intersect. The Pallas version pages live chunks from HBM into
// VMEM through a ring of DMA copies and gets the summary intersection
// and its [F, W] word mask from about ten XLA ops before the call; none
// of that structure carries over.
//
// What bounds it on this card: bytes and chains of dependent reads. Per
// call it moves cand and out (F*W words each), frontier and active, each
// active position's summary row (SW words) and chunk_ptr pair, the
// chunk_id window of each position of a live row and the C words of each
// live stored chunk: 2.6 us of HBM traffic at the main-path shape (F 512,
// W 2048, SW 8, C 8), nearly all of it cand (read) and out (written). On
// top, each row is a chain frontier -> summary / chunk_ptr -> chunk_id ->
// chunk_data, and a block that waits on one link moves no bytes.
//
// Design: one block of 256 threads per output row; every read that one
// link of the chain allows is in flight at once, so a row pays four
// dependent round trips whatever its number of positions, and the links
// overlap the cand and out streams:
//   1. every warp reads the row's frontier and active lanes (two
//      positions a lane), and every thread issues its 16-byte loads of
//      cand behind them (a 2048-word row is two int4 a thread);
//   2. every warp issues both chunk_ptr words of all positions together
//      and numbers the walked positions (in range, with stored chunks) by
//      ballot and prefix popcount, with a warp prefix sum of their chunk
//      counts, into its own list: no atomics, no block barrier. Warp 0
//      also reads the positions' summary rows and ANDs them with a warp
//      reduction (the summary intersection);
//   3. (position, stored chunk, 4-word unit) of every walked position is
//      one flat index space; each thread issues the chunk_id reads of its
//      units, then stages its cand units in the shared row, storing at
//      once the units of out whose cand words are all zero. One block
//      barrier;
//   4. each thread stores as zeros its units of chunks dead in the
//      summary intersection while the chunk ids land;
//   5. each thread issues the 16-byte chunk_data reads of its live units
//      (chunk live in the intersection, cand not zero there) together. A
//      row with one walked position (the main path's common row) ANDs
//      each with the cand words in the shared row and stores it to out at
//      once. A row with more ANDs them into the shared row with
//      shared-memory atomicAnd (exact and order-free: bit-identical from
//      run to run) and, after a second barrier, stores its live words; a
//      row with none stores cand's live words.
// cand and out are read and written once a call and marked streaming
// (evict first), which keeps the layout's lanes in L2 for the chain.
// Shared memory is the row plus the summary intersection: (4 ceil(W/4) +
// SW) * 4 bytes, 8 KB at 64K vertices and 32 KB at 256K; past 48 KB the
// launch opts in, past the card's limit it refuses. Rows that are not
// 16-byte aligned (W % 4 != 0, or an offset view) and chunks narrower
// than 4 words take scalar loads and stores over the same units. The
// layout's summaries must match its store (a summary bit set iff the
// chunk is stored), as build_hier_bitmap makes them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // one block per output row
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPositions = 64;   // N_PAD of the engine
constexpr int kRowUnits = 2;        // cand units a thread loads in step 1
constexpr int kWalkUnits = 2;       // walk units a thread has in flight
constexpr int kSummaryBatch = 8;    // summary words a lane loads at once
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

// Words [0, min(n, 4)) of p, the rest 0: one 16-byte load when vec (p is
// 16-byte aligned and n >= 4). cand and out are read and written once,
// so their accesses are marked streaming (evict first): the layout's
// lanes stay in L2.
__device__ __forceinline__ int4 load_words(const int* __restrict__ p, int n,
                                           bool vec, bool stream) {
  if (vec) {
    return stream ? __ldcs(reinterpret_cast<const int4*>(p))
                  : __ldg(reinterpret_cast<const int4*>(p));
  }
  int4 x = make_int4(0, 0, 0, 0);
  if (n > 0) x.x = stream ? __ldcs(p) : __ldg(p);
  if (n > 1) x.y = stream ? __ldcs(p + 1) : __ldg(p + 1);
  if (n > 2) x.z = stream ? __ldcs(p + 2) : __ldg(p + 2);
  if (n > 3) x.w = stream ? __ldcs(p + 3) : __ldg(p + 3);
  return x;
}

__device__ __forceinline__ void store_words(int* p, int4 x, int n,
                                            bool vec) {
  if (vec) {
    __stcs(reinterpret_cast<int4*>(p), x);
    return;
  }
  if (n > 0) __stcs(p, x.x);
  if (n > 1) __stcs(p + 1, x.y);
  if (n > 2) __stcs(p + 2, x.z);
  if (n > 3) __stcs(p + 3, x.w);
}

__device__ __forceinline__ bool nonzero(int4 x) {
  return (x.x | x.y | x.z | x.w) != 0;
}

// Bit c of the positions' summary intersection.
__device__ __forceinline__ bool chunk_live(const unsigned* psum, int c) {
  return (psum[c >> 5] >> (c & 31)) & 1u;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The walked position of flat unit i: the last s with first[s] <= i
// (first[0] == 0, first strictly increasing over [0, n)).
__device__ __forceinline__ int locate(const int* first, int n, int i) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Step 3 for units i0, i0 + kThreads, ...: each unit's chunk_data unit
// index (k * units per chunk + unit in chunk; -1 past the walk) and its
// chunk id, the reads issued together.
__device__ __forceinline__ void fetch_ids(
    const int* __restrict__ chunk_id, const int* s_k0, const int* s_first,
    int n_walk, int n_units, int log2_upc, int i0, int (&unit)[kWalkUnits],
    int (&cid)[kWalkUnits]) {
#pragma unroll
  for (int j = 0; j < kWalkUnits; ++j) {
    const int i = i0 + j * kThreads;
    unit[j] = -1;
    cid[j] = 0;
    if (i < n_units) {
      const int s = locate(s_first, n_walk, i);
      const int off = i - s_first[s];
      const int k = s_k0[s] + (off >> log2_upc);
      unit[j] = (k << log2_upc) + (off & ((1 << log2_upc) - 1));
      cid[j] = __ldg(chunk_id + k);
    }
  }
}

// Step 5 for those units: the chunk_data reads of the live ones (chunk
// live in the summary intersection, cand not zero on the unit's 16
// bytes) issued together, then each ANDed into the shared row (kDirect
// false), or, for a row with one walked position, ANDed with the row's
// cand words and stored to out (kDirect true: no other position touches
// those words).
template <bool kDirect>
__device__ __forceinline__ void and_in(
    const int* __restrict__ chunk_data, const unsigned* psum, int* row,
    int* __restrict__ orow, int n_words, int log2_c, int log2_u,
    bool vec_chunks, bool vec_rows, const int (&unit)[kWalkUnits],
    const int (&cid)[kWalkUnits]) {
  const int u_words = 1 << log2_u;
  const int4* row4 = reinterpret_cast<const int4*>(row);
  int at[kWalkUnits];
  int4 d[kWalkUnits];
#pragma unroll
  for (int j = 0; j < kWalkUnits; ++j) {
    at[j] = -1;
    d[j] = make_int4(-1, -1, -1, -1);
    if (unit[j] >= 0 && chunk_live(psum, cid[j])) {
      const int in_chunk = unit[j] & ((1 << (log2_c - log2_u)) - 1);
      const int w = (cid[j] << log2_c) + (in_chunk << log2_u);
      if (w < n_words && nonzero(row4[w >> 2])) {
        at[j] = w;
        d[j] = load_words(chunk_data + ((long long)unit[j] << log2_u),
                          u_words, vec_chunks, false);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kWalkUnits; ++j) {
    if (at[j] < 0) continue;
    const int n = min(u_words, n_words - at[j]);
    int* r = row + at[j];
    if (kDirect) {
      int4 c = u_words == 4 ? row4[at[j] >> 2]
                            : make_int4(r[0], n > 1 ? r[1] : 0, 0, 0);
      c = make_int4(c.x & d[j].x, c.y & d[j].y, c.z & d[j].z, c.w & d[j].w);
      store_words(orow + at[j], c, n, vec_rows && u_words == 4);
    } else {
      atomicAnd(r, d[j].x);
      if (n > 1) atomicAnd(r + 1, d[j].y);
      if (n > 2) atomicAnd(r + 2, d[j].z);
      if (n > 3) atomicAnd(r + 3, d[j].w);
    }
  }
}

// Stores the words of unit u (values x) whose chunks are live (live
// true) or dead (live false: as zeros) in the summary intersection.
__device__ __forceinline__ void store_unit(
    const unsigned* psum, int4 x, int* __restrict__ orow, int u,
    int n_words, int log2_c, bool vec_rows, bool live) {
  const int w = 4 * u;
  if (!live) x = make_int4(0, 0, 0, 0);
  if (log2_c >= 2) {
    if (chunk_live(psum, w >> log2_c) == live) {
      store_words(orow + w, x, n_words - w, vec_rows);
    }
    return;
  }
  const int y[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w + j < n_words && chunk_live(psum, (w + j) >> log2_c) == live) {
      __stcs(orow + w + j, y[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) refine_rows_hier_kernel(
    const int* __restrict__ summary, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_id, const int* __restrict__ chunk_data,
    const int* __restrict__ cand, const int* __restrict__ frontier,
    const int* __restrict__ active, int* __restrict__ out,
    int n_vertices, int n_summary, int log2_c, int n_words,
    int n_positions, int vec_rows, int vec_chunks) {
  extern __shared__ int4 smem[];
  const int row_units = (n_words + 3) >> 2;
  int4* row4 = smem;                                        // [row_units]
  int* row = reinterpret_cast<int*>(smem);
  unsigned* psum = reinterpret_cast<unsigned*>(smem + row_units);
  __shared__ int s_k0[kWarps][kMaxPositions];         // first stored chunk
  __shared__ int s_first[kWarps][kMaxPositions];      // first flat unit

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base = (long long)blockIdx.x * n_words;
  const int* crow = cand + base;
  int* orow = out + base;
  // a walk unit is 4 words of a chunk (C >= 4) or the whole chunk
  const int log2_u = log2_c < 2 ? log2_c : 2;
  const int log2_upc = log2_c - log2_u;       // units per chunk, log2

  // Step 1: every warp reads the row's positions (two a lane), and every
  // thread's first cand units go out behind them.
  int v[2], k0[2], nk[2];
  bool on[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = lane + 32 * h;
    v[h] = 0;
    on[h] = false;
    if (p < n_positions) {
      const long long k = (long long)blockIdx.x * n_positions + p;
      v[h] = frontier[k];
      on[h] = active[k] != 0 && v[h] >= 0;
    }
  }
  int4 x[kRowUnits];
#pragma unroll
  for (int k = 0; k < kRowUnits; ++k) {
    const int u = tid + k * kThreads;
    x[k] = u < row_units ? load_words(crow + 4 * u, n_words - 4 * u,
                                      vec_rows, true)
                         : make_int4(0, 0, 0, 0);
  }
  // Step 2: each warp's chunk windows of the positions; warp 0 also
  // their summaries, ANDed by a warp reduction.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = on[h] && v[h] < n_vertices;
    k0[h] = in ? __ldg(chunk_ptr + v[h]) : 0;
    nk[h] = in ? __ldg(chunk_ptr + v[h] + 1) : 0;
    v[h] = min(v[h], n_vertices - 1);
  }
  if (warp == 0) {
    for (int s0 = 0; s0 < n_summary; s0 += kSummaryBatch) {
      unsigned acc[kSummaryBatch];
#pragma unroll
      for (int j = 0; j < kSummaryBatch; ++j) {
        acc[j] = ~0u;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (on[h] && s0 + j < n_summary) {
            acc[j] &= (unsigned)__ldg(
                summary + (long long)v[h] * n_summary + s0 + j);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kSummaryBatch; ++j) {
        const unsigned all = __reduce_and_sync(kFull, acc[j]);
        if (lane == 0 && s0 + j < n_summary) psum[s0 + j] = all;
      }
    }
  }
  // The walked positions (in range, with stored chunks) numbered by
  // ballot and prefix popcount, each with its first unit of the flat walk
  // (a warp prefix sum of the chunk counts), in the warp's own list.
  nk[0] = nk[0] - k0[0];
  nk[1] = nk[1] - k0[1];
  const unsigned m0 = __ballot_sync(kFull, nk[0] > 0);
  const unsigned m1 = __ballot_sync(kFull, nk[1] > 0);
  const unsigned below = (1u << lane) - 1;
  const int inc0 = warp_inclusive_sum(nk[0], lane);
  const int inc1 = warp_inclusive_sum(nk[1], lane)
                   + __shfl_sync(kFull, inc0, 31);
  const int n_walk = __popc(m0) + __popc(m1);
  const int n_units = __shfl_sync(kFull, inc1, 31) << log2_upc;
  int* w_k0 = s_k0[warp];
  int* w_first = s_first[warp];
  if (nk[0] > 0) {
    const int slot = __popc(m0 & below);
    w_k0[slot] = k0[0];
    w_first[slot] = (inc0 - nk[0]) << log2_upc;
  }
  if (nk[1] > 0) {
    const int slot = __popc(m0) + __popc(m1 & below);
    w_k0[slot] = k0[1];
    w_first[slot] = (inc1 - nk[1]) << log2_upc;
  }
  __syncwarp();

  // Step 3: the first walk units' chunk ids in flight ...
  int unit[kWalkUnits], cid[kWalkUnits];
  fetch_ids(chunk_id, w_k0, w_first, n_walk, n_units, log2_upc, tid, unit,
            cid);
  // ... while cand goes into the shared row; where its 16 bytes are zero,
  // so is out: those units go out now.
#pragma unroll
  for (int k = 0; k < kRowUnits; ++k) {
    const int u = tid + k * kThreads;
    if (u < row_units) {
      row4[u] = x[k];
      if (!nonzero(x[k])) {
        store_words(orow + 4 * u, x[k], n_words - 4 * u, vec_rows);
      }
    }
  }
#pragma unroll 4
  for (int u = tid + kRowUnits * kThreads; u < row_units; u += kThreads) {
    const int4 y = load_words(crow + 4 * u, n_words - 4 * u, vec_rows,
                              true);
    row4[u] = y;
    if (!nonzero(y)) store_words(orow + 4 * u, y, n_words - 4 * u, vec_rows);
  }
  __syncthreads();

  // Step 4: the words of chunks dead in the summary intersection go out
  // as zeros (each thread its own units) while the chunk ids land.
  for (int u = tid; u < row_units; u += kThreads) {
    if (nonzero(row4[u])) {
      store_unit(psum, row4[u], orow, u, n_words, log2_c, vec_rows, false);
    }
  }

  // Step 5: the live words. One walked position (the main path's common
  // row): its chunk words go straight to out. More: all their chunk
  // words ANDed into the shared row, then the row's live words out. None:
  // cand's live words out.
  if (n_walk == 1) {
    and_in<true>(chunk_data, psum, row, orow, n_words, log2_c, log2_u,
                 vec_chunks, vec_rows, unit, cid);
  } else if (n_walk > 1) {
    and_in<false>(chunk_data, psum, row, orow, n_words, log2_c, log2_u,
                  vec_chunks, vec_rows, unit, cid);
  }
  for (int i0 = tid + kWalkUnits * kThreads; i0 < n_units;
       i0 += kWalkUnits * kThreads) {
    fetch_ids(chunk_id, w_k0, w_first, n_walk, n_units, log2_upc, i0, unit,
              cid);
    if (n_walk == 1) {
      and_in<true>(chunk_data, psum, row, orow, n_words, log2_c, log2_u,
                   vec_chunks, vec_rows, unit, cid);
    } else {
      and_in<false>(chunk_data, psum, row, orow, n_words, log2_c, log2_u,
                    vec_chunks, vec_rows, unit, cid);
    }
  }
  if (n_walk == 1) return;
  if (n_walk > 1) __syncthreads();
  for (int u = tid; u < row_units; u += kThreads) {
    store_unit(psum, row4[u], orow, u, n_words, log2_c, vec_rows, true);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Largest dynamic shared memory a block of this kernel may opt in to on
// the current device, in bytes (< 0: a CUDA error code, negated).
extern "C" int refine_bitmap_rows_hier_max_smem() {
  int dev = 0, bytes = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&attr, refine_rows_hier_kernel);
  }
  if (err != cudaSuccess) return -(int)err;
  return bytes - (int)attr.sharedSizeBytes;
}

extern "C" int refine_bitmap_rows_hier_launch(
    const int* summary, const int* chunk_ptr, const int* chunk_id,
    const int* chunk_data, const int* cand, const int* frontier,
    const int* active, int* out, int n_vertices, int n_summary,
    int chunk_words, int n_words, int n_rows, int n_positions,
    void* stream) {
  int log2_c = 0;
  while ((1 << log2_c) < chunk_words) ++log2_c;
  if (n_positions > kMaxPositions || n_vertices < 1 || chunk_words < 1
      || chunk_words > 128 || (1 << log2_c) != chunk_words
      || (long long)n_summary * 32 * chunk_words < n_words) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_words == 0) return 0;
  const size_t smem =
      (size_t)(4 * ((n_words + 3) / 4) + n_summary) * sizeof(int);
  if (smem > (size_t)kDefaultSmem) {
    const int limit = refine_bitmap_rows_hier_max_smem();
    if (limit < 0) return -limit;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        refine_rows_hier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_rows = n_words % 4 == 0 && aligned16(cand) && aligned16(out);
  const int vec_chunks = chunk_words >= 4 && aligned16(chunk_data);
  refine_rows_hier_kernel<<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      summary, chunk_ptr, chunk_id, chunk_data, cand, frontier, active, out,
      n_vertices, n_summary, log2_c, n_words, n_positions, vec_rows,
      vec_chunks);
  return (int)cudaGetLastError();
}
