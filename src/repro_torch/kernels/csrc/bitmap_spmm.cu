// Packed-bitmap SpMM for Hopper (sm_90a):
//
//   out[i, :] = sum_{j : bit j of row i is set} x[j, :]
//
// where row i of the 0/1 matrix A [N, M] is given as W = M / 32 packed
// words (bit b of word w is column 32 w + b), x is [M, D] in f32 or bf16,
// and out is [N, D] in x's type, summed in f32.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_spmm.py (_spmm_kernel,
// public bitmap_spmm). The Pallas version unpacks a whole (Bi, Bj) bit
// tile to a 0/1 matrix and contracts it on the MXU, block by block: the
// work is N * M * D whatever the density. The inputs this repo has are
// very sparse (the matcher's human-like adjacency is ~0.8 % ones, the
// 65536-vertex scale graph ~0.01 %), so this kernel gathers the x rows
// of the set bits instead and does nnz * D additions.
//
// What bounds it on this card: bytes. Per call it streams the N * W
// words once from HBM and writes out; the x rows of the set columns are
// gathered nnz times, mostly from L2 (nnz * D * element size of L2
// traffic, the floor where the bitmap is small). Two things keep a
// kernel from those rates: a row's set bits walked one dependent x load
// at a time (the human-like graph's 408-bit hub row would set the whole
// time), and too few of a long row's words in flight.
//
// Three routes, picked by bitmap_spmm.plan from the shape:
//
// split (D <= 128 on rows of up to 512 words; one block of kSplitWarps
// warps per (row, 128-column tile)):
//   1. Scan. The row is read in passes of 512 words, one 16-byte load a
//      lane (ld.global.cs, evict-first, so the bitmap stream does not
//      push the gathered x rows out of L2; scalar loads where the row is
//      not 16-byte aligned): one pass covers a row the route is planned
//      for, longer rows take several.
//   2. Compact. Each warp counts its words' set bits (a warp reduction),
//      one barrier gives every warp its offset, and each lane writes the
//      column indices of its set bits into a shared list in ascending
//      column order (a warp scan; a warp without a set bit skips it by a
//      ballot). The list holds 1024
//      entries; a pass with more set bits is taken in windows of 1024.
//   3. Gather. Each window's list is cut into kSplitWarps slices of
//      ceil(n / kSplitWarps) entries, one per warp: a hub row's x loads
//      run on every warp at once. A warp walks its slice kBatch x rows
//      at a time, all loads of a batch issued before any add; each lane
//      owns 4 adjacent columns (one 16- or 8-byte load where x is
//      aligned).
//   4. Combine. Warp 0 folds in the other warps' (sum, error) pairs in
//      warp order (TwoSum on the sums, the errors added).
//
// stream (D <= 128 on longer rows, where reading the row takes the time:
// the 65536-vertex graph's rows are 8 KB with ~6 set bits; a warp per
// row, four rows a block, no block barrier):
//   the row goes through a ring of kStages passes of 2 KB in shared
//   memory, filled by cp.async (16-byte copies, L1 bypassed, marked
//   evict-first in L2), so that three passes are in flight while one is
//   scanned; each pass is compacted and gathered as on the split route,
//   the list in windows of 256 entries per warp, the row's x loads 8 (f32)
//   or 4 (bf16) at a time. Loads into registers (the split layout) held
//   the stream well below the HBM rate: the words held in registers limit
//   the warps, and each warp waits on its own pass.
//
// wide (D > 128; one block of 128 threads per (row, 512-column tile)):
//   the row's nonzero words are compacted into shared memory 128 at a
//   time (one coalesced word a thread, warp ballots and a prefix over the
//   warps), and the whole block walks their set bits, lowest first, one
//   x row at a time; thread t owns columns t + 128 c of the tile. This is
//   the first version's layout, kept for wide D: on the Cora-shaped case
//   (D 1433, ~4 set bits a row) it was faster on an H100 than the split
//   layout spread over column tiles, and than a batched walk of the bits.
//
// x is read with plain loads: the read-only path (ld.global.nc) made the
// wide route's scalar gathers markedly slower.
//
// The output is written with streaming stores where aligned.
//
// Every f32 sum carries its rounding error in a second register (Knuth's
// TwoSum): two f32 summation orders of a hub row differ past the
// reference's 1e-5, so each partial sum is a (sum, error) pair. Every
// order above is fixed by the data alone — no atomics, nothing that
// depends on timing — so every result bit is the same on every run, and
// ref.bitmap_spmm_split_ref reproduces it on the CPU (stream and wide sum
// each row in one sequence, ascending). No tensor cores and no TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplitWarps = 4;         // split: warps per block, a slice each
                                       // of the list
constexpr int kSplitPass = 128 * kSplitWarps;   // split: words per pass
constexpr int kWindow = 1024;          // split: list entries at a time
constexpr int kVec = 4;                // columns a thread owns
constexpr int kTileCols = 32 * kVec;   // split: columns a warp owns
constexpr int kWideThreads = 128;      // wide: threads per block
constexpr int kWideCols = kWideThreads * kVec;   // wide: columns per block
constexpr int kBatch = 4;              // split: x-row loads before the adds
constexpr unsigned kFull = 0xffffffffu;

// s + x into s, its rounding error into err (TwoSum: exact for any
// order of magnitude of s and x; no products, so nothing to contract).
__device__ __forceinline__ void two_sum(float& s, float& err, float x) {
  const float t = s + x;
  const float xp = t - s;
  err += (s - (t - xp)) + (x - xp);
  s = t;
}

__device__ __forceinline__ float bf16_lo(unsigned v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned v) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));   // round to nearest even
}

// Four adjacent values at p (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void load4(const float* p, float v[kVec]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[kVec]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
  v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_lo(*reinterpret_cast<const unsigned short*>(p));
}
// Streaming (evict-first) stores: out is written once, and x should keep
// the L2.
__device__ __forceinline__ void store4(float* p, const float v[kVec]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[kVec]) {
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                    bf16_bits(v[2]) | (bf16_bits(v[3]) << 16)));
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The thread's kVec columns of one x row: adjacent from col_base
// (kVecX), else col_base + col_step c. Every load is made — a column
// past n_cols reads the last one, never stored — so that no branch keeps
// the compiler from issuing a batch's loads before its adds.
template <typename T, bool kVecX>
__device__ __forceinline__ void load_cols(const T* __restrict__ xrow,
                                          int col_base, int col_step,
                                          int n_cols, float v[kVec]) {
  if (kVecX) {
    load4(xrow + min(col_base, n_cols - kVec), v);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      v[c] = load1(xrow + min(col_base + col_step * c, n_cols - 1));
  }
}

template <typename T, bool kVecX>
__device__ __forceinline__ void store_cols(T* __restrict__ orow,
                                           int col_base, int col_step,
                                           int n_cols, const float s[kVec],
                                           const float e[kVec]) {
  float v[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) v[c] = s[c] + e[c];
  if (kVecX) {
    if (col_base < n_cols) store4(orow + col_base, v);
  } else {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int col = col_base + col_step * c;
      if (col < n_cols) store1(orow + col, v[c]);
    }
  }
}

// Adds the x rows of js[0..kB) to (s, e), all loads first; an entry
// past `live` loads js[0] again and adds +0, which changes no bit of a
// TwoSum pair (s is never -0).
template <typename T, bool kVecX, int kB>
__device__ __forceinline__ void add_batch(const int js[kB], int live,
                                          const T* __restrict__ x,
                                          int n_cols, int col_base,
                                          int col_step, float s[kVec],
                                          float e[kVec]) {
  float v[kB][kVec];
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int j = u < live ? js[u] : js[0];   // a select, not an index
    load_cols<T, kVecX>(x + (long long)j * n_cols, col_base, col_step,
                        n_cols, v[u]);
  }
#pragma unroll
  for (int u = 0; u < kB; ++u) {
#pragma unroll
    for (int c = 0; c < kVec; ++c)
      two_sum(s[c], e[c], u < live ? v[u][c] : 0.f);
  }
}

// ---------------------------------------------------------------- split
// The lane's 4 words of the warp's 128 from `first` (one evict-first
// vector load where the row is 16-byte aligned) and their set bits;
// words past the row read 0.
__device__ __forceinline__ void load_words(const unsigned* __restrict__ row,
                                           int first, int lane, int n_words,
                                           int vec_words, unsigned w[1][4],
                                           int cnt[1]) {
  const int w0 = first + 4 * lane;
  if (vec_words) {
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (w0 < n_words) q = __ldcs(reinterpret_cast<const uint4*>(row + w0));
    w[0][0] = q.x; w[0][1] = q.y; w[0][2] = q.z; w[0][3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[0][k] = w0 + k < n_words ? row[w0 + k] : 0u;
  }
  cnt[0] = __popc(w[0][0]) + __popc(w[0][1]) + __popc(w[0][2]) +
           __popc(w[0][3]);
}

// The column indices of the set bits of the warp's words (unit r of
// lane l holds words first + 4 (32 r + l) ..) that fall at positions
// [win, win + kW) of the list, the warp's first bit at position `pos`,
// into list[position - win], in ascending column order: a warp scan per
// round of units; rounds without a set bit are skipped by a ballot.
template <int kW, int kU>
__device__ __forceinline__ void write_list(const unsigned w[kU][4],
                                           const int cnt[kU], int first,
                                           int lane, int pos, int win,
                                           int* list) {
#pragma unroll
  for (int r = 0; r < kU; ++r) {
    if (__ballot_sync(kFull, cnt[r] != 0) == 0u) continue;
    int incl = cnt[r];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int q = pos + incl - cnt[r];
    pos += __shfl_sync(kFull, incl, 31);
    if (q < win + kW && q + cnt[r] > win) {
      const int word0 = first + 4 * (32 * r + lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned bits = w[r][k];
        while (bits != 0u) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          if (q >= win && q < win + kW) list[q - win] = 32 * (word0 + k) + b;
          ++q;
        }
      }
    }
  }
}

template <typename T, bool kVecX>
__global__ void __launch_bounds__(kSplitWarps * 32, 8)
split_kernel(const unsigned* __restrict__ words, const T* __restrict__ x,
             T* __restrict__ out, int n_words, int n_cols, int vec_words) {
  __shared__ int list[kWindow];
  __shared__ int warp_bits[2][kSplitWarps];
  __shared__ float part[kSplitWarps - 1][2][kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the lane's columns: 4 adjacent (kVecX), else lane + 32 c
  const int col_base = blockIdx.y * kTileCols + (kVecX ? kVec * lane : lane);
  const int col_step = 32;
  const unsigned* row = words + (long long)blockIdx.x * n_words;
  float s[kVec], e[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) s[c] = e[c] = 0.f;

  int parity = 0;
  for (int p0 = 0; p0 < n_words; p0 += kSplitPass, parity ^= 1) {
    // 1. the pass's words, one load a lane
    const int first = p0 + 128 * warp;
    unsigned w[1][4];
    int cnt[1];
    load_words(row, first, lane, n_words, vec_words, w, cnt);
    // 2. set bits per warp, then each warp's offset in the pass's list
    const int warp_total = (int)__reduce_add_sync(kFull, (unsigned)cnt[0]);
    if (lane == 0) warp_bits[parity][warp] = warp_total;
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int k = 0; k < kSplitWarps; ++k) {
      const int b = warp_bits[parity][k];
      base += k < warp ? b : 0;
      n += b;
    }
    const bool last_pass = p0 + kSplitPass >= n_words;
    // 3. the list a window at a time: compact, slice, gather
    for (int win = 0; win < n; win += kWindow) {
      // a later window loads the words again (from L2), so that they
      // are not held in registers across the gather
      if (win > 0)
        load_words(row, first, lane, n_words, vec_words, w, cnt);
      write_list<kWindow, 1>(w, cnt, first, lane, base, win, list);
      __syncthreads();
      const int n_win = min(kWindow, n - win);
      const int len = (n_win + kSplitWarps - 1) / kSplitWarps;
      const int lo = min(n_win, warp * len);
      const int hi = min(n_win, lo + len);
      for (int k = lo; k < hi; k += kBatch) {
        int js[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) js[u] = list[min(k + u, hi - 1)];
        add_batch<T, kVecX, kBatch>(js, hi - k, x, n_cols, col_base, col_step,
                                    s, e);
      }
      if (!(last_pass && win + kWindow >= n)) __syncthreads();
    }
  }

  // 4. fold warps 1.. into warp 0, in warp order
  if (warp > 0) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      part[warp - 1][0][32 * c + lane] = s[c];
      part[warp - 1][1][32 * c + lane] = e[c];
    }
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int k = 1; k < kSplitWarps; ++k) {
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      two_sum(s[c], e[c], part[k - 1][0][32 * c + lane]);
      e[c] += part[k - 1][1][32 * c + lane];
    }
  }
  store_cols<T, kVecX>(out + (long long)blockIdx.x * n_cols, col_base,
                       col_step, n_cols, s, e);
}

// ---------------------------------------------------------------- stream
constexpr int kStreamWarps = 4;        // stream: rows per block, a warp each
constexpr int kStages = 4;             // stream: passes in flight per warp
constexpr int kStreamUnits = 4;        // stream: 16-byte units a lane copies
constexpr int kPassWords = 128 * kStreamUnits;   // stream: words per pass
constexpr int kStreamWindow = 256;     // stream: list entries a warp holds

// Pass p of the row into its ring slot: the lane's kStreamUnits 16-byte
// units (words p kPassWords + 4 (32 r + lane) ..), by cp.async — 16-byte
// copies that keep L1 out and are marked evict-first in L2 (`policy`)
// where the row is aligned, else word by word. One commit group per
// call, empty past the row, so that wait_group counts passes.
__device__ __forceinline__ void issue_pass(uint4 (*slot)[32],
                                           const unsigned* row, int p,
                                           int lane, int n_words,
                                           int vec_words,
                                           unsigned long long policy) {
#pragma unroll
  for (int r = 0; r < kStreamUnits; ++r) {
    const int w0 = p * kPassWords + 4 * (32 * r + lane);
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(&slot[r][lane]));
    if (vec_words) {
      if (w0 < n_words) {
        asm volatile(
            "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
            :: "r"(dst), "l"(row + w0), "l"(policy) : "memory");
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (w0 + k < n_words) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                       :: "r"(dst + 4 * k), "l"(row + w0 + k) : "memory");
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The lane's own units of a landed pass (it copied them itself, so no
// other lane's wait is needed), words past the row as 0, and their bits.
__device__ __forceinline__ void read_pass(uint4 (*slot)[32], int p,
                                          int lane, int n_words,
                                          unsigned w[kStreamUnits][4],
                                          int cnt[kStreamUnits]) {
#pragma unroll
  for (int r = 0; r < kStreamUnits; ++r) {
    const uint4 q = slot[r][lane];
    const int w0 = p * kPassWords + 4 * (32 * r + lane);
    w[r][0] = w0 < n_words ? q.x : 0u;
    w[r][1] = w0 + 1 < n_words ? q.y : 0u;
    w[r][2] = w0 + 2 < n_words ? q.z : 0u;
    w[r][3] = w0 + 3 < n_words ? q.w : 0u;
    cnt[r] = __popc(w[r][0]) + __popc(w[r][1]) + __popc(w[r][2]) +
             __popc(w[r][3]);
  }
}

// Shared memory sets six blocks an SM (36 KB each: the ring 32 KB, the
// lists 4 KB; 1 KB reserved; 228 KB an SM) while a thread holds at most
// 85 registers. The cap of 72 is not for occupancy: on an H100 it measured
// faster on the 65536-vertex graph in f32 than the 80 that a six-block
// launch bound gives and than no bound (78-96); of the four builds only
// the unaligned bf16 one spills, 8 bytes.
template <typename T, bool kVecX>
__global__ void __maxnreg__(72)
stream_kernel(const unsigned* __restrict__ words, const T* __restrict__ x,
              T* __restrict__ out, int n_rows, int n_words, int n_cols,
              int vec_words) {
  __shared__ uint4 ring[kStreamWarps][kStages][kStreamUnits][32];
  __shared__ int lists[kStreamWarps][kStreamWindow];
  // x-row loads issued before their adds: a hub row is one warp's
  // sequence here, and in f32 8 in flight walked it faster than 4
  constexpr int kStreamBatch = sizeof(T) == 4 ? 8 : 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row_index = blockIdx.x * kStreamWarps + warp;
  if (row_index >= n_rows) return;     // no block barrier below
  const int col_base = blockIdx.y * kTileCols + (kVecX ? kVec * lane : lane);
  const unsigned* row = words + (long long)row_index * n_words;
  uint4 (*const slots)[kStreamUnits][32] = ring[warp];
  int* list = lists[warp];
  float s[kVec], e[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) s[c] = e[c] = 0.f;

  // the bitmap streams through L2 once: evict it first, so that the
  // gathered x rows stay
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  const int n_pass = (n_words + kPassWords - 1) / kPassWords;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    issue_pass(slots[p], row, p, lane, n_words, vec_words, policy);
  for (int p = 0; p < n_pass; ++p) {
    // the slot refilled here was read (and its words used) last pass
    const int ahead = p + kStages - 1;
    issue_pass(slots[ahead % kStages], row, ahead, lane, n_words, vec_words,
               policy);
    asm volatile("cp.async.wait_group %0;" :: "n"(kStages - 1) : "memory");
    unsigned w[kStreamUnits][4];
    int cnt[kStreamUnits];
    read_pass(slots[p % kStages], p, lane, n_words, w, cnt);
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kStreamUnits; ++r) mine += cnt[r];
    const int n = (int)__reduce_add_sync(kFull, (unsigned)mine);
    for (int win = 0; win < n; win += kStreamWindow) {
      if (win > 0) read_pass(slots[p % kStages], p, lane, n_words, w, cnt);
      write_list<kStreamWindow, kStreamUnits>(w, cnt, p * kPassWords, lane, 0,
                                              win, list);
      __syncwarp();
      const int hi = min(kStreamWindow, n - win);
      for (int k = 0; k < hi; k += kStreamBatch) {
        int js[kStreamBatch];
#pragma unroll
        for (int u = 0; u < kStreamBatch; ++u)
          js[u] = list[min(k + u, hi - 1)];
        add_batch<T, kVecX, kStreamBatch>(js, hi - k, x, n_cols, col_base,
                                          32, s, e);
      }
      __syncwarp();    // the next window rewrites the list
    }
  }
  store_cols<T, kVecX>(out + (long long)row_index * n_cols, col_base, 32,
                       n_cols, s, e);
}

// ---------------------------------------------------------------- wide
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
wide_kernel(const unsigned* __restrict__ words, const T* __restrict__ x,
            T* __restrict__ out, int n_words, int n_cols) {
  constexpr int kWarps = kWideThreads / 32;
  __shared__ unsigned live_word[kWideThreads];
  __shared__ int live_index[kWideThreads];
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col_base = blockIdx.y * kWideCols + threadIdx.x;
  float s[kVec], e[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) s[c] = e[c] = 0.f;
  const unsigned* row = words + (long long)blockIdx.x * n_words;

  for (int chunk = 0; chunk < n_words; chunk += kWideThreads) {
    const int w = chunk + threadIdx.x;
    const unsigned word = w < n_words ? row[w] : 0u;
    const unsigned ballot = __ballot_sync(kFull, word != 0u);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_live = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      offset += k < warp ? warp_count[k] : 0;
      n_live += warp_count[k];
    }
    if (word != 0u) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      live_word[slot] = word;
      live_index[slot] = w;
    }
    __syncthreads();
    // the set bits of the live words, lowest first, one x row at a time
    // (batching them made this route slower at D 1433)
    for (int k = 0; k < n_live; ++k) {
      unsigned bits = live_word[k];
      const long long j0 = 32LL * live_index[k];
      while (bits != 0u) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const T* xrow = x + (j0 + b) * n_cols;
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const int col = col_base + kWideThreads * c;
          if (col < n_cols) two_sum(s[c], e[c], load1(xrow + col));
        }
      }
    }
    __syncthreads();   // the next chunk rewrites the compacted words
  }
  store_cols<T, false>(out + (long long)blockIdx.x * n_cols, col_base,
                       kWideThreads, n_cols, s, e);
}

template <typename T>
void split_launch(dim3 grid, cudaStream_t stream, bool vec_x,
                  const unsigned* w, const void* x, void* out, int n_words,
                  int n_cols, int vec_words) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec_x) {
    split_kernel<T, true><<<grid, kSplitWarps * 32, 0, stream>>>(
        w, xt, ot, n_words, n_cols, vec_words);
  } else {
    split_kernel<T, false><<<grid, kSplitWarps * 32, 0, stream>>>(
        w, xt, ot, n_words, n_cols, vec_words);
  }
}

bool valid(int n_rows, int n_words, int n_cols, int dtype) {
  return n_rows >= 0 && n_words >= 0 && n_words <= (1 << 26) &&
         n_cols >= 0 && (dtype == 0 || dtype == 1);
}

// x and out take the 16- (f32) or 8-byte (bf16) loads and stores.
bool aligned_x(const void* x, const void* out, int n_cols, int dtype) {
  const uintptr_t bytes = dtype == 0 ? 16 : 8;
  return n_cols % kVec == 0 && reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
         reinterpret_cast<uintptr_t>(out) % bytes == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out alike). The split route:
// kSplitWarps warps a row; rows longer than kSplitPass words are read in
// several passes (the stream route takes them when planned).
extern "C" int bitmap_spmm_split_launch(const int* words, const void* x,
                                        void* out, int n_rows, int n_words,
                                        int n_cols, int dtype, void* stream) {
  if (!valid(n_rows, n_words, n_cols, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_cols == 0) return 0;
  const dim3 grid(n_rows, (n_cols + kTileCols - 1) / kTileCols);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const bool vec_x = aligned_x(x, out, n_cols, dtype);
  const int vec_words =
      n_words % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    split_launch<float>(grid, st, vec_x, w, x, out, n_words, n_cols,
                        vec_words);
  } else {
    split_launch<__nv_bfloat16>(grid, st, vec_x, w, x, out, n_words, n_cols,
                                vec_words);
  }
  return (int)cudaGetLastError();
}

// The stream route: a warp per row, kStreamWarps rows a block.
extern "C" int bitmap_spmm_stream_launch(const int* words, const void* x,
                                         void* out, int n_rows, int n_words,
                                         int n_cols, int dtype,
                                         void* stream) {
  if (!valid(n_rows, n_words, n_cols, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_cols == 0) return 0;
  const dim3 grid((n_rows + kStreamWarps - 1) / kStreamWarps,
                  (n_cols + kTileCols - 1) / kTileCols);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const bool vec_x = aligned_x(x, out, n_cols, dtype);
  const int vec_words =
      n_words % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = kStreamWarps * 32;
  if (dtype == 0) {
    const float* xt = static_cast<const float*>(x);
    float* ot = static_cast<float*>(out);
    if (vec_x) {
      stream_kernel<float, true><<<grid, threads, 0, st>>>(
          w, xt, ot, n_rows, n_words, n_cols, vec_words);
    } else {
      stream_kernel<float, false><<<grid, threads, 0, st>>>(
          w, xt, ot, n_rows, n_words, n_cols, vec_words);
    }
  } else {
    const __nv_bfloat16* xt = static_cast<const __nv_bfloat16*>(x);
    __nv_bfloat16* ot = static_cast<__nv_bfloat16*>(out);
    if (vec_x) {
      stream_kernel<__nv_bfloat16, true><<<grid, threads, 0, st>>>(
          w, xt, ot, n_rows, n_words, n_cols, vec_words);
    } else {
      stream_kernel<__nv_bfloat16, false><<<grid, threads, 0, st>>>(
          w, xt, ot, n_rows, n_words, n_cols, vec_words);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int bitmap_spmm_wide_launch(const int* words, const void* x,
                                       void* out, int n_rows, int n_words,
                                       int n_cols, int dtype, void* stream) {
  if (!valid(n_rows, n_words, n_cols, dtype)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_cols == 0) return 0;
  const dim3 grid(n_rows, (n_cols + kWideCols - 1) / kWideCols);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    wide_kernel<float><<<grid, kWideThreads, 0, st>>>(
        w, static_cast<const float*>(x), static_cast<float*>(out), n_words,
        n_cols);
  } else {
    wide_kernel<__nv_bfloat16><<<grid, kWideThreads, 0, st>>>(
        w, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n_words, n_cols);
  }
  return (int)cudaGetLastError();
}
