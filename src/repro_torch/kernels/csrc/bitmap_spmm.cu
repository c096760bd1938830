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
// 65536-vertex scale graph ~0.01 %), so this kernel walks the set bits
// instead and does nnz * D additions.
//
// What bounds it on this card: bytes. Per call it reads the N * W words
// once, the x rows of the set columns (each distinct row at least once;
// rows shared by many output rows come again from L2) and writes out.
// The arithmetic is one f32 add per set bit and column (six with the
// error term below).
//
// Design: one block per (output row, tile of kCols columns). The block
// reads the row's words in chunks of kThreads, coalesced; the nonzero
// words of a chunk are compacted into shared memory in word order (warp
// ballots and a prefix over the warps, so the summation order, and with
// it every result bit, is the same on every run); then every thread
// walks the compacted words' set bits, lowest first, and adds x[j, col]
// for its kColsPerThread columns into f32 registers. Consecutive threads
// read consecutive columns of an x row, so each read is coalesced. No
// tensor cores and no TF32. Each f32 sum carries its rounding error in a
// second register (Knuth's TwoSum), so the result is the exact sum
// rounded to f32 up to a few units in its last place, whatever the
// order: a plain f32 running sum over a hub row of a few hundred set
// bits drifts past the reference's tolerance (rtol / atol 1e-5) from any
// other summation order. A simple first version: no vectorised loads, no
// reuse of x rows across output rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 4;
constexpr int kCols = kThreads * kColsPerThread;   // columns per block

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as astype does
}

// s + x into s, its rounding error into err (TwoSum: exact for any
// order of magnitude of s and x; no products, so nothing to contract).
__device__ __forceinline__ void two_sum(float& s, float& err, float x) {
  const float t = s + x;
  const float xp = t - s;
  err += (s - (t - xp)) + (x - xp);
  s = t;
}

template <typename T>
__global__ void spmm_kernel(const unsigned* __restrict__ words,
                            const T* __restrict__ x, T* __restrict__ out,
                            int n_words, int n_cols) {
  __shared__ unsigned live_word[kThreads];
  __shared__ int live_index[kThreads];
  __shared__ int warp_count[kWarps];
  const int row = blockIdx.x;
  const int col0 = blockIdx.y * kCols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[kColsPerThread], err[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) acc[c] = err[c] = 0.f;
  const unsigned* row_words = words + (long long)row * n_words;

  for (int base = 0; base < n_words; base += kThreads) {
    const int w = base + threadIdx.x;
    const unsigned word = w < n_words ? row_words[w] : 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, word != 0u);
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
    for (int k = 0; k < n_live; ++k) {
      unsigned bits = live_word[k];
      const long long j0 = 32LL * live_index[k];
      while (bits != 0u) {
        const int b = __ffs(bits) - 1;
        bits &= bits - 1u;
        const T* xrow = x + (j0 + b) * n_cols;
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          const int col = col0 + c * kThreads + threadIdx.x;
          if (col < n_cols) two_sum(acc[c], err[c], load_f32(xrow + col));
        }
      }
    }
    __syncthreads();   // the next chunk rewrites the compacted words
  }
  T* out_row = out + (long long)row * n_cols;
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c) {
    const int col = col0 + c * kThreads + threadIdx.x;
    if (col < n_cols) store(out_row + col, acc[c] + err[c]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).
extern "C" int bitmap_spmm_launch(const int* words, const void* x, void* out,
                                  int n_rows, int n_words, int n_cols,
                                  int dtype, void* stream) {
  if (n_rows < 0 || n_words < 0 || n_cols < 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0 || n_cols == 0) return 0;
  const dim3 grid(n_rows, (n_cols + kCols - 1) / kCols);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  const unsigned* w = reinterpret_cast<const unsigned*>(words);
  if (dtype == 0) {
    spmm_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        w, static_cast<const float*>(x), static_cast<float*>(out), n_words,
        n_cols);
  } else {
    spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        w, static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), n_words, n_cols);
  }
  return (int)cudaGetLastError();
}
