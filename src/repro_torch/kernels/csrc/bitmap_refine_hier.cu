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
// What bounds it on this card: bytes. Per call it reads cand (F*W
// words), frontier and active, the summary row of each active position
// (SW words), and for each active position of a row that stays live its
// chunk_id window and the C words of each live stored chunk; it writes
// out (F*W words). The arithmetic is an AND or an OR per word read.
//
// Design: one block per output row. The block compacts the row's active
// frontier vertices into shared memory, then builds the row in dynamic
// shared memory (W words, plus SW summary words): cand is loaded once,
// its chunk summary built with one warp vote per 32 words, ANDed with
// the positions' summaries, and dead chunks zeroed. A row whose summary
// is all dead is written out as zeros without touching the chunk
// store. Otherwise, for each active position in turn, the block's
// threads stride over (stored chunk, word) pairs, so chunk_data reads
// are coalesced; dead chunks are skipped and live ones ANDed into the
// row. One chunk id appears once per vertex, so within a position no two
// threads write one word; positions are separated by __syncthreads().
// The row is written out once. Shared memory is (W + SW) * 4 bytes: 8 KB
// at 64K vertices; past 48 KB the launch opts in, past the card's limit
// it refuses. A simple first version: no multi-row blocking, no
// vectorised loads, no prefetch of the next position's chunks.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPositions = 64;   // N_PAD of the engine
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ bool chunk_live(const int* sacc, int c) {
  return (sacc[c >> 5] >> (c & 31)) & 1;
}

__global__ void refine_rows_hier_kernel(
    const int* __restrict__ summary, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_id, const int* __restrict__ chunk_data,
    const int* __restrict__ cand, const int* __restrict__ frontier,
    const int* __restrict__ active, int* __restrict__ out,
    int n_vertices, int n_summary, int log2_c, int n_words,
    int n_positions) {
  extern __shared__ int smem[];
  int* row = smem;                     // [n_words]
  int* sacc = smem + n_words;          // [n_summary]
  __shared__ int verts[kMaxPositions];
  __shared__ int n_act;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = 1 << log2_c;
  const long long base = (long long)blockIdx.x * n_words;

  if (tid == 0) n_act = 0;
  for (int s = tid; s < n_summary; s += blockDim.x) sacc[s] = 0;
  __syncthreads();
  // Order of the compacted list does not matter: AND is commutative.
  for (int p = tid; p < n_positions; p += blockDim.x) {
    const long long k = (long long)blockIdx.x * n_positions + p;
    const int v = frontier[k];
    if (active[k] != 0 && v >= 0) verts[atomicAdd(&n_act, 1)] = v;
  }
  // cand into shared memory and its chunk summary: one ballot per warp
  // of 32 consecutive words; lane 0 folds it into chunk bits. A warp's
  // chunks share one summary word (32 / C divides 32, or C >= 32).
  for (int w0 = 0; w0 < n_words; w0 += blockDim.x) {
    const int w = w0 + tid;
    const int x = w < n_words ? cand[base + w] : 0;
    if (w < n_words) row[w] = x;
    const unsigned nz = __ballot_sync(0xffffffffu, x != 0);
    if (lane == 0 && nz != 0) {
      const int first = (w >> log2_c);           // chunk of this lane
      unsigned bits;
      if (c >= 32) {
        bits = 1u << (first & 31);
      } else {
        bits = 0;
        const unsigned sub = (1u << c) - 1;
        for (int j = 0; j < (32 >> log2_c); ++j) {
          if ((nz >> (j << log2_c)) & sub) bits |= 1u << ((first + j) & 31);
        }
      }
      atomicOr(&sacc[first >> 5], (int)bits);
    }
  }
  __syncthreads();
  const int na = n_act;
  int any_live = 0;
  for (int s = tid; s < n_summary; s += blockDim.x) {
    int acc = sacc[s];
    for (int j = 0; j < na; ++j) {
      const int v = verts[j] < n_vertices ? verts[j] : n_vertices - 1;
      acc &= summary[(long long)v * n_summary + s];
    }
    sacc[s] = acc;
    any_live |= acc;
  }
  const int live = __syncthreads_or(any_live != 0);
  if (live) {
    for (int w = tid; w < n_words; w += blockDim.x) {
      if (!chunk_live(sacc, w >> log2_c)) row[w] = 0;
    }
    __syncthreads();
    for (int j = 0; j < na; ++j) {
      const int v = verts[j];
      if (v >= n_vertices) continue;             // no stored chunks
      const int k0 = chunk_ptr[v];
      const int span = (chunk_ptr[v + 1] - k0) << log2_c;
      for (int t = tid; t < span; t += blockDim.x) {
        const int k = k0 + (t >> log2_c);
        const int cid = chunk_id[k];
        if (chunk_live(sacc, cid)) {
          const int w = (cid << log2_c) + (t & (c - 1));
          if (w < n_words) {
            row[w] &= chunk_data[((long long)k << log2_c) + (t & (c - 1))];
          }
        }
      }
      __syncthreads();
    }
    for (int w = tid; w < n_words; w += blockDim.x) out[base + w] = row[w];
  } else {
    for (int w = tid; w < n_words; w += blockDim.x) out[base + w] = 0;
  }
}

}  // namespace

// Largest dynamic shared memory a block of this kernel may opt in to on
// the current device, in bytes (< 0: a CUDA error code, negated).
extern "C" int refine_bitmap_rows_hier_max_smem() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return -(int)err;
  return bytes - (int)(kMaxPositions + 1) * (int)sizeof(int);
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
  const size_t smem = (size_t)(n_words + n_summary) * sizeof(int);
  if (smem > (size_t)kDefaultSmem) {
    const int limit = refine_bitmap_rows_hier_max_smem();
    if (limit < 0) return -limit;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        refine_rows_hier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  refine_rows_hier_kernel<<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      summary, chunk_ptr, chunk_id, chunk_data, cand, frontier, active, out,
      n_vertices, n_summary, log2_c, n_words, n_positions);
  return (int)cudaGetLastError();
}
