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
// What bounds it on this card: bytes. Per call it reads cand (F*W words),
// the adjacency rows of every active position (sum over rows of their
// active count, W words each) and writes out (F*W words); the arithmetic
// is one AND per word read. On the main path (human-like graph: V = 4674,
// W = 147, F = 512) the whole adjacency is 2.7 MB, so it stays resident
// in the 50 MB L2 across calls and the gathered rows come mostly from L2.
//
// Design: one block per output row. The block compacts that row's active
// frontier vertices into shared memory once (the only per-row index
// work), then its threads stride over the W words, so each gathered
// adjacency row is read with consecutive threads on consecutive words
// (coalesced), ANDed into a register accumulator, and written once. No
// padding of F or W is needed. A slow but simple first version: no
// multi-row blocking, no vectorised loads.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPositions = 64;   // N_PAD of the engine

__global__ void refine_rows_kernel(const int* __restrict__ adj,
                                   const int* __restrict__ cand,
                                   const int* __restrict__ frontier,
                                   const int* __restrict__ active,
                                   int* __restrict__ out,
                                   int n_vertices, int n_words,
                                   int n_positions) {
  __shared__ int verts[kMaxPositions];
  __shared__ int n_act;
  const int row = blockIdx.x;
  if (threadIdx.x == 0) n_act = 0;
  __syncthreads();
  // Order of the compacted list does not matter: AND is commutative.
  for (int p = threadIdx.x; p < n_positions; p += blockDim.x) {
    const long long k = (long long)row * n_positions + p;
    const int v = frontier[k];
    if (active[k] != 0 && v >= 0) {
      const int slot = atomicAdd(&n_act, 1);
      verts[slot] = v < n_vertices ? v : n_vertices - 1;
    }
  }
  __syncthreads();
  const int na = n_act;
  const long long base = (long long)row * n_words;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    int acc = cand[base + w];
    for (int j = 0; j < na; ++j) {
      acc &= adj[(long long)verts[j] * n_words + w];
    }
    out[base + w] = acc;
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
  refine_rows_kernel<<<n_rows, kThreads, 0, (cudaStream_t)stream>>>(
      adj, cand, frontier, active, out, n_vertices, n_words, n_positions);
  return (int)cudaGetLastError();
}
