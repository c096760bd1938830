// Fused attention forward with an online softmax, for Hopper (sm_90a):
//
//   o[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j])
//                   * v[b, h / g, j, :]
//
// over [B, H, S, D] queries and [B, Hkv, Skv, D] keys and values
// (g = H / Hkv, grouped-query attention), scale = D ** -0.5, f32 or bf16
// in and out, every intermediate in f32. With ``causal`` key j is
// visible to query i iff j <= i, both counted from position 0 (the
// Pallas kernel's mask, top-left aligned).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, public flash_attention). The Pallas version keeps a
// query tile in VMEM, streams key/value tiles along the innermost grid
// dimension, carries (max, sum, accumulator) in VMEM scratch from one
// grid step to the next, skips key tiles above the causal diagonal and
// pads D to 128. Here the key loop runs inside the block, the state
// lives in registers and shared memory, and D is not padded.
//
// What bounds it on this card: at prefill lengths, operations (4 D flops
// per visible (query, key) pair against 989 TFLOP/s in bf16 on the
// tensor cores, 67 TFLOP/s in exact f32); at decode (one query row
// against a long cache), bytes (the K and V cache read once). This first
// version uses neither: no tensor cores (f32 must hold the reference's
// 2e-4), FMA math throughout, and one block per (b * h, query tile), so a
// decode step runs only B * H blocks.
//
// Design: 128 threads per block, a tile of kRows = 32 query rows. The
// query tile is converted to f32 into shared memory once. For each key
// tile (BK = 64 keys for D <= 128, 32 for D <= 256, so that the tiles
// fit in shared memory at every D), the block copies K and V, converted
// to f32, into shared memory (K rows padded by one word, so the score
// loop reads it without bank conflicts); each thread computes the scores
// of one key against kRows / (128 / BK) query rows; one warp per row
// takes the row max, exponentiates and sums (warp shuffles); then each
// thread rescales and adds P V into its 8 rows x NJ columns of the f32
// accumulator in registers (columns lane + 32 j). Key tiles wholly above
// the causal diagonal of the block's last row are never loaded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                     // query rows per block
constexpr int kRowsPerWarp = kRows / kWarps;  // accumulator rows a thread
constexpr float kNegInf = -1e30f;             // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int d, int bk) {
  return sizeof(float) * ((size_t)kRows * d + (size_t)bk * (d + 1) +
                          (size_t)bk * d + (size_t)kRows * bk + 3 * kRows);
}

template <typename T, int NJ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int s_q,
             int s_kv, int d, int n_qtiles, float scale, int causal) {
  constexpr int kRowStep = kThreads / BK;       // score rows between threads
  constexpr int kScoreRows = kRows / kRowStep;  // scores a thread per tile
  extern __shared__ float smem[];
  float* qs = smem;                       // [kRows][d]
  float* ks = qs + kRows * d;             // [BK][d + 1]
  float* vs = ks + BK * (d + 1);          // [BK][d]
  float* ps = vs + BK * d;                // [kRows][BK] scores, then p
  float* m_s = ps + kRows * BK;           // running max
  float* l_s = m_s + kRows;               // running sum
  float* c_s = l_s + kRows;               // this tile's correction

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kRows;
  const long long kv_base = (long long)(bh / group) * s_kv * d;
  const T* qg = q + (long long)bh * s_q * d;

  for (int e = tid; e < kRows * d; e += kThreads) {
    const int r = e / d;
    qs[e] = q0 + r < s_q ? to_f32(qg[(long long)q0 * d + e]) : 0.f;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (s_kv + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + kRows, s_q) - 1;
    n_tiles = min(n_tiles, last_row / BK + 1);
  }
  const int key = tid % BK;       // this thread's key in the score phase
  const int row0 = tid / BK;      // and its first query row
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();              // the last tile's K, V and p are spent
    const int n_in = min(BK, s_kv - k0) * d;
    for (int e = tid; e < BK * d; e += kThreads) {
      const int r = e / d;
      const int c = e - r * d;
      const long long g = kv_base + (long long)k0 * d + e;
      ks[r * (d + 1) + c] = e < n_in ? to_f32(k[g]) : 0.f;
      vs[e] = e < n_in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    float s[kScoreRows];
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) s[i] = 0.f;
    const float* krow = ks + key * (d + 1);
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int i = 0; i < kScoreRows; ++i) {
        s[i] = fmaf(qs[(row0 + i * kRowStep) * d + c], kc, s[i]);
      }
    }
    const int kpos = k0 + key;
#pragma unroll
    for (int i = 0; i < kScoreRows; ++i) {
      const int r = row0 + i * kRowStep;
      const bool visible = kpos < s_kv && (!causal || kpos <= q0 + r);
      ps[r * BK + key] = visible ? s[i] * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < kRows; r += kWarps) {
      float x[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        x[u] = ps[r * BK + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(x[u] - m_new);
        ps[r * BK + lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float corr = c_s[warp + i * kWarps];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        vv[j] = c < d ? vs[kk * d + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = ps[(warp + i * kWarps) * BK + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  // n_tiles >= 1, and the last tile's l_s writes precede a barrier.
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (q0 + r >= s_q) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((long long)bh * s_q + q0 + r) * d;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      if (c < d) store(orow + c, acc[i][j] * inv);
    }
  }
}

int smem_optin_limit() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&bytes,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err == cudaSuccess ? bytes : -(int)err;
}

template <typename T, int NJ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int n_bh,
           int group, int s_q, int s_kv, int d, float scale, int causal,
           cudaStream_t stream) {
  const int n_qtiles = (s_q + kRows - 1) / kRows;
  if ((long long)n_bh * n_qtiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(d, BK);
  if (smem > 48 * 1024) {
    const int limit = smem_optin_limit();
    if (limit < 0) return -limit;
    if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, NJ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_kernel<T, NJ, BK><<<n_bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, s_q, s_kv, d,
      n_qtiles, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int n_bh,
             int group, int s_q, int s_kv, int d, float scale, int causal,
             cudaStream_t stream) {
  if (d <= 32) {
    return launch<T, 1, 64>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                            causal, stream);
  }
  if (d <= 64) {
    return launch<T, 2, 64>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                            causal, stream);
  }
  if (d <= 128) {
    return launch<T, 4, 64>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                            causal, stream);
  }
  return launch<T, 8, 32>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                          causal, stream);
}

}  // namespace

// q [n_bh, s_q, d], k / v [n_bh / group, s_kv, d], o like q, all
// contiguous; dtype 0 = float32, 1 = bfloat16. 1 <= d <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int n_bh,
                                      int group, int s_q, int s_kv, int d,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (d < 1 || d > 256 || group < 1 || n_bh < 0 || n_bh % group != 0 ||
      s_q < 0 || s_kv < 1 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bh == 0 || s_q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch_d<float>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                           causal, st);
  }
  return launch_d<__nv_bfloat16>(q, k, v, o, n_bh, group, s_q, s_kv, d,
                                 scale, causal, st);
}
