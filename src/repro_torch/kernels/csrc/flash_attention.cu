// Fused attention forward with an online softmax, for Hopper (sm_90a):
//
//   o[b, h, i, :] = sum_j softmax_j(scale * q[b, h, i] . k[b, h / g, j])
//                   * v[b, h / g, j, :]
//
// over [B, H, S, D] queries and [B, Hkv, Skv, D] keys and values
// (g = H / Hkv, grouped-query attention), scale = D ** -0.5, f32 or bf16
// in and out, softmax state in f32. With ``causal`` key j is visible to
// query i iff j <= i, both counted from position 0 (the Pallas kernel's
// mask, top-left aligned).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, public flash_attention). The Pallas version keeps a
// query tile in VMEM, streams key/value tiles along the innermost grid
// dimension, carries (max, sum, accumulator) in VMEM scratch from one
// grid step to the next, skips key tiles above the causal diagonal and
// pads D to 128. Here the key loop runs inside a block. The call has two
// regimes that need two designs, and a third for what neither takes;
// the wrapper (kernels/flash_attention.py, ``plan``) picks one by shape
// and dtype:
//
//   flash_split_launch  decode-shaped (group * S <= 64 rows per kv head):
//                       split-K over the keys, then a combine; bytes;
//   flash_tc_launch     bf16, D % 16 == 0: wgmma on the tensor cores;
//                       operations;
//   flash_attention_launch  the rest (f32 prefill, D not a multiple of
//                       16): FMA in exact f32, the reference's 2e-4.
//
// Each section below says what bounds it and what its design does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------
// Route ``fma``: every call no other route takes, chiefly f32 prefill.
//
// Bound at prefill lengths by operations (4 D flops per visible pair
// against 67 TFLOP/s of exact f32: the tensor cores' TF32 would break
// the reference's 2e-4). 128 threads per block, a tile of kRows = 32
// query rows of one (b, h). The query tile is converted to f32 into
// shared memory once. For each key tile (BK = 64 keys for D <= 128, 32
// for D <= 256, so that the tiles fit in shared memory at every D), the
// block copies K and V, converted to f32, into shared memory (K rows
// padded by one word, so the score loop reads it without bank
// conflicts); each thread computes the scores of one key against
// kRows / (128 / BK) query rows; one warp per row takes the row max,
// exponentiates and sums (warp shuffles); then each thread rescales and
// adds P V into its 8 rows x NJ columns of the f32 accumulator in
// registers (columns lane + 32 j). Key tiles wholly above the causal
// diagonal of the block's last row are never loaded.

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


// ---------------------------------------------------------------------
// Route ``split``: decode-shaped calls, f32 or bf16.
//
// Bound by bytes: every K / V byte must leave HBM once (537 MB in bf16
// for the Qwen3-0.6B decode step at Skv 32768, B 4). One block per
// (b, kv head, key split) holds all ``rows = group * S <= 64`` query
// rows that read that kv head (contiguous in q: heads h * g .. h * g +
// g - 1 are neighbours), so each K / V byte is read by one block only.
// The block is latency-bound on its own (one 8 KB K and V tile in a
// three-stage ring, 48 KB), so several must share each SM: the wrapper
// picks power-of-two splits that keep the grid within four blocks per
// SM, all resident at once (on a long cache, two to four per SM; a
// grid just past one resident wave pays for a second, nearly empty
// one). K and V stream in their own dtype with 16-byte cp.async copies
// (coalesced along D, K's 16-byte chunks XOR-swizzled by key so that a
// warp reading 32 keys' rows hits every bank). Scores, softmax state and
// the accumulator are f32 in shared memory; each dot product and each
// P V column sums in several independent chains. Each split writes its partial (m, l, acc[D]) to
// scratch the wrapper allocated; a second kernel rescales and sums the
// partials of each row into q's dtype. A split wholly past the causal
// diagonal loads nothing and writes the neutral partial (-1e30, 0, 0).
namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileBytes = 8192;    // one K (or V) tile of the ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16-byte chunk c of key row ``key`` in the K tile: chunks in whole
// groups of eight are XOR-swizzled by the key's low bits.
__device__ __forceinline__ int swizzle(int key, int c, int n_chunks) {
  return c < (n_chunks & ~7) ? c ^ (key & 7) : c;
}

// The 16 bytes at ``p`` as f32: 4 floats or 8 bf16.
__device__ __forceinline__ void chunk_f32(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

int key_tile(int d, int elem) {
  int bk = 64;
  while (bk > 16 && bk * d * elem > kMaxTileBytes) bk /= 2;
  return bk;
}

size_t smem_bytes(int rows, int d, int bk, int elem, int stages) {
  return (size_t)stages * 2 * bk * d * elem +
         sizeof(float) * ((size_t)2 * rows * d + (size_t)rows * bk +
                          3 * rows);
}

template <typename T, int STAGES>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ part_ml,
             float* __restrict__ part_acc, int rows, int s_q, int s_kv,
             int d, int n_splits, int split_len, int bk, float scale,
             int causal) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_chunks = d / kVec;
  const int tile_elems = bk * d;
  T* ring = reinterpret_cast<T*>(smem_raw);          // [STAGES][2][bk][d]
  float* qs = reinterpret_cast<float*>(ring + STAGES * 2 * tile_elems);
  float* acc = qs + rows * d;               // [rows][d]
  float* ps = acc + rows * d;               // [rows][bk] scores, then p
  float* m_s = ps + rows * bk;
  float* l_s = m_s + rows;
  float* c_s = l_s + rows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bhkv = blockIdx.x / n_splits;
  const int k_begin = (blockIdx.x % n_splits) * split_len;
  int k_end = min(s_kv, k_begin + split_len);
  if (causal) k_end = min(k_end, s_q);    // positions < s_q see keys < s_q
  const long long part = (long long)blockIdx.x * rows;
  if (k_end <= k_begin) {                 // wholly past the diagonal
    for (int r = tid; r < rows; r += kThreads) {
      part_ml[2 * (part + r)] = kNegInf;
      part_ml[2 * (part + r) + 1] = 0.f;
    }
    for (int e = tid; e < rows * d; e += kThreads) {
      part_acc[part * d + e] = 0.f;
    }
    return;
  }

  const T* qg = q + (long long)bhkv * rows * d;
  const long long kv_base = (long long)bhkv * s_kv * d;
  for (int e = tid; e < rows * d; e += kThreads) {
    qs[e] = to_f32(qg[e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int n_tiles = (k_end - k_begin + bk - 1) / bk;
  auto load_tile = [&](int t) {
    T* ks = ring + (t % STAGES) * 2 * tile_elems;
    T* vs = ks + tile_elems;
    const int k0 = k_begin + t * bk;
    for (int e = tid; e < bk * n_chunks; e += kThreads) {
      const int key = e / n_chunks;
      const int c = e - key * n_chunks;
      const bool valid = k0 + key < k_end;
      const long long g = valid ? kv_base + (long long)(k0 + key) * d +
                                      c * kVec
                                : 0;
      cp_async16(ks + key * d + swizzle(key, c, n_chunks) * kVec, k + g,
                 valid);
      cp_async16(vs + key * d + c * kVec, v + g, valid);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();          // tile t landed; tile t - 1 is spent
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    const T* ks = ring + (t % STAGES) * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int k0 = k_begin + t * bk;

    // scores: one (row, key) pair a thread, consecutive threads on
    // consecutive keys of one row (q read by broadcast); kVec partial
    // sums, so the chain of dependent FMAs is D / kVec long
    for (int e = tid; e < rows * bk; e += kThreads) {
      const int r = e / bk;
      const int key = e - r * bk;
      const float4* qr = reinterpret_cast<const float4*>(qs + r * d);
      const T* kr = ks + key * d;
      float part[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) part[j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < n_chunks; ++c) {
        float x[kVec];
        chunk_f32(kr + swizzle(key, c, n_chunks) * kVec, x);
#pragma unroll
        for (int j = 0; j < kVec / 4; ++j) {
          const float4 qv = qr[c * (kVec / 4) + j];
          part[4 * j] = fmaf(qv.x, x[4 * j], part[4 * j]);
          part[4 * j + 1] = fmaf(qv.y, x[4 * j + 1], part[4 * j + 1]);
          part[4 * j + 2] = fmaf(qv.z, x[4 * j + 2], part[4 * j + 2]);
          part[4 * j + 3] = fmaf(qv.w, x[4 * j + 3], part[4 * j + 3]);
        }
      }
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) s += part[j];
      const int kpos = k0 + key;
      const bool seen = kpos < k_end && (!causal || kpos <= r % s_q);
      ps[e] = seen ? s * scale : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp a row; masked keys weigh exactly 0, so a
    // row that sees no key keeps the neutral (-1e30, 0, 0)
    for (int r = warp; r < rows; r += kWarps) {
      float* pr = ps + r * bk;
      float mx = kNegInf;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < bk; j += 32) {
        const float x = pr[j];
        const float p = x > kNegInf ? expf(x - m_new) : 0.f;
        pr[j] = p;
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

    // acc = corr * acc + p V: a thread owns (row, column pair) items,
    // the keys summed in four independent chains
    const int n_pairs = d / 2;
    for (int e = tid; e < rows * n_pairs; e += kThreads) {
      const int r = e / n_pairs;
      const int c = 2 * (e - r * n_pairs);
      const float4* pr = reinterpret_cast<const float4*>(ps + r * bk);
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int key = 0; key < bk; key += 4) {
        const float4 p4 = pr[key / 4];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 x = pair_f32(vs + (key + u) * d + c);
          a0[u] = fmaf(p[u], x.x, a0[u]);
          a1[u] = fmaf(p[u], x.y, a1[u]);
        }
      }
      const float corr = c_s[r];
      acc[r * d + c] = acc[r * d + c] * corr + ((a0[0] + a0[1]) +
                                                (a0[2] + a0[3]));
      acc[r * d + c + 1] = acc[r * d + c + 1] * corr + ((a1[0] + a1[1]) +
                                                        (a1[2] + a1[3]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int r = tid; r < rows; r += kThreads) {
    part_ml[2 * (part + r)] = m_s[r];
    part_ml[2 * (part + r) + 1] = l_s[r];
  }
  for (int e = tid; e < rows * d; e += kThreads) {
    part_acc[part * d + e] = acc[e];
  }
}

// One block per (b, kv head, row): the splits' partials rescaled to
// their largest max, summed, divided by the summed weights.
template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ part_ml,
               const float* __restrict__ part_acc, T* __restrict__ o,
               int rows, int d, int n_splits) {
  const int bhkv = blockIdx.x / rows;
  const int r = blockIdx.x - bhkv * rows;
  const long long first = (long long)bhkv * n_splits * rows + r;
  float m = kNegInf;
  for (int s = 0; s < n_splits; ++s) {
    m = fmaxf(m, part_ml[2 * (first + (long long)s * rows)]);
  }
  float total = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const long long p = first + (long long)s * rows;
    total += expf(part_ml[2 * p] - m) * part_ml[2 * p + 1];
  }
  const float inv = 1.f / fmaxf(total, 1e-30f);
  T* orow = o + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const long long p = first + (long long)s * rows;
      sum += expf(part_ml[2 * p] - m) * part_acc[p * d + c];
    }
    store(orow + c, sum * inv);
  }
}

template <typename T, int STAGES>
int launch_stages(const void* q, const void* k, const void* v, void* o,
                  float* part_ml, float* part_acc, int n_bhkv, int rows,
                  int s_q, int s_kv, int d, int n_splits, int split_len,
                  int bk, size_t smem, float scale, int causal,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split_kernel<T, STAGES><<<n_bhkv * n_splits, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_ml, part_acc, rows, s_q, s_kv, d,
      n_splits, split_len, bk, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<T><<<n_bhkv * rows, kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(o), rows, d, n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_ml, float* part_acc, int n_bhkv, int rows, int s_q,
           int s_kv, int d, int n_splits, int split_len, float scale,
           int causal, cudaStream_t stream) {
  const int elem = (int)sizeof(T);
  const int bk = key_tile(d, elem);
  if (split_len % bk != 0 || (long long)n_bhkv * n_splits > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int limit = smem_optin_limit();
  if (limit < 0) return -limit;
  size_t smem = smem_bytes(rows, d, bk, elem, 3);
  if (smem <= (size_t)limit) {
    return launch_stages<T, 3>(q, k, v, o, part_ml, part_acc, n_bhkv, rows,
                               s_q, s_kv, d, n_splits, split_len, bk, smem,
                               scale, causal, stream);
  }
  smem = smem_bytes(rows, d, bk, elem, 2);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  return launch_stages<T, 2>(q, k, v, o, part_ml, part_acc, n_bhkv, rows,
                             s_q, s_kv, d, n_splits, split_len, bk, smem,
                             scale, causal, stream);
}

}  // namespace split

// ---------------------------------------------------------------------
// Route ``tc``: bf16 prefill on the tensor cores, D a multiple of 16.
//
// Bound by operations at prefill lengths: 4 D flops per visible (query,
// key) pair against 989 TFLOP/s of dense bf16 (0.0695 ms for the
// Qwen3-0.6B 4096-token causal prefill). Both products run as Hopper
// warpgroup MMAs: S = Q K^T as wgmma m64n64k16 with Q and K read from
// shared memory, O += P V as m64nDPk16 with P in registers (bf16) and V
// read from shared memory, transposed by the instruction; sums in f32.
//
// A block of two warpgroups (256 threads) owns 128 query rows of one
// (b, h); each warpgroup 64 of them. The Q tile stays in shared memory;
// 64-key K / V tiles go through a two-stage ring filled by 16-byte
// cp.async copies, so tile t + 1 is in flight while tile t is used. Every
// tile is laid out as the instructions' 128-byte swizzle wants it: rows
// of 64 bf16 (128 bytes), 16-byte chunk c of row r at chunk c ^ (r % 8),
// D in blocks of 64 columns, each block its own [rows][128 B] region.
// D is padded to DP = 64, 128 or 256 with zero columns (no loads, no
// products past D). The online softmax runs on the accumulator fragments
// in registers (each row spread over four lanes); P is rounded to bf16
// there and feeds the second product as its A operand. Key tiles wholly
// above a warpgroup's causal diagonal are skipped (by the whole block
// when above its last row: never loaded); the diagonal tile and the
// ragged Skv edge are masked on the fragments. Query tiles run heaviest
// first, so the causal triangle's long rows do not trail.
namespace tc {

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64 * kWarpgroups;   // query rows per block
constexpr int kKeys = 64;                 // keys per tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk ``c`` of row ``r`` in a swizzled region
// of ``rows`` rows (64-column blocks one after the other).
__device__ __forceinline__ int swizzled(int r, int c, int rows) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lead,
                                         unsigned stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lead >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((stride >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_ss_n64(
    float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(
    float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(
    float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n256(
    float* d, const uint32_t* a, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Pins each accumulator register after a wgmma wait (or before an
// issue), so the compiler moves no read or write of it across.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_n64(o, a, db, 1);
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db, 1);
  } else {
    wgmma_rs_n256(o, a, db, 1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

size_t smem_bytes(int dp) {
  return (size_t)kRows * dp * 2 + (size_t)kStages * 2 * kKeys * dp * 2 +
         1024;   // slack to align the base to 1024 bytes
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
          int n_bh, int group, int s_q, int s_kv, int d, int n_qtiles,
          float scale, int causal) {
  constexpr int kChunks = DP / 8;                 // 16-byte chunks a row
  constexpr int kTileBytes = kKeys * DP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = base;                       // [DP/64][kRows][128 B]
  unsigned char* ring = base + kRows * DP * 2;    // [stage][K, V]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;                        // warpgroup
  const int wl = (tid >> 5) & 3;                  // warp in warpgroup
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qtiles - 1 - blockIdx.x / n_bh) * kRows;
  const int d_chunks = d / 8;
  const long long kv_base = (long long)(bh / group) * s_kv * d;
  const __nv_bfloat16* qg = q + (long long)bh * s_q * d;

  int n_tiles = (s_kv + kKeys - 1) / kKeys;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, s_q) - 1) / kKeys + 1);

  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const bool valid = q0 + r < s_q && c < d_chunks;
    const __nv_bfloat16* src =
        valid ? qg + (long long)(q0 + r) * d + c * 8 : q;
    split::cp_async16(qs + swizzled(r, c, kRows), src, valid);
  }
  auto load_tile = [&](int t) {
    unsigned char* ks = ring + (t % kStages) * 2 * kTileBytes;
    unsigned char* vs = ks + kTileBytes;
    const int k0 = t * kKeys;
    for (int e = tid; e < kKeys * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = e - r * kChunks;
      const bool valid = k0 + r < s_kv && c < d_chunks;
      const long long g =
          valid ? kv_base + (long long)(k0 + r) * d + c * 8 : 0;
      const int off = swizzled(r, c, kKeys);
      split::cp_async16(ks + off, k + g, valid);
      split::cp_async16(vs + off, v + g, valid);
    }
  };
  load_tile(0);
  split::cp_async_commit();

  // this thread's rows in the warpgroup's 64, and their positions
  const int row0 = q0 + wg * 64 + wl * 16 + (lane >> 2);
  const int row1 = row0 + 8;
  const int wg_first = q0 + wg * 64;
  const bool wg_live = wg_first < s_q;
  const float qk_scale = scale * kLog2e;          // softmax in base 2
  float o_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1);
    split::cp_async_commit();
    split::cp_async_wait<1>();
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const int k0 = t * kKeys;
    if (wg_live && !(causal && k0 > wg_first + 63)) {
      const unsigned ks = smem_addr(ring + (t % kStages) * 2 * kTileBytes);
      const unsigned vs = ks + kTileBytes;
      const unsigned qa = smem_addr(qs) + wg * 64 * 128;
      float s_acc[32] = {};
      fence_regs<32>(s_acc);    // the zeros stay outside the MMA stage
      wgmma_fence();
      for (int kk = 0; kk < d / 16; ++kk) {
        const unsigned step = (kk & 3) * 32;
        wgmma_ss_n64(s_acc,
                     desc(qa + (kk >> 2) * kRows * 128 + step, 16, 1024),
                     desc(ks + (kk >> 2) * kKeys * 128 + step, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<32>(s_acc);

      // fragment (j, i): key k0 + 8 j + 2 (lane % 4) + (i & 1), row
      // row0 for i < 2, row1 for i >= 2
      const bool edge = k0 + kKeys > s_kv || (causal && k0 + 63 > wg_first);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s_acc[4 * j + i] * qk_scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + (i & 1);
            const int row = i < 2 ? row0 : row1;
            if (key >= s_kv || (causal && key > row)) x = -INFINITY;
          }
          s_acc[4 * j + i] = x;
          if (i < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // a row's first tile holds key 0, so its max is finite from then on
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2f(s_acc[4 * j + i] - (i < 2 ? n0 : n1));
          s_acc[4 * j + i] = p;
          if (i < 2) sum0 += p; else sum1 += p;
        }
      }
      l0 = l0 * c0 + sum0;     // this lane's share; summed at the end
      l1 = l1 * c1 + sum1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o_acc[4 * j] *= c0;
        o_acc[4 * j + 1] *= c0;
        o_acc[4 * j + 2] *= c1;
        o_acc[4 * j + 3] *= c1;
      }
      // P as the A operand of m64k16, four steps of 16 keys
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s_acc[8 * kk], s_acc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
      }
      // V [64 keys][DP] read MN-major: 64-column blocks kKeys * 128 bytes
      // apart (leading), 8-key groups 1024 bytes apart (stride)
      fence_regs<DP / 2>(o_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_pv<DP>(o_acc, pa[kk],
                     desc(vs + kk * 16 * 128, kKeys * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs<DP / 2>(o_acc);
    }
    __syncthreads();          // every warpgroup is done with this stage
  }
  split::cp_async_wait<0>();

  if (!wg_live) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* og = o + (long long)bh * s_q * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    if (col >= d) continue;
    if (row0 < s_q) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * d + col) =
          __floats2bfloat162_rn(o_acc[4 * j] * inv0,
                                o_acc[4 * j + 1] * inv0);
    }
    if (row1 < s_q) {
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * d + col) =
          __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1,
                                o_acc[4 * j + 3] * inv1);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int n_bh,
           int group, int s_q, int s_kv, int d, float scale, int causal,
           cudaStream_t stream) {
  const int n_qtiles = (s_q + kRows - 1) / kRows;
  if ((long long)n_bh * n_qtiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(DP);
  const int limit = smem_optin_limit();
  if (limit < 0) return -limit;
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  tc_kernel<DP><<<n_bh * n_qtiles, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n_bh, group, s_q, s_kv, d, n_qtiles, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// q [n_bhkv * rows, d] (the rows of each kv head contiguous), k / v
// [n_bhkv, s_kv, d], o like q; part_ml [n_bhkv * n_splits * rows][2]
// and part_acc [n_bhkv * n_splits * rows][d] f32 scratch; dtype 0 =
// float32, 1 = bfloat16; d * sizeof(dtype) a multiple of 16, d <= 256,
// rows <= 64, split_len a multiple of 64 and n_splits splits covering
// s_kv with the last one non-empty.
extern "C" int flash_split_launch(const void* q, const void* k, const void* v,
                                  void* o, void* part_ml, void* part_acc,
                                  int n_bhkv, int rows, int s_q, int s_kv,
                                  int d, int n_splits, int split_len,
                                  float scale, int causal, int dtype,
                                  void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || d < 1 || d > 256 || (d * elem) % 16 ||
      rows < 1 || rows > 64 || s_q < 1 || rows % s_q || n_bhkv < 0 ||
      s_kv < 1 || split_len < 64 || split_len % 64 || n_splits < 1 ||
      (long long)(n_splits - 1) * split_len >= s_kv ||
      (long long)n_splits * split_len < s_kv) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bhkv == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (dtype == 0) {
    return split::launch<float>(q, k, v, o, ml, acc, n_bhkv, rows, s_q, s_kv,
                                d, n_splits, split_len, scale, causal, st);
  }
  return split::launch<__nv_bfloat16>(q, k, v, o, ml, acc, n_bhkv, rows, s_q,
                                      s_kv, d, n_splits, split_len, scale,
                                      causal, st);
}

// bf16 only: q [n_bh, s_q, d], k / v [n_bh / group, s_kv, d], o like q,
// all contiguous; d a multiple of 16, at most 256.
extern "C" int flash_tc_launch(const void* q, const void* k, const void* v,
                               void* o, int n_bh, int group, int s_q,
                               int s_kv, int d, float scale, int causal,
                               void* stream) {
  if (d < 16 || d > 256 || d % 16 || group < 1 || n_bh < 0 ||
      n_bh % group != 0 || s_q < 0 || s_kv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_bh == 0 || s_q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64) {
    return tc::launch<64>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                          causal, st);
  }
  if (d <= 128) {
    return tc::launch<128>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                           causal, st);
  }
  return tc::launch<256>(q, k, v, o, n_bh, group, s_q, s_kv, d, scale,
                         causal, st);
}
