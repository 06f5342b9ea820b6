// Paged-KV attention for serving on Hopper (sm_90a): single-query decode and
// the [B, s] speculative block-verify, one templated kernel over float and
// __nv_bfloat16 pools.
//
// Replaces accelerate_tpu/ops/paged_attention.py::_decode_kernel (s == 1) and
// ::_verify_kernel (s > 1). Same contract: query row (j, g) of slot b attends
// the columns `col <= pos[b, j]` of its logical cache, whose page p lives at
// pool page table[b, p] (clipped to [0, num_pages - 1]); pages with
// base >= max_j(pos[b, j]) + 1 are never read; the softmax is the online
// update of ops/flash_common.py in fp32, NEG_INF = -1e30, finalized against a
// 1e-30 floor so rows of inactive slots (pointed at scratch page 0) come out
// finite. Query head h * G + g rides KV head h (contiguous GQA groups).
//
// Bound: memory bandwidth. Each launch reads every live K/V page once,
// sum_b ceil(len_b / ps) * ps * Hkv * D * 2 * itemsize bytes per layer, and
// does ~4 * rows * len * D flops on it, far below the ridge point. The design
// keeps the gathered [B, L, Hkv, D] copy the plain path builds out of device
// memory: one thread block per (KV head h, slot b) loads its own page-table
// entries, turns each page id into a pointer offset and streams a tile of
// whole pages (up to kTileTokens tokens) of K and V into shared memory with
// 16-byte vector loads, converting to fp32 there. The s * G query rows keep
// m, l and acc[D] in shared memory; one warp folds each row's tile of scores
// into (m, l) with shuffles.
//
// B * Hkv blocks underfill the 132 SMs at small batch (8 slots x 8 KV heads =
// 64 blocks); splitting each slot's pages over several blocks with a second
// merge pass (flash-decoding), TMA page loads and tensor-core score products
// are later work.
//
// The kernel launches on the caller's stream, allocates nothing and never
// synchronises: the write of this dispatch's K/V into the pool, queued before
// it on the same stream, is complete when it reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;

// Whole pages per tile: at least one, and at most kTileTokens tokens when a
// page is smaller than that.
__host__ __device__ inline int tile_pages(int ps) { return ps >= kTileTokens ? 1 : kTileTokens / ps; }

// One 16-byte vector of T, widened to fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

__device__ inline void store(float* dst, float x) { *dst = x; }
__device__ inline void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out, int S, int Hq,
                       int Hkv, int D, int num_pages, int ps, int P, float scale) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = S * G;
  const int TP = tile_pages(ps);
  const int TT = TP * ps;   // tokens per full tile
  const int kd = D + 1;     // padded K row: the score loop reads K by column
  const int nv = Vec<T>::N;
  const int per_row = D / nv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;            // [R, D]
  float* acc = q_s + R * D;     // [R, D]
  float* k_s = acc + R * D;     // [TT, D + 1]
  float* v_s = k_s + TT * kd;   // [TT, D]
  float* p_s = v_s + TT * D;    // [R, TT] scores, then probabilities
  float* m_s = p_s + R * TT;    // [R]
  float* l_s = m_s + R;         // [R]
  float* c_s = l_s + R;         // [R] this tile's correction factor
  int* lim_s = reinterpret_cast<int*>(c_s + R);  // [S] per-query attend limit

  // Row r = j * G + g holds query head h * G + g of position j.
  for (int c = threadIdx.x; c < R * per_row; c += blockDim.x) {
    const int r = c / per_row;
    const int d0 = (c - r * per_row) * nv;
    const int j = r / G;
    const int g = r - j * G;
    float tmp[Vec<T>::N];
    Vec<T>::load(q + ((int64_t)(b * S + j) * Hq + h * G + g) * D + d0, tmp);
#pragma unroll
    for (int i = 0; i < Vec<T>::N; ++i) q_s[r * D + d0 + i] = tmp[i];
  }
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) lim_s[j] = pos[b * S + j];
  __syncthreads();

  int length = 0;  // max position + 1: pages at or past it hold no query's keys
  for (int j = 0; j < S; ++j) length = max(length, lim_s[j] + 1);
  const int n_pages = min(P, (length + ps - 1) / ps);
  const int64_t token_stride = (int64_t)Hkv * D;
  const int* row_table = table + (int64_t)b * P;

  for (int p0 = 0; p0 < n_pages; p0 += TP) {
    const int tl = min(TP, n_pages - p0) * ps;  // tokens in this tile
    const int base = p0 * ps;

    // Stream the tile's pages: token t of the tile is token t % ps of pool
    // page table[b, p0 + t / ps], KV head h.
    for (int c = threadIdx.x; c < tl * per_row; c += blockDim.x) {
      const int t = c / per_row;
      const int d0 = (c - t * per_row) * nv;
      const int pi = t / ps;
      const int page = min(max(row_table[p0 + pi], 0), num_pages - 1);
      const int64_t src = ((int64_t)page * ps + (t - pi * ps)) * token_stride + (int64_t)h * D + d0;
      float tmp[Vec<T>::N];
      Vec<T>::load(k_pool + src, tmp);
#pragma unroll
      for (int i = 0; i < Vec<T>::N; ++i) k_s[t * kd + d0 + i] = tmp[i];
      Vec<T>::load(v_pool + src, tmp);
#pragma unroll
      for (int i = 0; i < Vec<T>::N; ++i) v_s[t * D + d0 + i] = tmp[i];
    }
    __syncthreads();

    for (int i = threadIdx.x; i < R * tl; i += blockDim.x) {
      const int r = i / tl;
      const int t = i - r * tl;
      float s = kNegInf;
      if (base + t <= lim_s[r / G]) {
        const float* qr = q_s + r * D;
        const float* kt = k_s + t * kd;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * scale;
      }
      p_s[r * TT + t] = s;
    }
    __syncthreads();

    // One warp per row: m_new = max(m, max(s)), p = exp(s - m_new),
    // l = l * exp(m - m_new) + sum(p).
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * TT;
      float mx = kNegInf;
      for (int t = lane; t < tl; t += 32) mx = fmaxf(mx, pr[t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < tl; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = p_s + r * TT;
      float a = acc[i] * c_s[r];
      for (int t = 0; t < tl; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int j = r / G;
    const int g = r - j * G;
    store(out + ((int64_t)(b * S + j) * Hq + h * G + g) * D + d, acc[i] / fmaxf(l_s[r], kLFloor));
  }
}

size_t shared_bytes(int S, int Hq, int Hkv, int D, int ps) {
  const size_t R = (size_t)S * (Hq / Hkv);
  const size_t TT = (size_t)tile_pages(ps) * ps;
  return sizeof(float) * (2 * R * D + TT * (D + 1) + TT * D + R * TT + 3 * R) + sizeof(int) * S;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* pos, void* out, int B, int S, int Hq, int Hkv, int D, int num_pages,
           int ps, int P, float scale, void* stream) {
  // Dynamic shared memory above 48 KB needs an opt-in, which holds for the
  // current device only: set it on every such launch (a host-side attribute
  // write), so no state is kept across devices or threads.
  const size_t smem = shared_bytes(S, Hq, Hkv, D, ps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<T*>(out), S, Hq,
      Hkv, D, num_pages, ps, P, scale);
  return (int)cudaGetLastError();
}

int dispatch(int dtype, const void* q, const void* k_pool, const void* v_pool, const void* table,
             const void* pos, void* out, int B, int S, int Hq, int Hkv, int D, int num_pages,
             int ps, int P, float scale, void* stream) {
  if (dtype == 0) {
    return launch<float>(q, k_pool, v_pool, table, pos, out, B, S, Hq, Hkv, D, num_pages, ps, P,
                         scale, stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, pos, out, B, S, Hq, Hkv, D, num_pages,
                                 ps, P, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after its
// launch (0 = launched).
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, int B, int Hq,
                                   int Hkv, int D, int num_pages, int ps, int P, float scale,
                                   int dtype, void* stream) {
  return dispatch(dtype, q, k_pool, v_pool, table, pos, out, B, 1, Hq, Hkv, D, num_pages, ps, P,
                  scale, stream);
}

extern "C" int paged_verify_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, int B, int S,
                                   int Hq, int Hkv, int D, int num_pages, int ps, int P,
                                   float scale, int dtype, void* stream) {
  return dispatch(dtype, q, k_pool, v_pool, table, pos, out, B, S, Hq, Hkv, D, num_pages, ps, P,
                  scale, stream);
}

extern "C" unsigned long long paged_attention_shared_bytes(int S, int Hq, int Hkv, int D, int ps) {
  return (unsigned long long)shared_bytes(S, Hq, Hkv, D, ps);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
