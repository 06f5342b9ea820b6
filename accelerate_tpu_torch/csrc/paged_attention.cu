// Paged-KV attention for serving on Hopper (sm_90a): single-query decode and
// the [B, s] speculative block-verify, one kernel templated on the query and
// output type (float, __nv_bfloat16) and the pool's storage type: the query
// type itself, or int8_t / __nv_fp8_e4m3 pages with per-page-per-head f32
// scales (the fused-dequant mode).
//
// Replaces accelerate_tpu/ops/paged_attention.py::_decode_kernel (s == 1) and
// ::_verify_kernel (s > 1), both with and without `quantized`. Same contract:
// query row (j, g) of slot b attends the columns `col <= pos[b, j]` of its
// logical cache, whose page p lives at pool page table[b, p] (clipped to
// [0, num_pages - 1]); pages with base >= max_j(pos[b, j]) + 1 are never
// read; the softmax is the online update of ops/flash_common.py in fp32,
// NEG_INF = -1e30, finalized against a 1e-30 floor so rows of inactive slots
// (pointed at scratch page 0) come out finite. Query head h * G + g rides KV
// head h (contiguous GQA groups). A quantized page's value is
// float(stored) * scale[page, h] in fp32, as the TPU kernel's fused multiply
// on the VMEM-resident block.
//
// Bound: memory bandwidth. Each launch reads every live K/V page once,
// sum_b ceil(len_b / ps) * ps * Hkv * D * 2 * itemsize bytes per layer
// (itemsize 1 for a quantized pool, plus 8 bytes of scales per live page and
// KV head), and does ~4 * rows * len * D flops on it, far below the ridge
// point. The design keeps the gathered [B, L, Hkv, D] copy the plain path
// builds out of device memory: one thread block per (KV head h, slot b)
// loads its own page-table entries, turns each page id into a pointer offset
// and streams a tile of whole pages (up to kTileTokens tokens) of K and V
// into shared memory with 16-byte vector loads (4 f32, 8 bf16 or 16 int8 or
// fp8 values), widening to fp32 and, for a quantized pool, multiplying by
// the token's page scale there; no dequantized copy of the pool exists
// anywhere. The s * G query rows keep m, l and acc[D] in shared memory; one
// warp folds each row's tile of scores into (m, l) with shuffles.
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
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    // Byte j of a little-endian word, sign-extended by an arithmetic shift.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[4 * i + j] = static_cast<float>(static_cast<int32_t>(words[i] << (24 - 8 * j)) >> 24);
      }
    }
  }
};

template <>
struct Vec<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void load(const __nv_fp8_e4m3* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_fp8x2_storage_t* pairs = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // e4m3 -> f16 is exact, and so is f16 -> f32.
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3)));
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

// T: query and output type. TS: the pool's storage type, T itself or a
// quantized type whose pages come with [num_pages, Hkv] f32 scales.
template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const TS* __restrict__ k_pool,
                       const TS* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ pos, T* __restrict__ out, int S, int Hq,
                       int Hkv, int D, int num_pages, int ps, int P, float scale) {
  constexpr bool kQuantized = !std::is_same<T, TS>::value;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = Hq / Hkv;
  const int R = S * G;
  const int TP = tile_pages(ps);
  const int TT = TP * ps;   // tokens per full tile
  const int kd = D + 1;     // padded K row: the score loop reads K by column
  const int nv = Vec<T>::N;     // query values per 16-byte load
  const int per_row = D / nv;
  const int nkv = Vec<TS>::N;   // pool values per 16-byte load
  const int kv_per_row = D / nkv;
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
    // page table[b, p0 + t / ps], KV head h. A tile spans several pages, so a
    // quantized value takes the scale of its own token's page.
    for (int c = threadIdx.x; c < tl * kv_per_row; c += blockDim.x) {
      const int t = c / kv_per_row;
      const int d0 = (c - t * kv_per_row) * nkv;
      const int pi = t / ps;
      const int page = min(max(row_table[p0 + pi], 0), num_pages - 1);
      const int64_t src = ((int64_t)page * ps + (t - pi * ps)) * token_stride + (int64_t)h * D + d0;
      float ks = 1.f, vs = 1.f;
      if constexpr (kQuantized) {
        ks = k_scale[(int64_t)page * Hkv + h];
        vs = v_scale[(int64_t)page * Hkv + h];
      }
      float tmp[Vec<TS>::N];
      Vec<TS>::load(k_pool + src, tmp);
#pragma unroll
      for (int i = 0; i < Vec<TS>::N; ++i) k_s[t * kd + d0 + i] = kQuantized ? tmp[i] * ks : tmp[i];
      Vec<TS>::load(v_pool + src, tmp);
#pragma unroll
      for (int i = 0; i < Vec<TS>::N; ++i) v_s[t * D + d0 + i] = kQuantized ? tmp[i] * vs : tmp[i];
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

template <typename T, typename TS>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* table, const void* pos, void* out, int B, int S,
           int Hq, int Hkv, int D, int num_pages, int ps, int P, float scale, void* stream) {
  // Dynamic shared memory above 48 KB needs an opt-in, which holds for the
  // current device only: set it on every such launch (a host-side attribute
  // write), so no state is kept across devices or threads. The tiles are fp32
  // whatever the pool's storage type, so the size does not depend on it.
  const size_t smem = shared_bytes(S, Hq, Hkv, D, ps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T, TS><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const TS*>(k_pool), static_cast<const TS*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(pos), static_cast<T*>(out), S, Hq,
      Hkv, D, num_pages, ps, P, scale);
  return (int)cudaGetLastError();
}

// dtype (q, out): 0 = float32, 1 = bfloat16. kv_dtype (pools): -1 = q's
// dtype, unquantized; 0 = int8, 1 = fp8 e4m3, with f32 scales.
template <typename T>
int dispatch_pool(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale, const void* table, const void* pos,
                  void* out, int B, int S, int Hq, int Hkv, int D, int num_pages, int ps, int P,
                  float scale, void* stream) {
  if (kv_dtype == -1) {
    return launch<T, T>(q, k_pool, v_pool, nullptr, nullptr, table, pos, out, B, S, Hq, Hkv, D,
                        num_pages, ps, P, scale, stream);
  }
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == 0) {
    return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out, B, S, Hq,
                             Hkv, D, num_pages, ps, P, scale, stream);
  }
  if (kv_dtype == 1) {
    return launch<T, __nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out, B, S,
                                    Hq, Hkv, D, num_pages, ps, P, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* table, const void* pos,
             void* out, int B, int S, int Hq, int Hkv, int D, int num_pages, int ps, int P,
             float scale, void* stream) {
  if (dtype == 0) {
    return dispatch_pool<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out,
                                B, S, Hq, Hkv, D, num_pages, ps, P, scale, stream);
  }
  if (dtype == 1) {
    return dispatch_pool<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table,
                                        pos, out, B, S, Hq, Hkv, D, num_pages, ps, P, scale,
                                        stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Unquantized pools of q's dtype (0 = float32, 1 = bfloat16). Each entry
// point returns cudaGetLastError() after its launch (0 = launched).
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, int B, int Hq,
                                   int Hkv, int D, int num_pages, int ps, int P, float scale,
                                   int dtype, void* stream) {
  return dispatch(dtype, -1, q, k_pool, v_pool, nullptr, nullptr, table, pos, out, B, 1, Hq, Hkv,
                  D, num_pages, ps, P, scale, stream);
}

extern "C" int paged_verify_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, int B, int S,
                                   int Hq, int Hkv, int D, int num_pages, int ps, int P,
                                   float scale, int dtype, void* stream) {
  return dispatch(dtype, -1, q, k_pool, v_pool, nullptr, nullptr, table, pos, out, B, S, Hq, Hkv,
                  D, num_pages, ps, P, scale, stream);
}

// Quantized pools (kv_dtype 0 = int8, 1 = fp8 e4m3) with their [num_pages,
// Hkv] f32 scales; D must be a multiple of 16 (one 16-byte load per 16
// values).
extern "C" int paged_decode_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* table, const void* pos, void* out, int B,
                                         int Hq, int Hkv, int D, int num_pages, int ps, int P,
                                         float scale, int dtype, int kv_dtype, void* stream) {
  return dispatch(dtype, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out, B, 1, Hq,
                  Hkv, D, num_pages, ps, P, scale, stream);
}

extern "C" int paged_verify_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* table, const void* pos, void* out, int B,
                                         int S, int Hq, int Hkv, int D, int num_pages, int ps,
                                         int P, float scale, int dtype, int kv_dtype,
                                         void* stream) {
  return dispatch(dtype, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out, B, S, Hq,
                  Hkv, D, num_pages, ps, P, scale, stream);
}

extern "C" unsigned long long paged_attention_shared_bytes(int S, int Hq, int Hkv, int D, int ps) {
  return (unsigned long long)shared_bytes(S, Hq, Hkv, D, ps);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
