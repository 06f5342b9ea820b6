// FlashAttention-2 forward and backward for training on Hopper (sm_90a), over
// float and __nv_bfloat16 inputs in the [B*H, S, D] layout, D in {32, 64, 128}.
//
// Replaces three TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   K3 flash_fwd_kernel     <- accelerate_tpu/ops/flash_attention.py::_fwd_kernel
//   K4 flash_bwd_dkv_kernel <- accelerate_tpu/ops/flash_attention.py::_bwd_dkv_kernel
//   K5 flash_bwd_dq_kernel  <- accelerate_tpu/ops/flash_attention.py::_bwd_dq_kernel
// Same contract: scores s = (q . k) * scale summed in fp32; causal masks are
// aligned bottom-right (query i sees keys j <= i + Sk - S); the forward keeps
// the online softmax of ops/flash_common.py (m, l, acc in fp32, NEG_INF =
// -1e30, finalized against a 1e-30 floor) and writes o in q's type and
// lse = m + log(l) as one fp32 value per row ([B*H, S], not the TPU's
// 128-lane broadcast); the backward recomputes p = exp(s - lse), and
// delta = rowsum(do * o) comes in from the caller, as on the TPU.
//
// Bound: operations. At the training shapes (S 2048, D 64) each (query, key)
// pair costs 4 * D operations forward and about 10 * D backward on data that
// is read once per tile, far above the card's ridge point. This first design
// does the products as fp32 FMAs on the CUDA cores over operands widened in
// shared memory: each row (a query row in K3 and K5, a key row in K4) is split
// over D / 16 threads that each hold 16 of its dimensions in registers, and
// the other side streams through shared memory in 64-row tiles that every
// thread reads as broadcasts, with the partial dot products summed by warp
// shuffles. One block takes 64 rows of one (batch, head), so the Llama-1B
// step's 2048-token sequences give 32 x B*H blocks, enough to fill 132 SMs;
// causal blocks walk only the tiles their rows can see, heaviest first.
//
// Left for later: tensor cores (mma.sync / wgmma over bf16 tiles, the only
// way near the 989 TFLOP/s bf16 peak), TMA loads into a ring of shared-memory
// stages, grouped-query heads folded into the kernel instead of repeated K/V,
// and one fused backward pass with atomic dQ.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr int kRows = 64;           // rows a block owns: queries (K3, K5) or keys (K4)
constexpr int kTile = 64;           // rows of the other side per shared-memory tile
constexpr int kDimsPerThread = 16;  // a row's dimensions per thread: 4 float4 chunks
constexpr int kChunks = kDimsPerThread / 4;
constexpr int kFold = 16;           // keys per online-softmax update in K3

// Four consecutive elements of T, widened to fp32 (and narrowed back).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ static float4 load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void store(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ static float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(pairs[0]);
    const float2 b = __bfloat1622float2(pairs[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Threads per row and their dimensions: thread t of a row holds float4 chunks
// c * TPR + t (c < kChunks), so the TPR threads of a row read neighbouring
// 16-byte words of a shared-memory row: no bank conflicts.
template <int D>
struct Split {
  static constexpr int TPR = D / kDimsPerThread;
  static constexpr int kThreads = kRows * TPR;
  __device__ static int dim(int c, int t) { return (c * TPR + t) * 4; }
};

// Sum over the TPR neighbouring lanes that share a row.
template <int TPR>
__device__ inline float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This thread's 16 dimensions of row `row` (zeros past `n`), widened.
template <typename T, int D>
__device__ inline void load_row(const T* base, int row, int n, int t, float* dst) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) x = Vec4<T>::load(base + (int64_t)row * D + Split<D>::dim(c, t));
    dst[4 * c] = x.x;
    dst[4 * c + 1] = x.y;
    dst[4 * c + 2] = x.z;
    dst[4 * c + 3] = x.w;
  }
}

template <typename T, int D>
__device__ inline void store_row(T* base, int row, int t, const float* src) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    Vec4<T>::store(base + (int64_t)row * D + Split<D>::dim(c, t),
                   make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2], src[4 * c + 3]));
  }
}

// This thread's part of the dot product of its registers with a shared row.
template <int D>
__device__ inline float dot_part(const float* regs, const float* row, int t) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(row + Split<D>::dim(c, t));
    acc = fmaf(regs[4 * c], x.x, acc);
    acc = fmaf(regs[4 * c + 1], x.y, acc);
    acc = fmaf(regs[4 * c + 2], x.z, acc);
    acc = fmaf(regs[4 * c + 3], x.w, acc);
  }
  return acc;
}

// regs += w * (this thread's dimensions of a shared row)
template <int D>
__device__ inline void axpy_part(float* regs, float w, const float* row, int t) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(row + Split<D>::dim(c, t));
    regs[4 * c] = fmaf(w, x.x, regs[4 * c]);
    regs[4 * c + 1] = fmaf(w, x.y, regs[4 * c + 1]);
    regs[4 * c + 2] = fmaf(w, x.z, regs[4 * c + 2]);
    regs[4 * c + 3] = fmaf(w, x.w, regs[4 * c + 3]);
  }
}

// Rows [r0, r0 + kTile) of a [n, D] array into a shared [kTile, D] fp32 tile,
// 16-byte loads by consecutive threads; rows at or past n are zeros, so that a
// masked lane multiplies finite values.
template <typename T, int D>
__device__ inline void load_tile(const T* base, int r0, int n, float* tile) {
  constexpr int per_row = D / 4;
  for (int c = threadIdx.x; c < kTile * per_row; c += Split<D>::kThreads) {
    const int r = c / per_row;
    const int d = (c - r * per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = Vec4<T>::load(base + (int64_t)(r0 + r) * D + d);
    *reinterpret_cast<float4*>(tile + r * D + d) = x;
  }
}

// Keys [0, end) hold every key that a causal row in [q0, q_last] can see.
__device__ inline int visible_end(int q_last, int offset, int Sk, int causal) {
  return causal ? min(Sk, q_last + offset + 1) : Sk;
}

// ------------------------------------------------------------------ K3
template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int Sk, float scale,
                 int causal) {
  constexpr int TPR = Split<D>::TPR;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal rows first
  const int t = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const int offset = Sk - S;
  const int limit = causal ? min(row + offset, Sk - 1) : Sk - 1;  // last key this row sees
  const int end = visible_end(min(q0 + kRows, S) - 1, offset, Sk, causal);

  extern __shared__ float smem[];
  float* k_s = smem;              // [kTile, D]
  float* v_s = smem + kTile * D;  // [kTile, D]
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;

  float qr[kDimsPerThread], acc[kDimsPerThread];
  load_row<T, D>(q + (int64_t)bh * S * D, row, S, t, qr);
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(kb, k0, Sk, k_s);
    load_tile<T, D>(vb, k0, Sk, v_s);
    __syncthreads();
    const int n = min(kTile, end - k0);
    for (int j0 = 0; j0 < n; j0 += kFold) {
      float s[kFold];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kFold; ++jj) {
        const float dot = row_sum<TPR>(dot_part<D>(qr, k_s + (j0 + jj) * D, t));
        s[jj] = (k0 + j0 + jj <= limit) ? dot * scale : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      // m_new = max(m, max(s)); p = exp(s - m_new); l = l * corr + sum(p);
      // acc = acc * corr + p @ v, corr = exp(m - m_new).
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kFold; ++jj) {
        s[jj] = expf(s[jj] - m_new);
        sum += s[jj];
      }
      l = l * corr + sum;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kFold; ++jj) axpy_part<D>(acc, s[jj], v_s + (j0 + jj) * D, t);
      m = m_new;
    }
  }

  if (row < S) {
    const float safe_l = fmaxf(l, kLFloor);
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] = acc[i] / safe_l;
    store_row<T, D>(o + (int64_t)bh * S * D, row, t, acc);
    if (t == 0) lse[(int64_t)bh * S + row] = m + logf(safe_l);
  }
}

// ------------------------------------------------------------------ K4
template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int Sk, float scale, int causal) {
  constexpr int TPR = Split<D>::TPR;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;  // the first key tiles see the most queries: first
  const int t = threadIdx.x % TPR;
  const int key = k0 + threadIdx.x / TPR;
  const int offset = Sk - S;
  // Query i sees key j iff j <= i + offset: rows before k0 - offset see none.
  const int i_first = causal ? max(0, k0 - offset) : 0;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [kTile, D]
  float* do_s = q_s + kTile * D;      // [kTile, D]
  float* lse_s = do_s + kTile * D;    // [kTile]
  float* delta_s = lse_s + kTile;     // [kTile]
  const T* qb = q + (int64_t)bh * S * D;
  const T* dob = dout + (int64_t)bh * S * D;

  float kr[kDimsPerThread], vr[kDimsPerThread], dkr[kDimsPerThread], dvr[kDimsPerThread];
  load_row<T, D>(k + (int64_t)bh * Sk * D, key, Sk, t, kr);
  load_row<T, D>(v + (int64_t)bh * Sk * D, key, Sk, t, vr);
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) dkr[i] = dvr[i] = 0.f;

  for (int i0 = (i_first / kTile) * kTile; i0 < S; i0 += kTile) {
    __syncthreads();
    load_tile<T, D>(qb, i0, S, q_s);
    load_tile<T, D>(dob, i0, S, do_s);
    for (int i = threadIdx.x; i < kTile; i += Split<D>::kThreads) {
      const bool in = i0 + i < S;
      lse_s[i] = in ? lse[(int64_t)bh * S + i0 + i] : 0.f;
      delta_s[i] = in ? delta[(int64_t)bh * S + i0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, S - i0);
    for (int i = 0; i < n; ++i) {
      const float* qi = q_s + i * D;
      const float* doi = do_s + i * D;
      const float s = row_sum<TPR>(dot_part<D>(kr, qi, t)) * scale;
      const float dp = row_sum<TPR>(dot_part<D>(vr, doi, t));
      const bool seen = key < Sk && (!causal || key <= i0 + i + offset);
      const float p = seen ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dp - delta_s[i]) * scale;
      axpy_part<D>(dvr, p, doi, t);   // dv += p^T @ do
      axpy_part<D>(dkr, ds, qi, t);   // dk += ds^T @ q
    }
  }

  if (key < Sk) {
    store_row<T, D>(dk + (int64_t)bh * Sk * D, key, t, dkr);
    store_row<T, D>(dv + (int64_t)bh * Sk * D, key, t, dvr);
  }
}

// ------------------------------------------------------------------ K5
template <typename T, int D>
__global__ void __launch_bounds__(Split<D>::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int Sk,
                    float scale, int causal) {
  constexpr int TPR = Split<D>::TPR;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int t = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const int offset = Sk - S;
  const int limit = causal ? min(row + offset, Sk - 1) : Sk - 1;
  const int end = visible_end(min(q0 + kRows, S) - 1, offset, Sk, causal);

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = smem + kTile * D;
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;

  float qr[kDimsPerThread], dor[kDimsPerThread], dqr[kDimsPerThread];
  load_row<T, D>(q + (int64_t)bh * S * D, row, S, t, qr);
  load_row<T, D>(dout + (int64_t)bh * S * D, row, S, t, dor);
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) dqr[i] = 0.f;
  const bool active = row < S;
  const float lse_r = active ? lse[(int64_t)bh * S + row] : 0.f;
  const float delta_r = active ? delta[(int64_t)bh * S + row] : 0.f;

  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(kb, k0, Sk, k_s);
    load_tile<T, D>(vb, k0, Sk, v_s);
    __syncthreads();
    const int n = min(kTile, end - k0);
    for (int j = 0; j < n; ++j) {
      const float* kj = k_s + j * D;
      const float s = row_sum<TPR>(dot_part<D>(qr, kj, t)) * scale;
      const float dp = row_sum<TPR>(dot_part<D>(dor, v_s + j * D, t));
      const float p = (k0 + j <= limit) ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - delta_r) * scale;
      axpy_part<D>(dqr, ds, kj, t);  // dq += ds @ k
    }
  }

  if (active) store_row<T, D>(dq + (int64_t)bh * S * D, row, t, dqr);
}

// ------------------------------------------------------------- launchers
// Dynamic shared memory above 48 KB needs an opt-in, which holds for the
// current device only: set it on every such launch.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

constexpr size_t kv_tile_bytes(int D) { return 2 * kTile * D * sizeof(float); }
constexpr size_t qdo_tile_bytes(int D) { return (2 * kTile * D + 2 * kTile) * sizeof(float); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse_in;
  const void* delta;
  void* out0;  // o (K3), dk (K4), dq (K5)
  void* out1;  // lse (K3), dv (K4)
  int BH, S, Sk;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_fwd(const Args& a) {
  const size_t smem = kv_tile_bytes(D);
  cudaError_t err = allow_shared(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kRows - 1) / kRows, a.BH);
  flash_fwd_kernel<T, D><<<grid, Split<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.out0), static_cast<float*>(a.out1), a.S, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = qdo_tile_bytes(D);
  cudaError_t err = allow_shared(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sk + kRows - 1) / kRows, a.BH);
  flash_bwd_dkv_kernel<T, D><<<grid, Split<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S,
      a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = kv_tile_bytes(D);
  cudaError_t err = allow_shared(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kRows - 1) / kRows, a.BH);
  flash_bwd_dq_kernel<T, D><<<grid, Split<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.S, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

enum Kind { kFwd, kDkv, kDq };

template <typename T, int D>
int launch_kind(Kind kind, const Args& a) {
  if (kind == kFwd) return launch_fwd<T, D>(a);
  if (kind == kDkv) return launch_dkv<T, D>(a);
  return launch_dq<T, D>(a);
}

template <typename T>
int launch_head_dim(Kind kind, int D, const Args& a) {
  if (D == 32) return launch_kind<T, 32>(kind, a);
  if (D == 64) return launch_kind<T, 64>(kind, a);
  if (D == 128) return launch_kind<T, 128>(kind, a);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16.
int dispatch(Kind kind, int dtype, int D, const Args& a) {
  if (a.BH <= 0 || a.S <= 0 || a.Sk <= 0 || a.BH > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_head_dim<float>(kind, D, a);
  if (dtype == 1) return launch_head_dim<__nv_bfloat16>(kind, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (0 = launched).
// q [BH, S, D]; k, v [BH, Sk, D]; o [BH, S, D] in q's type; lse [BH, S] fp32.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                int BH, int S, int Sk, int D, float scale, int causal,
                                int dtype, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, o, lse, BH, S, Sk, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, dtype, D, a);
}

// dk, dv [BH, Sk, D] in q's type, from do [BH, S, D], lse and delta [BH, S] fp32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    int BH, int S, int Sk, int D, float scale, int causal,
                                    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, BH, S, Sk, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDkv, dtype, D, a);
}

// dq [BH, S, D] in q's type.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, int BH, int S,
                                   int Sk, int D, float scale, int causal, int dtype,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, BH, S, Sk, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, dtype, D, a);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
