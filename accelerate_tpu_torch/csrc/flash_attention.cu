// FlashAttention-2 forward and backward for training on Hopper (sm_90a), over
// float, __nv_bfloat16 and __half inputs in the [B*H, S, D] layout, D in
// {16, 32, 64, 96, 128, 256}.
//
// Replaces three TPU kernels of accelerate_tpu/ops/flash_attention.py:
//   K3 forward: flash_fwd_wgmma_kernel<T = bf16 | f16>, flash_fwd_kernel (f32)
//      <- accelerate_tpu/ops/flash_attention.py::_fwd_kernel
//   K4 dK, dV: flash_bwd_dkv_wgmma_kernel<T = bf16 | f16>, flash_bwd_dkv_kernel (f32)
//      <- accelerate_tpu/ops/flash_attention.py::_bwd_dkv_kernel
//   K5 dQ: flash_bwd_dq_wgmma_kernel<T = bf16 | f16>, flash_bwd_dq_kernel (f32)
//      <- accelerate_tpu/ops/flash_attention.py::_bwd_dq_kernel
// Same contract: scores s = (q . k) * scale summed in fp32; causal masks are
// aligned bottom-right (query i sees keys j <= i + Sk - S); the forward keeps
// the online softmax of ops/flash_common.py (m, l, acc in fp32, NEG_INF =
// -1e30, finalized against a 1e-30 floor) and writes o in q's type and
// lse = m + log(l) as one fp32 value per row ([B*H, S], not the TPU's
// 128-lane broadcast); the backward recomputes p = exp(s - lse), and
// delta = rowsum(do * o) comes in from the caller, as on the TPU.
//
// Bound: operations. At the training shapes (S 2048, D 64, causal) each
// (query, key) pair costs 4 * D operations forward, 8 * D for dK/dV and 6 * D
// for dQ on data read once per tile, far above the card's ridge point: the
// tensor cores' 989 TFLOP/s bf16 (and fp16) is the ceiling, and the CUDA
// cores' 67 TFLOP/s fp32 one fifteen times lower.
//
// bf16 and fp16 (mixed_precision="fp16"): the products run on the tensor
// cores, in one kernel per product templated on the element type: the same
// tiles, descriptors and swizzles (both types are two bytes), the wgmma
// instruction .bf16 or .f16, the tensor map BFLOAT16 or FLOAT16. Below,
// "bf16" stands for both where nothing else is said. One warpgroup owns 64 rows of
// one side: query rows in K3 and K5, whose Q tile (and dO for K5) arrives
// once by TMA while K/V tiles stream past; keys in K4, whose K and V tiles
// arrive once while Q/dO tiles stream past. The streamed tiles go through a
// two-stage ring of shared memory, loaded by TMA with mbarrier completion, so
// the copy of tile j + 2 overlaps the products of tile j + 1, and several
// blocks on each SM overlap one another's softmax with their tensor-core
// work. Tiles stay bf16 in shared memory, swizzled (128B for D 64, 128 and
// 256, 64B for D 32 and 96, 32B for D 16) as the wgmma descriptors read them
// (flash_tiles.cuh). The
// score products (s = q.k^T, dp = do.v^T; in K4 their transposes
// sT = k.q^T, dpT = v.do^T) are wgmmas with both operands in shared memory,
// K-major; the fp32 accumulator, narrowed to bf16 pairs, is already the
// register A operand of the next wgmma (o += p.v, dq += ds.k; dv += pT.do,
// dk += dsT.q), which reads its tile MN-major from the same shared memory, so
// P and dS never touch shared memory. The online softmax works on the
// accumulator registers, row max and sum over the four lanes that share a
// row, masks only on tiles that cross the diagonal, S or Sk, and keeps l
// from the fp32 p before p is rounded to bf16 (to nearest), as
// FlashAttention-2/3 and SDPA do. That rounding moves o by at most
// 2^-8 (P @ |V|), dq by at most 2^-8 (|dS| @ |K|), dv by at most
// 2^-8 (P^T @ |dO|) and dk by at most 2^-8 (|dS|^T @ |Q|), element by
// element, which chip_smoke.py adds to their bf16 limit; in fp16 the unit is
// 2^-11, and P and dS are scaled by powers of two before they are narrowed,
// so that neither overflows fp16's 65504 nor goes subnormal below 2^-14
// (the fp16 range note below). K3 walks 128-key
// tiles (64 at D 96 and above), K5 64-key tiles, K4 64-row query tiles
// (PERF.md). In K4, lse and delta belong to the columns of the transposed
// scores; the threads stage them for the next query tile in shared memory.
//
// D 256 is bound by registers: one fp32 accumulator of 64 rows x 256
// columns is 128 registers a thread of the warpgroup. K3 (o) and K5 (dq)
// hold one beside their 64-key score tiles (about 200 registers, ptxas'
// report in chip_smoke.py's [build] lines). K4 would hold two, dK and dV,
// 256 registers, over the 255 a thread may have, so at D 256 its grid has a
// third dimension over the two halves of D: each block owns dK and dV for
// 128 of the 256 columns and recomputes sT = k.q^T and dpT = v.do^T over the
// full D, as the other half's block does. That costs K4 1.5x its products
// (6 D instead of 4 D operations a pair) and keeps D 128's register shape;
// two consumer warpgroups sharing pT and dsT through shared memory would
// save the recompute, and are left for later. Shared memory at D 256: K3's
// Q tile (32 KB) and two stages of 64-key K/V tiles (128 KB); K5 and K4 add
// a second fixed tile (dO; K, V), 193 KB each, one block per SM.
//
// f32 keeps the first design: products as fp32 FMAs on the CUDA cores
// over operands in shared memory, each row (a query row in K3 and K5, a key
// row in K4) split over a power of two of threads holding 16 of its
// dimensions each (12 at D 96; one thread a row at D 16; Split below), the
// other side streamed through shared memory in 64-row tiles read as
// broadcasts, partial dot products summed by warp shuffles. The tensor cores
// have no f32 mode, only TF32, whose 10-bit mantissa would break the f32
// parity that chip_smoke.py's training phase and the card tests hold at
// 2e-5 / 1e-4. dispatch() chooses by dtype, explicitly: it is no fallback. A
// bf16 or fp16 tensor launches its wgmma kernel or the launch returns an error (a
// failed tensor-map encode, too much shared memory, a refused launch), which
// ops/flash_attention.py raises.
//
// Grids: one block per (64 query rows, B*H) for K3 and K5 (32 x B*H at the
// Llama-1B step's 2048-token sequences), causal blocks walking only the key
// tiles their rows can see, the heaviest first; one per (64 keys, B*H) for
// K4, walking only the query tiles whose rows can see its keys, the lowest
// keys (the most queries) first: the scalar kernel per head, the wgmma
// kernel over all heads (grid (B*H, keys / 64), 4% faster than per head at
// the training shape, PERF.md).
//
// Left for later: grouped-query K/V heads folded into K4 (K/V read once per
// group, dK/dV summed over the group) instead of repeated; warp
// specialisation, a producer warp issuing the TMA loads with its registers
// given to the consumers by setmaxnreg; ping-pong of two consumer
// warpgroups, so one's softmax hides behind the other's products; and one
// fused backward pass with atomic dQ.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "flash_tiles.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr int kRows = 64;  // rows a wgmma block owns: queries (K3, K5) or keys (K4)
constexpr int kTile = 64;  // rows of the other side per shared-memory tile
constexpr int kFold = 16;  // keys per online-softmax update in the scalar K3

// Four consecutive elements of T (the scalar kernels run in f32 only).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ static float4 load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void store(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
};

// The scalar kernels' split of a row over threads. Thread t of a row holds
// float4 chunks c * TPR + t (c < kChunks), so the TPR threads of a row read
// neighbouring 16-byte words of a shared-memory row: no bank conflicts. TPR
// must be a power of two, for the xor shuffles of row_sum: 16 dimensions a
// thread, 12 (three chunks) at D 96, where 16 would give TPR 6. A block owns
// kRows rows: 64, and 32 at D 256, where 64 rows of 16 lanes would make
// 1024-thread blocks of at most 64 registers a thread, fewer than K4's four
// 16-value rows need; 32 rows make 512 threads of up to 128.
template <int D>
struct Split {
  static constexpr int kDims = D == 96 ? 12 : 16;
  static constexpr int kChunks = kDims / 4;
  static constexpr int TPR = D / kDims;
  static constexpr int kRows = D == 256 ? 32 : 64;
  static constexpr int kThreads = kRows * TPR;
  static_assert(TPR * kDims == D && (TPR & (TPR - 1)) == 0 && TPR <= 32, "a power of two of lanes a row");
  __device__ static int dim(int c, int t) { return (c * TPR + t) * 4; }
};

// Sum over the TPR neighbouring lanes that share a row.
template <int TPR>
__device__ inline float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// This thread's dimensions of row `row` (zeros past `n`), widened.
template <typename T, int D>
__device__ inline void load_row(const T* base, int row, int n, int t, float* dst) {
#pragma unroll
  for (int c = 0; c < Split<D>::kChunks; ++c) {
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
  for (int c = 0; c < Split<D>::kChunks; ++c) {
    Vec4<T>::store(base + (int64_t)row * D + Split<D>::dim(c, t),
                   make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2], src[4 * c + 3]));
  }
}

// This thread's part of the dot product of its registers with a shared row.
template <int D>
__device__ inline float dot_part(const float* regs, const float* row, int t) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < Split<D>::kChunks; ++c) {
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
  for (int c = 0; c < Split<D>::kChunks; ++c) {
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
  constexpr int TPR = Split<D>::TPR, kDims = Split<D>::kDims, kBlockRows = Split<D>::kRows;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // the longest causal rows first
  const int t = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const int offset = Sk - S;
  const int limit = causal ? min(row + offset, Sk - 1) : Sk - 1;  // last key this row sees
  const int end = visible_end(min(q0 + kBlockRows, S) - 1, offset, Sk, causal);

  extern __shared__ float smem[];
  float* k_s = smem;              // [kTile, D]
  float* v_s = smem + kTile * D;  // [kTile, D]
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;

  float qr[kDims], acc[kDims];
  load_row<T, D>(q + (int64_t)bh * S * D, row, S, t, qr);
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;
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
      for (int i = 0; i < kDims; ++i) acc[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < kFold; ++jj) axpy_part<D>(acc, s[jj], v_s + (j0 + jj) * D, t);
      m = m_new;
    }
  }

  if (row < S) {
    const float safe_l = fmaxf(l, kLFloor);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] = acc[i] / safe_l;
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
  constexpr int TPR = Split<D>::TPR, kDims = Split<D>::kDims, kBlockRows = Split<D>::kRows;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;  // the first key tiles see the most queries: first
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

  float kr[kDims], vr[kDims], dkr[kDims], dvr[kDims];
  load_row<T, D>(k + (int64_t)bh * Sk * D, key, Sk, t, kr);
  load_row<T, D>(v + (int64_t)bh * Sk * D, key, Sk, t, vr);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dkr[i] = dvr[i] = 0.f;

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
  constexpr int TPR = Split<D>::TPR, kDims = Split<D>::kDims, kBlockRows = Split<D>::kRows;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;
  const int t = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const int offset = Sk - S;
  const int limit = causal ? min(row + offset, Sk - 1) : Sk - 1;
  const int end = visible_end(min(q0 + kBlockRows, S) - 1, offset, Sk, causal);

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = smem + kTile * D;
  const T* kb = k + (int64_t)bh * Sk * D;
  const T* vb = v + (int64_t)bh * Sk * D;

  float qr[kDims], dor[kDims], dqr[kDims];
  load_row<T, D>(q + (int64_t)bh * S * D, row, S, t, qr);
  load_row<T, D>(dout + (int64_t)bh * S * D, row, S, t, dor);
#pragma unroll
  for (int i = 0; i < kDims; ++i) dqr[i] = 0.f;
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

// ----------------------------------------------- bf16 and fp16: wgmma
// K3 and K5: one warpgroup owns 64 query rows; its Q (and dO) tile arrives
// once by TMA, and K/V tiles of kN keys stream through a ring of kStages
// stages, loaded by thread 0 as soon as a stage is free. Scores and products accumulate in
// fp32 registers (flash_tiles.cuh's Frag layout: rows r and r + 8, two
// neighbouring columns per 8-column chunk).
using flash_tiles::Frag;
using flash_tiles::PairRing;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// fp16's range. fp16 keeps 11 significant bits but tops out at 65504, and
// its normal range ends at 2^-14 below; bf16 has fp32's range. So in fp16
// every fp32 value narrowed for the tensor cores is first scaled by a power
// of two, and the fp32 accumulator that sums its products is scaled back
// by the inverse power at the end; each scaling is exact, and bf16 takes
// none of it.
//  - P (at most 1) is narrowed as P * 2^15, so that probabilities down to
//    2^-29 keep full precision instead of going subnormal below 2^-14. The
//    factor costs nothing: it is a bias of 15 in the base-2 exponent that
//    computes P (K3: from m - 15, its l summing the scaled P, so that o =
//    acc / l needs no unscaling; K4: from lse - 15).
//  - dS has no bound ahead of time: under loss scaling dO arrives
//    multiplied by up to 65536, and dS with it. Each accumulator row (a
//    query row in K5, a key row in K4) keeps the exponent e of the largest
//    |dS| it has seen and narrows dS as dS * 2^(kDsTop - e), its largest
//    value in [2^14, 2^15); when a tile raises e, the row's accumulator is
//    multiplied by 2^(e_old - e_new) before the tile's product is added, and
//    by 2^(e - kDsTop) at the end. So dS never overflows fp16 where its
//    products still fit (the plain version keeps dS in fp32, as JAX does),
//    and each element keeps 11 bits down to 2^-28 of its row's largest.
template <typename T>
constexpr float kPBias = flash_tiles::Elem<T>::kHalf ? 15.f : 0.f;  // P is narrowed as P * 2^kPBias
constexpr float kPUnscale = 1.f / 32768.f;
constexpr int kDsTop = 14;
constexpr int kDsMinExp = -64;  // a row whose every dS is below 2^-64 is scaled as if it were 2^-64

// 2^n for -126 <= n <= 127, exactly; 0 below.
__device__ __forceinline__ float pow2(int n) { return n < -126 ? 0.f : __int_as_float((n + 127) << 23); }

// floor(log2(x)) for a normal x >= 0 (-127 for 0 and subnormals, 128 for inf and NaN).
__device__ __forceinline__ int exponent_of(float x) { return (__float_as_int(x) >> 23) - 127; }

// fp16 dS narrowing for the accumulator rows of one thread (rows h = 0, 1 of
// the Frag layout), as set out above.
struct DsRange {
  int e[2] = {kDsMinExp, kDsMinExp};

  // This tile's ds = g * scale, narrowed in place from g = p * (dp - delta)
  // (one multiply per element, as bf16's ds = g * scale: the power of two
  // rides on the scale exactly), and `acc` rescaled where a row's exponent
  // grew (skipped, warp by warp, where none did: the usual case once a
  // row's largest values have been seen).
  template <int NF, int NA>
  __device__ __forceinline__ void narrow(float (&g)[NF], float scale, float (&acc)[NA]) {
    float mx[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NF; ++i) mx[Frag::half(i)] = fmaxf(mx[Frag::half(i)], fabsf(g[i]));
    float mul[2], corr[2];
    bool grew = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int top = max(e[h], exponent_of(flash_tiles::quad_max(mx[h]) * scale));
      grew |= top != e[h];
      corr[h] = pow2(e[h] - top);
      mul[h] = pow2(kDsTop - top) * scale;
      e[h] = top;
    }
#pragma unroll
    for (int i = 0; i < NF; ++i) g[i] *= mul[Frag::half(i)];
    if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] *= corr[Frag::half(i)];
    }
  }

  // The factor that takes row h's accumulator back to dS's own scale.
  __device__ __forceinline__ float unscale(int h) const { return pow2(e[h] - kDsTop); }
};

template <typename T>
constexpr bool kHalf = flash_tiles::Elem<T>::kHalf;

// kFixed 64-row tiles (Q; Q and dO; K and V), the ring, the barriers (the
// ring's and one per fixed tile), then kRowVals fp32 values (K4: lse and
// delta of two query tiles).
template <int D, int kN, int kStages, int kFixed, int kRowVals = 0>
struct WgmmaSmem {
  static constexpr int kFixedBytes = flash_tiles::Panels<D>::tile_bytes(kRows);
  static constexpr int kRing = kFixed * kFixedBytes;
  static constexpr int kBars = kRing + PairRing<D, kN, kStages>::kBytes;
  static constexpr int kFixedBars = kBars + PairRing<D, kN, kStages>::kBarBytes;
  static constexpr int kRowVal = kFixedBars + 8 * kFixed;
  static constexpr int kBytes = kRowVal + 4 * kRowVals + 1024;  // + alignment
};

// True where key `key` is hidden from query row `row`: past Sk, or past the
// bottom-right causal diagonal.
__device__ __forceinline__ bool hidden(int key, int row, int Sk, int offset, int causal) {
  return key >= Sk || (causal && key > row + offset);
}

template <typename T, int D, int kN, int kStages>
__global__ void __launch_bounds__(flash_tiles::kWarpgroup)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                       float* __restrict__ lse, int S, int Sk, float scale, int causal) {
  using L = WgmmaSmem<D, kN, kStages, 1>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = flash_tiles::align_1024(flash_tiles::smem_u32(smem_raw));
  const uint32_t q_tile = base;
  const PairRing<D, kN, kStages> ring(base + L::kRing, base + L::kBars);
  const uint32_t q_bar = base + L::kFixedBars;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest causal rows first
  const int offset = Sk - S;
  const int end = visible_end(min(q0 + kRows, S) - 1, offset, Sk, causal);
  const int n_tiles = (end + kN - 1) / kN;
  if (threadIdx.x == 0) {
    ring.init();
    flash_tiles::mbar_init(q_bar, 1);
    flash_tiles::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    flash_tiles::load_tile<D, kRows>(q_tile, &tq, q_bar, q0, bh);
    for (int j = 0; j < kStages && j < n_tiles; ++j) ring.issue(j, &tk, &tv, bh, j * kN);
  }

  const Frag f;
  const int row0 = q0 + f.row;
  const float scale_log2 = scale * kLog2e;  // scores in base-2 units: exp(x) = exp2(x log2 e)
  float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  flash_tiles::mbar_wait(q_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    float s[kN / 2];
    ring.wait_first(j);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_rows<T, D, kRows, kN>(s, q_tile, ring.first(j));  // s = q . k^T
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(s);

    // m_new = max(m, max(s)); p = exp(s - m_new); l = l * corr + sum(p);
    // acc = acc * corr + p @ v, corr = exp(m - m_new); masked lanes at NEG_INF,
    // only on tiles that cross the diagonal or Sk.
    const int k0 = j * kN;
    const bool edge = k0 + kN > Sk || (causal && k0 + kN - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int h = Frag::half(i);
      float x = s[i] * scale_log2;
      if (edge && hidden(k0 + f.column(i), row0 + 8 * h, Sk, offset, causal)) x = kNegInf;
      s[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float corr[2], mb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = flash_tiles::quad_max(mx[h]);
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      mb[h] = m[h] - kPBias<T>;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      s[i] = exp2f(s[i] - mb[Frag::half(i)]);
      l[Frag::half(i)] += s[i];  // the fp32 p, before p is rounded to T for p @ v
    }
    uint32_t p[kN / 16][4];
    flash_tiles::to_fragments<T>(s, p);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[Frag::half(i)];

    ring.wait_second(j);
    flash_tiles::fence_operands(acc);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_regs<T, D, kN>(acc, p, ring.second(j));  // acc += p . v
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(acc);
    __syncthreads();  // every warp is done with stage j % kStages
    if (threadIdx.x == 0 && j + kStages < n_tiles) ring.issue(j + kStages, &tk, &tv, bh, (j + kStages) * kN);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const float safe_l = fmaxf(flash_tiles::quad_sum(l[h]), kLFloor);
    if (row >= S) continue;
    T* out = o + ((int64_t)bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c + f.col) =
          flash_tiles::Elem<T>::pack(acc[4 * c + 2 * h] / safe_l, acc[4 * c + 2 * h + 1] / safe_l);
    if (f.col == 0) lse[(int64_t)bh * S + row] = (m[h] - kPBias<T>) * kLn2 + logf(safe_l);
  }
}

template <typename T, int D, int kN, int kStages>
__global__ void __launch_bounds__(flash_tiles::kWarpgroup)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dq, int S, int Sk, float scale, int causal) {
  using L = WgmmaSmem<D, kN, kStages, 2>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = flash_tiles::align_1024(flash_tiles::smem_u32(smem_raw));
  const uint32_t q_tile = base, do_tile = base + L::kFixedBytes;
  const PairRing<D, kN, kStages> ring(base + L::kRing, base + L::kBars);
  const uint32_t q_bar = base + L::kFixedBars, do_bar = q_bar + 8;

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int offset = Sk - S;
  const int end = visible_end(min(q0 + kRows, S) - 1, offset, Sk, causal);
  const int n_tiles = (end + kN - 1) / kN;
  if (threadIdx.x == 0) {
    ring.init();
    flash_tiles::mbar_init(q_bar, 1);
    flash_tiles::mbar_init(do_bar, 1);
    flash_tiles::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    flash_tiles::load_tile<D, kRows>(q_tile, &tq, q_bar, q0, bh);
    flash_tiles::load_tile<D, kRows>(do_tile, &tdo, do_bar, q0, bh);
    for (int j = 0; j < kStages && j < n_tiles; ++j) ring.issue(j, &tk, &tv, bh, j * kN);
  }

  const Frag f;
  const int row0 = q0 + f.row;
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];  // lse in base-2 units, delta: per row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    lse2[h] = row < S ? lse[(int64_t)bh * S + row] * kLog2e : 0.f;
    dlt[h] = row < S ? delta[(int64_t)bh * S + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  [[maybe_unused]] DsRange range;  // fp16 only
  flash_tiles::mbar_wait(q_bar, 0);
  flash_tiles::mbar_wait(do_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    float s[kN / 2], dp[kN / 2];
    ring.wait_first(j);
    ring.wait_second(j);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_rows<T, D, kRows, kN>(s, q_tile, ring.first(j));    // s = q . k^T
    flash_tiles::gemm_rows<T, D, kRows, kN>(dp, do_tile, ring.second(j));  // dp = do . v^T
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(s);
    flash_tiles::fence_operands(dp);

    // p = exp(s * scale - lse), 0 where hidden; ds = p * (dp - delta) * scale.
    const int k0 = j * kN;
    const bool edge = k0 + kN > Sk || (causal && k0 + kN - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int h = Frag::half(i);
      float p = exp2f(fmaf(s[i], scale_log2, -lse2[h]));
      if (edge && hidden(k0 + f.column(i), row0 + 8 * h, Sk, offset, causal)) p = 0.f;
      const float g = p * (dp[i] - dlt[h]);
      s[i] = kHalf<T> ? g : g * scale;  // fp16: ds = g * scale in `narrow`
    }
    if constexpr (kHalf<T>) range.narrow(s, scale, acc);
    uint32_t ds[kN / 16][4];
    flash_tiles::to_fragments<T>(s, ds);

    flash_tiles::fence_operands(acc);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_regs<T, D, kN>(acc, ds, ring.first(j));  // dq += ds . k
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(acc);
    __syncthreads();
    if (threadIdx.x == 0 && j + kStages < n_tiles) ring.issue(j + kStages, &tk, &tv, bh, (j + kStages) * kN);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    T* out = dq + ((int64_t)bh * S + row) * D;
    const float back = kHalf<T> ? range.unscale(h) : 1.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c + f.col) =
          flash_tiles::Elem<T>::pack(acc[4 * c + 2 * h] * back, acc[4 * c + 2 * h + 1] * back);
  }
}

// K4, bf16: K5 turned the other way. One warpgroup owns 64 keys; its K and V
// tiles arrive once by TMA, and Q and dO tiles of kM query rows stream through
// the ring, from the first tile whose rows can see the block's keys to S.
// sT = k.q^T and dpT = v.do^T are [64 keys, kM queries] accumulators, so lse
// and delta belong to their columns: the threads stage both for the next tile
// in shared memory while the current one is in the tensor cores. With
// kSplit 2 (D 256) block z of the grid owns columns [z D / 2, (z + 1) D / 2)
// of dK and dV and computes sT and dpT over the full D, as the other does.
template <typename T, int D, int kM, int kStages, int kSplit>
__global__ void __launch_bounds__(flash_tiles::kWarpgroup)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv, int S, int Sk,
                           float scale, int causal) {
  static_assert(2 * kM <= flash_tiles::kWarpgroup, "one staged lse or delta value per thread");
  using L = WgmmaSmem<D, kM, kStages, 2, 4 * kM>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = flash_tiles::align_1024(flash_tiles::smem_u32(smem_raw));
  const uint32_t k_tile = base, v_tile = base + L::kFixedBytes;
  const PairRing<D, kM, kStages> ring(base + L::kRing, base + L::kBars);  // Q, dO
  const uint32_t k_bar = base + L::kFixedBars, v_bar = k_bar + 8;
  // Two buffers of [lse in base-2 units, delta] for kM query rows each.
  float* rows_s = reinterpret_cast<float*>(smem_raw + (base + L::kRowVal - flash_tiles::smem_u32(smem_raw)));

  constexpr int kOutCols = D / kSplit;  // the columns of dK and dV this block owns
  const int col0 = blockIdx.z * kOutCols;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;  // every head's first key tiles see the most queries: first
  const int offset = Sk - S;
  // Query i sees key j iff j <= i + offset: rows before k0 - offset see none.
  const int t0 = (causal ? max(0, k0 - offset) : 0) / kM;
  const int n_tiles = (S + kM - 1) / kM - t0;  // >= 1: k0 < Sk
  const float scale_log2 = scale * kLog2e;

  // Thread r < kM stages lse of row r of a tile, kM <= r < 2 kM its delta.
  const int r = threadIdx.x % kM;
  auto row_value = [&](int j) {
    const int row = (t0 + j) * kM + r;
    if (threadIdx.x >= 2 * kM || j >= n_tiles || row >= S) return 0.f;
    const int64_t at = (int64_t)bh * S + row;
    return threadIdx.x < kM ? __ldg(lse + at) * kLog2e - kPBias<T> : __ldg(delta + at);
  };
  if (threadIdx.x < 2 * kM) rows_s[threadIdx.x] = row_value(0);
  if (threadIdx.x == 0) {
    ring.init();
    flash_tiles::mbar_init(k_bar, 1);
    flash_tiles::mbar_init(v_bar, 1);
    flash_tiles::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    flash_tiles::load_tile<D, kRows>(k_tile, &tk, k_bar, k0, bh);
    flash_tiles::load_tile<D, kRows>(v_tile, &tv, v_bar, k0, bh);
    for (int j = 0; j < kStages && j < n_tiles; ++j) ring.issue(j, &tq, &tdo, bh, (t0 + j) * kM);
  }

  const Frag f;
  const int key0 = k0 + f.row;  // this thread's keys: key0 and key0 + 8
  float dk_acc[kOutCols / 2], dv_acc[kOutCols / 2];
#pragma unroll
  for (int i = 0; i < kOutCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  [[maybe_unused]] DsRange range;  // fp16 only
  flash_tiles::mbar_wait(k_bar, 0);
  flash_tiles::mbar_wait(v_bar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const float next = row_value(j + 1);  // in flight while tile j is in the tensor cores
    float sT[kM / 2], dpT[kM / 2];
    ring.wait_first(j);
    ring.wait_second(j);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_rows<T, D, kRows, kM>(sT, k_tile, ring.first(j));    // sT = k . q^T
    flash_tiles::gemm_rows<T, D, kRows, kM>(dpT, v_tile, ring.second(j));  // dpT = v . do^T
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(sT);
    flash_tiles::fence_operands(dpT);

    // pT = exp(sT * scale - lse[col]), 0 where hidden or past S;
    // dsT = pT * (dpT - delta[col]) * scale.
    const int i0 = (t0 + j) * kM;
    const float* lse2_s = rows_s + (j & 1) * 2 * kM;
    const float* delta_s = lse2_s + kM;
    const bool edge = k0 + kRows > Sk || i0 + kM > S || (causal && k0 + kRows - 1 > i0 + offset);
#pragma unroll
    for (int i = 0; i < kM / 2; ++i) {
      const int c = f.column(i);
      float p = exp2f(fmaf(sT[i], scale_log2, -lse2_s[c]));
      if (edge && (i0 + c >= S || hidden(key0 + 8 * Frag::half(i), i0 + c, Sk, offset, causal))) p = 0.f;
      sT[i] = p;  // P * 2^kPBias: lse was staged less kPBias
      const float g = p * (dpT[i] - delta_s[c]);
      dpT[i] = kHalf<T> ? g : g * scale;  // fp16: dsT = g * scale in `narrow`
    }
    if constexpr (kHalf<T>) range.narrow(dpT, scale, dk_acc);
    uint32_t pT[kM / 16][4], dsT[kM / 16][4];
    flash_tiles::to_fragments<T>(sT, pT);
    flash_tiles::to_fragments<T>(dpT, dsT);

    flash_tiles::fence_operands(dv_acc);
    flash_tiles::fence_operands(dk_acc);
    flash_tiles::wgmma_fence();
    flash_tiles::gemm_regs<T, D, kM>(dv_acc, pT, ring.second(j), col0);  // dv += pT . do
    flash_tiles::gemm_regs<T, D, kM>(dk_acc, dsT, ring.first(j), col0);  // dk += dsT . q
    flash_tiles::wgmma_commit();
    flash_tiles::wgmma_wait();
    flash_tiles::fence_operands(dv_acc);
    flash_tiles::fence_operands(dk_acc);
    if (threadIdx.x < 2 * kM) rows_s[((j + 1) & 1) * 2 * kM + threadIdx.x] = next;
    __syncthreads();  // every warp is done with stage j % kStages and rows buffer j & 1
    if (threadIdx.x == 0 && j + kStages < n_tiles)
      ring.issue(j + kStages, &tq, &tdo, bh, (t0 + j + kStages) * kM);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + 8 * h;
    if (key >= Sk) continue;
    const int64_t at = ((int64_t)bh * Sk + key) * D + col0;
    // fp16: pT and dsT carried P's factor 2^15; dsT its row's power of two too.
    const float dk_back = kHalf<T> ? range.unscale(h) * kPUnscale : 1.f, dv_back = kHalf<T> ? kPUnscale : 1.f;
#pragma unroll
    for (int c = 0; c < kOutCols / 8; ++c) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * c + f.col) =
          flash_tiles::Elem<T>::pack(dk_acc[4 * c + 2 * h] * dk_back, dk_acc[4 * c + 2 * h + 1] * dk_back);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * c + f.col) =
          flash_tiles::Elem<T>::pack(dv_acc[4 * c + 2 * h] * dv_back, dv_acc[4 * c + 2 * h + 1] * dv_back);
    }
  }
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
  const dim3 grid((a.S + Split<D>::kRows - 1) / Split<D>::kRows, a.BH);
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
  const dim3 grid((a.Sk + Split<D>::kRows - 1) / Split<D>::kRows, a.BH);
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
  const dim3 grid((a.S + Split<D>::kRows - 1) / Split<D>::kRows, a.BH);
  flash_bwd_dq_kernel<T, D><<<grid, Split<D>::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse_in),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.S, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// The wgmma kernels' shapes, measured at D 64 (PERF.md): K3 takes
// 128-key tiles (64 at D 96 and above, where two 128-key stages would leave
// one block per SM, and at D 256 would not fit), K5 64-key tiles; a ring of
// two stages. A block of one warpgroup measured faster than one of two
// sharing each K/V tile. K4 streams 64-row query tiles: at D 128 they
// measured faster than 32-row ones, without spills; at D 256 it splits D's
// columns in two (above).
template <int D>
constexpr int fwd_key_tile() { return D <= 64 ? 128 : 64; }
constexpr int kDqKeyTile = 64;
constexpr int kDkvQueryTile = 64;
constexpr int kStages = 2;

template <typename T, int D>
int launch_fwd_wgmma(const Args& a) {
  constexpr int kN = fwd_key_tile<D>();
  CUtensorMap tq, tk, tv;
  int err = flash_tiles::encode_tile_map<T, D>(&tq, a.q, a.BH, a.S, kRows);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tk, a.k, a.BH, a.Sk, kN);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tv, a.v, a.BH, a.Sk, kN);
  if (err) return err;
  const auto kernel = flash_fwd_wgmma_kernel<T, D, kN, kStages>;
  const size_t smem = WgmmaSmem<D, kN, kStages, 1>::kBytes;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kRows - 1) / kRows, a.BH);
  kernel<<<grid, flash_tiles::kWarpgroup, smem, a.stream>>>(tq, tk, tv, static_cast<T*>(a.out0),
                                                             static_cast<float*>(a.out1), a.S, a.Sk, a.scale,
                                                             a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq_wgmma(const Args& a) {
  CUtensorMap tq, tk, tv, tdo;
  int err = flash_tiles::encode_tile_map<T, D>(&tq, a.q, a.BH, a.S, kRows);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tdo, a.dout, a.BH, a.S, kRows);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tk, a.k, a.BH, a.Sk, kDqKeyTile);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tv, a.v, a.BH, a.Sk, kDqKeyTile);
  if (err) return err;
  const auto kernel = flash_bwd_dq_wgmma_kernel<T, D, kDqKeyTile, kStages>;
  const size_t smem = WgmmaSmem<D, kDqKeyTile, kStages, 2>::kBytes;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.S + kRows - 1) / kRows, a.BH);
  kernel<<<grid, flash_tiles::kWarpgroup, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.S, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_wgmma(const Args& a) {
  constexpr int kM = kDkvQueryTile;
  CUtensorMap tq, tk, tv, tdo;
  int err = flash_tiles::encode_tile_map<T, D>(&tq, a.q, a.BH, a.S, kM);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tdo, a.dout, a.BH, a.S, kM);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tk, a.k, a.BH, a.Sk, kRows);
  if (!err) err = flash_tiles::encode_tile_map<T, D>(&tv, a.v, a.BH, a.Sk, kRows);
  if (err) return err;
  constexpr int kSplit = D > 128 ? 2 : 1;
  const auto kernel = flash_bwd_dkv_wgmma_kernel<T, D, kM, kStages, kSplit>;
  const size_t smem = WgmmaSmem<D, kM, kStages, 2, 4 * kM>::kBytes;
  const cudaError_t e = allow_shared(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // heads fastest: the heaviest tiles of all heads first
  const dim3 grid(a.BH, (a.Sk + kRows - 1) / kRows, kSplit);
  kernel<<<grid, flash_tiles::kWarpgroup, smem, a.stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse_in), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.Sk, a.scale, a.causal);
  return (int)cudaGetLastError();
}

enum Kind { kFwd, kDkv, kDq };

template <typename T, int D>
int launch_kind(Kind kind, const Args& a) {
  if (kind == kFwd) return launch_fwd<T, D>(a);
  if (kind == kDkv) return launch_dkv<T, D>(a);
  return launch_dq<T, D>(a);
}

// bf16 and fp16: every kernel runs on the tensor cores.
template <typename T, int D>
int launch_kind_wgmma(Kind kind, const Args& a) {
  if (kind == kFwd) return launch_fwd_wgmma<T, D>(a);
  if (kind == kDkv) return launch_dkv_wgmma<T, D>(a);
  return launch_dq_wgmma<T, D>(a);
}

template <typename T>
int launch_head_dim(Kind kind, int D, const Args& a) {
  if (D == 16) return launch_kind<T, 16>(kind, a);
  if (D == 32) return launch_kind<T, 32>(kind, a);
  if (D == 64) return launch_kind<T, 64>(kind, a);
  if (D == 96) return launch_kind<T, 96>(kind, a);
  if (D == 128) return launch_kind<T, 128>(kind, a);
  if (D == 256) return launch_kind<T, 256>(kind, a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_head_dim_wgmma(Kind kind, int D, const Args& a) {
  if (D == 16) return launch_kind_wgmma<T, 16>(kind, a);
  if (D == 32) return launch_kind_wgmma<T, 32>(kind, a);
  if (D == 64) return launch_kind_wgmma<T, 64>(kind, a);
  if (D == 96) return launch_kind_wgmma<T, 96>(kind, a);
  if (D == 128) return launch_kind_wgmma<T, 128>(kind, a);
  if (D == 256) return launch_kind_wgmma<T, 256>(kind, a);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int dispatch(Kind kind, int dtype, int D, const Args& a) {
  if (a.BH <= 0 || a.S <= 0 || a.Sk <= 0 || a.BH > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_head_dim<float>(kind, D, a);
  if (dtype == 1) return launch_head_dim_wgmma<__nv_bfloat16>(kind, D, a);
  if (dtype == 2) return launch_head_dim_wgmma<__half>(kind, D, a);
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
  if (code == flash_tiles::kNoTensorMapEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code >= flash_tiles::kTensorMapError) {
    static thread_local char text[96];
    snprintf(text, sizeof text, "cuTensorMapEncodeTiled failed (CUresult %d)", code - flash_tiles::kTensorMapError);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
