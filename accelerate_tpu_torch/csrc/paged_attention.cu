// Paged-KV attention for serving on Hopper (sm_90a): single-query decode and
// the [B, s] speculative block-verify, templated on the query and output
// type (float, __nv_bfloat16) and the pool's storage type: the query type
// itself, or int8_t / __nv_fp8_e4m3 pages with per-page-per-head f32 scales
// (the fused-dequant mode).
//
// Replaces accelerate_tpu/ops/paged_attention.py::_decode_kernel (s == 1) and
// ::_verify_kernel (s > 1), both with and without `quantized`. Same contract:
// query row (j, g) of slot b attends the columns `col <= pos[b, j]` of its
// logical cache, whose page p lives at pool page table[b, p] (clipped to
// [0, num_pages - 1]); pages with base >= max_j(pos[b, j]) + 1 are never
// read; the softmax is online in fp32, NEG_INF = -1e30, finalized against a
// 1e-30 floor so rows of inactive slots (pointed at scratch page 0) come out
// finite. Query head h * G + g rides KV head h (contiguous GQA groups). A
// quantized page's value is float(stored) * scale[page, h].
//
// Bound: memory bandwidth. A launch reads every live K/V page once,
// sum_b ceil(len_b / ps) * ps * Hkv * D * 2 * itemsize bytes (plus 8 bytes
// of scales per live page and KV head when quantized), and does about
// 4 * rows * len * D operations on it, two orders of magnitude below the
// card's ridge point. So the design is about keeping many bytes in flight
// on every SM and spending few instructions per byte:
//
// - Split pages (flash-decoding). The grid is (Hkv, B, n_split x row
//   groups). Block (h, b, i) walks only split i of slot b: a fixed run of
//   whole pages, `split` tokens long, a multiple of the tile. The wrapper
//   picks `split` from the page size alone (it never reads positions on the
//   host), so a long slot spreads over many SMs and a short one ends early:
//   a block whose split starts at or past the slot's max pos + 1 exits at
//   once. Each block writes its rows' partial (m, l, acc[D]) in f32 to a
//   workspace the wrapper allocates.
// - Merge. A second kernel, launched from the same entry point on the same
//   stream, combines a slot's splits that ran: out = sum_i w_i acc_i /
//   max(sum_i w_i l_i, 1e-30), w_i = exp(m_i - max_i m_i), one warp a row,
//   so (Hkv, B, s * G / 4) blocks merge at once. It is launched as a
//   programmatic dependent (Hopper's griddepcontrol): its blocks start while
//   the split blocks run and wait for their results, which hides the second
//   launch. Merging in the last split block of each slot instead (an atomic
//   counter) measured slower on the H100: one block then merges all of a
//   slot's rows after the slowest split. Masked columns get p = 0
//   explicitly, so a split that holds no key visible to a row gives it
//   m = NEG_INF, l = 0, acc = 0, and weight 0 in the merge.
// - Load ring. bf16 queries: each tile of whole pages (64 tokens, or one
//   page when a page is larger) is copied at the pool's own width (2 or 1
//   bytes a value) with 16-byte cp.async copies into a ring of two
//   shared-memory stages (four timed slower on the H100), so the next tile
//   is in flight while this one is computed. The split's page ids are read
//   beside the positions, and its scales while the first tiles load. Rows
//   are padded by 16 bytes, which keeps the fragment reads below free of
//   bank conflicts.
// - Products on the tensor cores (bf16 queries). mma.sync m16n8k16, bf16 in,
//   f32 accumulate, query rows as M (16 or 32 rows: G = 4 for decode, s * G
//   = 20 for verify) and tokens as N, so the score accumulator is the A
//   operand of p . v without leaving registers (FlashAttention-2's layout).
//   Each warp owns a quarter of every tile's tokens and keeps its own
//   (m, l, acc); the four are combined once, at the end of the split. The
//   reduction dimension is permuted (q and k alike, so the dot product is
//   unchanged) so that a thread reads one contiguous run of each K row and
//   of each V row. int8 and e4m3 codes widen to bf16 exactly while the
//   fragments are built; K's page scale multiplies the f32 score column and
//   V's the p column. p (times V's scale) enters p . v as two bf16 values,
//   hi = bf16(p) and lo = bf16(p - hi), in two products: p rounded once to
//   bf16 (8 bits) moves an output by up to 2^-8 sum(p |v|) / l, which
//   breaks atol 2e-3 in rows that see few keys; hi + lo keeps 16 bits. The
//   tensor cores have time to spare, as the loads bound the kernel.
// - f32 queries (the parity mode) keep the scalar fp32 kernel on the CUDA
//   cores, widened fp32 tiles in shared memory, inside the same split and
//   merge. So do bf16 queries at a head dimension the tensor-core kernel is
//   not built for (it is for 32, 64 and 128), with q and the output in bf16.
//
// The kernels launch on the caller's stream, allocate nothing and never
// synchronise: the write of this dispatch's K/V into the pool, queued before
// them on the same stream, is complete when they read.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLFloor = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;
// Stages of the tensor-core kernel's load ring.
constexpr int kStages = 2;

// Whole pages per tile: at least one, and at most kTileTokens tokens when a
// page is smaller than that.
__host__ __device__ inline int tile_pages(int ps) { return ps >= kTileTokens ? 1 : kTileTokens / ps; }
// A tile's tokens rounded up to whole 16-token chunks for each of the four
// warps of the tensor-core kernel.
__host__ __device__ inline int padded_tile_tokens(int ps) {
  const int tt = tile_pages(ps) * ps;
  return (tt + 63) / 64 * 64;
}

// ---------------------------------------------------------------- helpers
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

__device__ inline void store(float* dst, float x) { *dst = x; }
__device__ inline void store(__nv_bfloat16* dst, float x) { *dst = __float2bfloat16(x); }
__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16-byte global -> shared copy; `bytes` 0 fills the 16 bytes with zeros.
__device__ inline void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Wait until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate.
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y as bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi), so hi + lo
// carries 16 significant bits where one bf16 carries 8.
__device__ inline void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - f.x, y - f.y);
}

// Two values of the pool's storage type, widened to a bf16 pair (exactly:
// int8 codes and e4m3 values are bf16 values). `lo` and `hi` hold the two
// values in their low 8 (1-byte types) or 16 (bf16) bits.
template <typename TS>
__device__ inline uint32_t widen_pair(uint32_t lo, uint32_t hi);

template <>
__device__ inline uint32_t widen_pair<__nv_bfloat16>(uint32_t lo, uint32_t hi) {
  return (lo & 0xffffu) | (hi << 16);
}

template <>
__device__ inline uint32_t widen_pair<int8_t>(uint32_t lo, uint32_t hi) {
  return pack_bf16(static_cast<float>(static_cast<int8_t>(lo & 0xffu)),
                   static_cast<float>(static_cast<int8_t>(hi & 0xffu)));
}

template <>
__device__ inline uint32_t widen_pair<__nv_fp8_e4m3>(uint32_t lo, uint32_t hi) {
  // One cvt widens the e4m3 pair to f16 (exact), then f16 -> f32 (exact)
  // and the pack to bf16 (exact: e4m3 has 3 mantissa bits, bf16 7).
  const __nv_fp8x2_storage_t pair = static_cast<__nv_fp8x2_storage_t>((lo & 0xffu) | ((hi & 0xffu) << 8));
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
  return pack_bf16(f.x, f.y);
}

// Value i of a run of stored values, as the low bits of a 32-bit word.
template <typename TS>
__device__ inline uint32_t stored_at(const uint32_t* words, int i) {
  if constexpr (sizeof(TS) == 2) return words[i >> 1] >> (16 * (i & 1));
  return words[i >> 2] >> (8 * (i & 3));
}

// One 16-byte vector of the scalar kernel's pool type, widened to fp32.
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
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(static_cast<int8_t>(stored_at<int8_t>(words, i) & 0xffu));
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
      const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(pairs[i], __NV_E4M3)));
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// The slot's live length, max_j pos[b, j] + 1. Each warp reads the S
// positions at once, one per lane, and reduces them; every lane of every
// warp of the block calls it.
__device__ inline int slot_length(const int* pos, int b, int S) {
  int length = 0;
  for (int j = threadIdx.x & 31; j < S; j += 32) length = max(length, __ldg(pos + b * S + j) + 1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) length = max(length, __shfl_xor_sync(0xffffffffu, length, o));
  return length;
}

// Partial (acc[R][D], m[R], l[R]) of split i of (b, h) in the workspace.
__device__ inline float* partial_of(float* ws, int b, int h, int i, int Hkv, int n_split, int R, int D) {
  return ws + ((int64_t)(b * Hkv + h) * n_split + i) * R * (D + 2);
}

// The scalar kernel (f32 queries, and bf16 queries at head dimensions the
// tensor-core kernel is not built for): one block per (KV head h, slot b,
// split i), all s * G rows. Scores and p . v are fp32 FMAs over fp32 tiles
// in shared memory (K padded to D + 1), one warp folds each row's scores
// into (m, l) with shuffles; m is kept in natural-log units.
template <typename T, typename TS>
__global__ void __launch_bounds__(kThreads)
paged_split_scalar_kernel(const T* __restrict__ q, const TS* __restrict__ k_pool,
                       const TS* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ pos, float* __restrict__ ws, int S, int Hq, int Hkv,
                       int D, int num_pages, int ps, int P, int split, int n_split, float scale) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr bool kQuantized = !std::is_same<TS, T>::value;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split_i = blockIdx.z;
  const int n_pages = min(P, (slot_length(pos, b, S) + ps - 1) / ps);
  const int split_pages = split / ps;
  const int p_begin = split_i * split_pages;
  if (p_begin >= n_pages) return;  // nothing of this split is live: the merge skips it
  const int p_end = min(n_pages, p_begin + split_pages);

  const int G = Hq / Hkv;
  const int R = S * G;
  const int TP = tile_pages(ps);
  const int TT = TP * ps;
  const int kd = D + 1;  // padded K row: the score loop reads K by column
  const int nkv = Vec<TS>::N;
  const int kv_per_row = D / nkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(16) unsigned char scalar_smem[];
  float* q_s = reinterpret_cast<float*>(scalar_smem);  // [R, D]
  float* acc = q_s + R * D;     // [R, D]
  float* k_s = acc + R * D;     // [TT, D + 1]
  float* v_s = k_s + TT * kd;   // [TT, D]
  float* p_s = v_s + TT * D;    // [R, TT] scores, then probabilities
  float* m_s = p_s + R * TT;    // [R]
  float* l_s = m_s + R;         // [R]
  float* c_s = l_s + R;         // [R] this tile's correction factor
  int* lim_s = reinterpret_cast<int*>(c_s + R);  // [S] per-query attend limit

  // Row r = j * G + g holds query head h * G + g of position j.
  for (int c = threadIdx.x; c < R * D; c += blockDim.x) {
    const int r = c / D;
    const int j = r / G;
    q_s[c] = to_float(q[((int64_t)(b * S + j) * Hq + h * G + (r - j * G)) * D + (c - r * D)]);
  }
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) acc[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) lim_s[j] = pos[b * S + j];
  __syncthreads();

  const int64_t token_stride = (int64_t)Hkv * D;
  const int* row_table = table + (int64_t)b * P;

  for (int p0 = p_begin; p0 < p_end; p0 += TP) {
    const int tl = min(TP, p_end - p0) * ps;  // tokens in this tile
    const int base = p0 * ps;

    // Token t of the tile is token t % ps of pool page table[b, p0 + t / ps],
    // KV head h; a quantized value takes the scale of its own token's page.
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

    // One warp per row: m_new = max(m, max(s)), p = exp(s - m_new) on the
    // visible columns and 0 on the others, l = l * exp(m - m_new) + sum(p).
    for (int r = warp; r < R; r += kWarps) {
      float* pr = p_s + r * TT;
      float mx = kNegInf;
      for (int t = lane; t < tl; t += 32) mx = fmaxf(mx, pr[t]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int t = lane; t < tl; t += 32) {
        const float p = pr[t] == kNegInf ? 0.f : expf(pr[t] - m_new);
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

  float* part = partial_of(ws, b, h, split_i, Hkv, n_split, R, D);
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) part[i] = acc[i];
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    part[R * D + r] = m_s[r];
    part[R * D + R + r] = l_s[r];
  }
}

size_t scalar_shared_bytes(int S, int Hq, int Hkv, int D, int ps) {
  const size_t R = (size_t)S * (Hq / Hkv);
  const size_t TT = (size_t)tile_pages(ps) * ps;
  return sizeof(float) * (2 * R * D + TT * (D + 1) + TT * D + R * TT + 3 * R) + sizeof(int) * S;
}

// N 32-bit words from shared memory at p, in the widest loads p's
// alignment allows (a multiple of 16 bytes when N % 4 == 0, of 8 when
// N % 2 == 0).
template <int N>
__device__ inline void load_words(const unsigned char* p, uint32_t (&w)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * i);
      w[i] = v.x;
      w[i + 1] = v.y;
      w[i + 2] = v.z;
      w[i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + 4 * i);
      w[i] = v.x;
      w[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = *reinterpret_cast<const uint32_t*>(p + 4 * i);
  }
}

// Shared-memory layout of the tensor-core kernel: the ring of kStages
// (K tile, V tile) pairs, each tile TTP rows of D values padded by 16 bytes,
// then the split's page ids and K/V scales. After the walk the ring is
// reused for the four warps' partials.
struct MmaLayout {
  int row_bytes, tile_bytes, split_pages;
  size_t ring_bytes, bytes;
};

__host__ __device__ inline MmaLayout mma_layout(int D, int itemsize, int ps, int split, int mt) {
  MmaLayout L;
  L.row_bytes = D * itemsize + 16;
  L.tile_bytes = padded_tile_tokens(ps) * L.row_bytes;
  L.split_pages = split / ps;
  L.ring_bytes = (size_t)kStages * 2 * L.tile_bytes;
  const size_t walk = L.ring_bytes + (size_t)3 * L.split_pages * sizeof(int);
  const size_t combine = sizeof(float) * kWarps * 16 * mt * (D + 2);
  L.bytes = walk > combine ? walk : combine;
  return L;
}

// bf16 queries: the tensor-core kernel. Block (h, b, z) walks split
// z % n_split of slot b for query rows [16 MT (z / n_split), +16 MT) of
// KV head h. Warp w computes tokens [w TTP / 4, (w + 1) TTP / 4) of every
// tile, 16 at a time:
//   scores: S[r, t] = sum_d q[r, d] k[t, d] as MT x 2 m16n8k16 tiles (rows x
//     8 tokens), over D / 16 steps; step kk of thread (gid, tid4) takes
//     d = 4 KS tid4 + 4 kk + {0, 1} (lower k half) and {2, 3} (upper), so a
//     thread reads its 4 KS values of a K row with one or two 16-byte loads;
//   p . v: acc[r, d] += p[r, t] v[t, d] as MT x D / 8 tiles over the 16
//     tokens; output column c of n-tile n is d = (D / 8) c + n, so a thread
//     reads D / 8 contiguous values of each of its four V rows.
// m is kept in log2 units (scores scaled by log2(e)), as the merge expects.
template <typename TS, int D, int MT>
__global__ void __launch_bounds__(kThreads, 1)
paged_split_mma_kernel(const __nv_bfloat16* __restrict__ q, const TS* __restrict__ k_pool,
                       const TS* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ table,
                       const int* __restrict__ pos, float* __restrict__ ws, int S, int Hq, int Hkv,
                       int num_pages, int ps, int P, int split, int n_split, float scale) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr bool kQuantized = !std::is_same<TS, __nv_bfloat16>::value;
  constexpr int KS = D / 16;                       // k-steps of the score product
  constexpr int NT = D / 8;                        // n-tiles of p . v
  constexpr int KWORDS = 4 * KS * sizeof(TS) / 4;  // words of a thread's K run
  constexpr int VWORDS = NT * sizeof(TS) / 4;      // words of a thread's V run
  constexpr int CHUNKS = D * sizeof(TS) / 16;      // 16-byte copies per row
  static_assert(VWORDS >= 1, "D too small for the pool type");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split_i = blockIdx.z % n_split;
  const int row0 = (blockIdx.z / n_split) * 16 * MT;
  const int split_pages = split / ps;
  const int p_begin = split_i * split_pages;
  // The split's first page ids are read beside the positions, not after
  // them: entries past the slot's live pages are loaded and never used.
  const int* row_table = table + (int64_t)b * P + p_begin;
  const int first_page = threadIdx.x < min(split_pages, P - p_begin) ? __ldg(row_table + threadIdx.x) : 0;
  const int n_pages = min(P, (slot_length(pos, b, S) + ps - 1) / ps);
  if (p_begin >= n_pages) return;  // nothing of this split is live: the merge skips it
  const int n_live = min(n_pages, p_begin + split_pages) - p_begin;

  const int G = Hq / Hkv;
  const int R = S * G;
  const int TP = tile_pages(ps);
  const int TT = TP * ps;
  const int TTP = padded_tile_tokens(ps);
  const int n_tiles = (n_live + TP - 1) / TP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tid4 = lane & 3;
  const MmaLayout L = mma_layout(D, sizeof(TS), ps, split, MT);

  extern __shared__ __align__(16) unsigned char smem[];
  int* page_s = reinterpret_cast<int*>(smem + L.ring_bytes);  // [split_pages]
  float* ks_s = reinterpret_cast<float*>(page_s + split_pages);
  float* vs_s = ks_s + split_pages;

  // The split's page ids, clipped to the pool, once.
  for (int i = threadIdx.x; i < n_live; i += kThreads) {
    page_s[i] = min(max(i < kThreads ? first_page : __ldg(row_table + i), 0), num_pages - 1);
  }
  __syncthreads();

  // Tile `it` into stage it % stages: token t of the tile is token t % ps of
  // page it * TP + t / ps of the split. Rows past the tile's live tokens are
  // zero-filled, so a masked column never multiplies stale bits.
  const int64_t token_stride = (int64_t)Hkv * D;
  auto load_tile = [&](int it) {
    unsigned char* kt = smem + (size_t)(it % kStages) * 2 * L.tile_bytes;
    unsigned char* vt = kt + L.tile_bytes;
    for (int c = threadIdx.x; c < TTP * CHUNKS; c += kThreads) {
      const int t = c / CHUNKS;
      const int ch = c - t * CHUNKS;
      const int pi = it * TP + t / ps;
      const bool live = t < TT && pi < n_live;
      int64_t src = 0;
      if (live) src = ((int64_t)page_s[pi] * ps + t % ps) * token_stride + (int64_t)h * D;
      const int off = t * L.row_bytes + ch * 16;
      cp_async16(kt + off, reinterpret_cast<const unsigned char*>(k_pool + src) + ch * 16, live ? 16 : 0);
      cp_async16(vt + off, reinterpret_cast<const unsigned char*>(v_pool + src) + ch * 16, live ? 16 : 0);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  // The pages' scales, while the first tiles are in flight; the first tile's
  // barrier publishes them.
  if constexpr (kQuantized) {
    for (int i = threadIdx.x; i < n_live; i += kThreads) {
      ks_s[i] = __ldg(k_scale + (int64_t)page_s[i] * Hkv + h);
      vs_s[i] = __ldg(v_scale + (int64_t)page_s[i] * Hkv + h);
    }
  }

  // The A fragments of q (rows past R are zeros) and each row's limit.
  uint32_t qa[MT][KS][4];
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + mt * 16 + gid + 8 * hf;
      const __nv_bfloat16* qr = nullptr;
      lim[mt][hf] = -1;
      if (r < R) {
        const int j = r / G;
        qr = q + ((int64_t)(b * S + j) * Hq + h * G + (r - j * G)) * D + 4 * KS * tid4;
        lim[mt][hf] = __ldg(pos + b * S + j);
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[mt][kk][hf] = qr ? __ldg(reinterpret_cast<const unsigned int*>(qr + 4 * kk)) : 0u;
        qa[mt][kk][2 + hf] = qr ? __ldg(reinterpret_cast<const unsigned int*>(qr + 4 * kk + 2)) : 0u;
      }
    }
  }

  const float qk_scale = scale * kLog2e;
  float m[MT][2], l[MT][2], acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = kNegInf;
      l[mt][hf] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  }

  const int warp_tokens = TTP / kWarps;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + kStages - 1 < n_tiles) load_tile(it + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();

    const unsigned char* kt = smem + (size_t)(it % kStages) * 2 * L.tile_bytes;
    const unsigned char* vt = kt + L.tile_bytes;
    const int tl = min(TP, n_live - it * TP) * ps;  // live tokens of this tile
    const int col0 = (p_begin + it * TP) * ps;      // column of the tile's token 0
    for (int t0 = warp * warp_tokens; t0 < (warp + 1) * warp_tokens && t0 < tl; t0 += 16) {
      float sc[MT][2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[mt][j][0] = sc[mt][j][1] = sc[mt][j][2] = sc[mt][j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t kw[KWORDS];
        load_words(kt + (t0 + 8 * j + gid) * L.row_bytes + tid4 * (4 * KS * (int)sizeof(TS)), kw);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t b0 = widen_pair<TS>(stored_at<TS>(kw, 4 * kk), stored_at<TS>(kw, 4 * kk + 1));
          const uint32_t b1 = widen_pair<TS>(stored_at<TS>(kw, 4 * kk + 2), stored_at<TS>(kw, 4 * kk + 3));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(sc[mt][j], qa[mt][kk], b0, b1);
        }
      }

      // This thread's columns: tile tokens t0 + 8 j + 2 tid4 + e.
      float kcol[2][2], vcol[2][2];
      int col[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 8 * j + 2 * tid4 + e;
          col[j][e] = t < tl ? col0 + t : 0x7fffffff;
          kcol[j][e] = qk_scale;
          vcol[j][e] = 1.f;
          if constexpr (kQuantized) {
            if (t < tl) {
              kcol[j][e] *= ks_s[it * TP + t / ps];
              vcol[j][e] = vs_s[it * TP + t / ps];
            }
          }
        }

      uint32_t pa[MT][4], pb[MT][4];  // p * v_scale = hi + lo, two bf16 A fragments
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool vis = col[j][e] <= lim[mt][hf];
              const float x = vis ? sc[mt][j][2 * hf + e] * kcol[j][e] : kNegInf;
              sc[mt][j][2 * hf + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][hf], mx);
          const float corr = exp2f(m[mt][hf] - m_new);
          float sum = 0.f;
          float pv[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool vis = col[j][e] <= lim[mt][hf];
              const float p = vis ? exp2f(sc[mt][j][2 * hf + e] - m_new) : 0.f;
              sum += p;
              pv[j][e] = vis ? p * vcol[j][e] : 0.f;
            }
          l[mt][hf] = l[mt][hf] * corr + sum;
          m[mt][hf] = m_new;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[mt][nt][2 * hf] *= corr;
            acc[mt][nt][2 * hf + 1] *= corr;
          }
          split_bf16(pv[0][0], pv[0][1], pa[mt][hf], pb[mt][hf]);          // k = 2 tid4 + {0, 1}
          split_bf16(pv[1][0], pv[1][1], pa[mt][2 + hf], pb[mt][2 + hf]);  // k = 8 + 2 tid4 + {0, 1}
        }
      }

      uint32_t vw[4][VWORDS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 8 * (i >> 1) + 2 * tid4 + (i & 1);
        load_words(vt + t * L.row_bytes + gid * (NT * (int)sizeof(TS)), vw[i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t b0 = widen_pair<TS>(stored_at<TS>(vw[0], nt), stored_at<TS>(vw[1], nt));
        const uint32_t b1 = widen_pair<TS>(stored_at<TS>(vw[2], nt), stored_at<TS>(vw[3], nt));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][nt], pa[mt], b0, b1);
          mma_bf16(acc[mt][nt], pb[mt], b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's load
  }

  // Combine the four warps' partials through shared memory (the ring is
  // drained: every group waited for, every read behind the last barrier).
  cp_async_wait<0>();
  constexpr int RG = 16 * MT;
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][RG][D + 2]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lsum = l[mt][hf];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      float* row = red + (warp * RG + mt * 16 + gid + 8 * hf) * (D + 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        row[NT * (2 * tid4) + nt] = acc[mt][nt][2 * hf];
        row[NT * (2 * tid4 + 1) + nt] = acc[mt][nt][2 * hf + 1];
      }
      if (tid4 == 0) {
        row[D] = m[mt][hf];
        row[D + 1] = lsum;
      }
    }
  }
  __syncthreads();
  float* part = partial_of(ws, b, h, split_i, Hkv, n_split, R, D);
  const int rows = min(RG, R - row0);
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int rl = i / D;
    const int d = i - rl * D;
    float mw[kWarps];
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = red[(w * RG + rl) * (D + 2) + D];
      mx = fmaxf(mx, mw[w]);
    }
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mw[w] - mx);
      a += wt * red[(w * RG + rl) * (D + 2) + d];
      lsum += wt * red[(w * RG + rl) * (D + 2) + D + 1];
    }
    const int r = row0 + rl;
    part[r * D + d] = a;
    if (d == 0) {
      part[R * D + r] = mx;
      part[R * D + R + r] = lsum;
    }
  }
}

// Combines the splits of slot b that ran (the same count the split kernels
// derive from positions): out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30),
// w_i = exp(m_i - max_i m_i), in log2 units for the tensor-core kernel.
// Block (h, b, z) merges rows [kWarps z, kWarps (z + 1)), one warp a row:
// the lanes read the splits' (m, l) together, and each lane sums its
// columns over the splits with the weights passed by shuffles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(const float* __restrict__ ws, const int* __restrict__ pos, T* __restrict__ out,
                   int S, int Hq, int Hkv, int D, int ps, int P, int split, int n_split,
                   int log2_units) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.z * kWarps + (threadIdx.x >> 5);
  const int G = Hq / Hkv;
  const int R = S * G;
  const int n_pages = min(P, (slot_length(pos, b, S) + ps - 1) / ps);
  if (r >= R) return;  // whole warps
  const int split_pages = split / ps;
  const int n_run = (n_pages + split_pages - 1) / split_pages;
  // The split kernel's partials are complete and visible past this point.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* part = partial_of(const_cast<float*>(ws), b, h, 0, Hkv, n_split, R, D);
  const int64_t stride = (int64_t)R * (D + 2);
  auto weight = [&](float dm) { return log2_units ? exp2f(dm) : expf(dm); };

  float mx = kNegInf;
  for (int s = lane; s < n_run; s += 32) mx = fmaxf(mx, part[s * stride + R * D + r]);
  mx = warp_max(mx);
  float lsum = 0.f;
  for (int s = lane; s < n_run; s += 32) {
    lsum += weight(part[s * stride + R * D + r] - mx) * part[s * stride + R * D + R + r];
  }
  const float inv = 1.f / fmaxf(warp_sum(lsum), kLFloor);

  const int j = r / G;
  T* dst = out + ((int64_t)(b * S + j) * Hq + h * G + (r - j * G)) * D;
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float a = 0.f;
    for (int s0 = 0; s0 < n_run; s0 += 32) {
      const float w = s0 + lane < n_run ? weight(part[(s0 + lane) * stride + R * D + r] - mx) : 0.f;
      const int n = min(32, n_run - s0);
#pragma unroll 8
      for (int k = 0; k < n; ++k) {
        const float wk = __shfl_sync(0xffffffffu, w, k);
        if (d < D) a += wk * part[(s0 + k) * stride + r * D + d];
      }
    }
    if (d < D) store(dst + d, a * inv);
  }
}

// Whether bf16 queries (dtype 1) at head dimension D take the tensor-core
// kernel; every other launch takes the scalar one.
inline bool uses_mma(int dtype, int D) { return dtype == 1 && (D == 32 || D == 64 || D == 128); }

// Query rows per m16 tile group: two tiles where the accumulators fit.
__host__ __device__ inline int mma_tiles(int R, int D) { return R <= 16 || D > 64 ? 1 : 2; }

int n_splits(int P, int ps, int split) { return (P + split / ps - 1) / (split / ps); }

// Dynamic shared memory above 48 KB needs an opt-in, which holds for the
// current device only: set it on every such launch (a host-side attribute
// write), so no state is kept across devices or threads.
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename TS, int D, int MT>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                       const void* v_scale, const void* table, const void* pos, float* ws, int B,
                       int S, int Hq, int Hkv, int num_pages, int ps, int P, int split, float scale,
                       cudaStream_t stream) {
  const MmaLayout L = mma_layout(D, sizeof(TS), ps, split, MT);
  const cudaError_t err = allow_shared(paged_split_mma_kernel<TS, D, MT>, L.bytes);
  if (err != cudaSuccess) return err;
  const int n_split = n_splits(P, ps, split);
  const int groups = (S * (Hq / Hkv) + 16 * MT - 1) / (16 * MT);
  paged_split_mma_kernel<TS, D, MT><<<dim3(Hkv, B, n_split * groups), kThreads, L.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TS*>(k_pool), static_cast<const TS*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), static_cast<const int*>(table),
      static_cast<const int*>(pos), ws, S, Hq, Hkv, num_pages, ps, P, split, n_split, scale);
  return cudaGetLastError();
}

template <typename TS>
cudaError_t launch_mma_d(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                         const void* v_scale, const void* table, const void* pos, float* ws, int B,
                         int S, int Hq, int Hkv, int D, int num_pages, int ps, int P, int split,
                         float scale, cudaStream_t stream) {
#define PAGED_MMA(DD, MT)                                                                          \
  return launch_mma<TS, DD, MT>(q, k_pool, v_pool, k_scale, v_scale, table, pos, ws, B, S, Hq, Hkv, \
                                num_pages, ps, P, split, scale, stream)
  const int mt = mma_tiles(S * (Hq / Hkv), D);
  if (D == 32) {
    if (mt == 1) PAGED_MMA(32, 1);
    PAGED_MMA(32, 2);
  }
  if (D == 64) {
    if (mt == 1) PAGED_MMA(64, 1);
    PAGED_MMA(64, 2);
  }
  if (D == 128) PAGED_MMA(128, 1);
#undef PAGED_MMA
  return cudaErrorInvalidValue;
}

size_t shared_bytes(int S, int Hq, int Hkv, int D, int ps, int split, int dtype, int kv_dtype) {
  if (!uses_mma(dtype, D)) return scalar_shared_bytes(S, Hq, Hkv, D, ps);
  const int itemsize = kv_dtype == -1 ? 2 : 1;
  return mma_layout(D, itemsize, ps, split, mma_tiles(S * (Hq / Hkv), D)).bytes;
}

// T: query and output type. TS: the pool's storage type, T itself or a
// quantized type whose pages come with [num_pages, Hkv] f32 scales. `ws`
// holds B * Hkv * n_split * s * G * (D + 2) floats.
template <typename T, typename TS>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
           const void* v_scale, const void* table, const void* pos, void* out, void* ws, int B,
           int S, int Hq, int Hkv, int D, int num_pages, int ps, int P, int split, float scale,
           void* stream_ptr) {
  if (split <= 0 || split % (tile_pages(ps) * ps) != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int n_split = n_splits(P, ps, split);
  float* partials = static_cast<float*>(ws);
  const bool mma = uses_mma(std::is_same<T, float>::value ? 0 : 1, D);
  cudaError_t err = cudaSuccess;
  if (mma) {
    if constexpr (!std::is_same<T, float>::value) {
      err = launch_mma_d<TS>(q, k_pool, v_pool, k_scale, v_scale, table, pos, partials, B, S, Hq, Hkv,
                             D, num_pages, ps, P, split, scale, stream);
    }
  } else {
    const size_t smem = scalar_shared_bytes(S, Hq, Hkv, D, ps);
    err = allow_shared(paged_split_scalar_kernel<T, TS>, smem);
    if (err != cudaSuccess) return (int)err;
    paged_split_scalar_kernel<T, TS><<<dim3(Hkv, B, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TS*>(k_pool), static_cast<const TS*>(v_pool),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        static_cast<const int*>(table), static_cast<const int*>(pos), partials, S, Hq, Hkv, D,
        num_pages, ps, P, split, n_split, scale);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  const int rows = S * (Hq / Hkv);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Hkv, B, (rows + kWarps - 1) / kWarps);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, paged_merge_kernel<T>, static_cast<const float*>(partials),
                           static_cast<const int*>(pos), static_cast<T*>(out), S, Hq, Hkv, D, ps, P,
                           split, n_split, mma ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// dtype (q, out): 0 = float32, 1 = bfloat16. kv_dtype (pools): -1 = q's
// dtype, unquantized; 0 = int8, 1 = fp8 e4m3, with f32 scales.
template <typename T>
int dispatch_pool(int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale, const void* table, const void* pos,
                  void* out, void* ws, int B, int S, int Hq, int Hkv, int D, int num_pages, int ps,
                  int P, int split, float scale, void* stream) {
  if (kv_dtype == -1) {
    return launch<T, T>(q, k_pool, v_pool, nullptr, nullptr, table, pos, out, ws, B, S, Hq, Hkv, D,
                        num_pages, ps, P, split, scale, stream);
  }
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  if (kv_dtype == 0) {
    return launch<T, int8_t>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out, ws, B, S, Hq,
                             Hkv, D, num_pages, ps, P, split, scale, stream);
  }
  if (kv_dtype == 1) {
    return launch<T, __nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale, table, pos, out, ws, B,
                                    S, Hq, Hkv, D, num_pages, ps, P, split, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int dispatch(int dtype, int kv_dtype, const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* table, const void* pos,
             void* out, void* ws, int B, int S, int Hq, int Hkv, int D, int num_pages, int ps,
             int P, int split, float scale, void* stream) {
  if (dtype == 0) {
    return dispatch_pool<float>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out, ws,
                                B, S, Hq, Hkv, D, num_pages, ps, P, split, scale, stream);
  }
  if (dtype == 1) {
    return dispatch_pool<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos,
                                        out, ws, B, S, Hq, Hkv, D, num_pages, ps, P, split, scale,
                                        stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Unquantized pools of q's dtype (0 = float32, 1 = bfloat16). `ws` is the
// split partials' workspace, `split` the tokens of one split (a multiple of
// the tile). Each entry point launches the split kernel and the merge and
// returns cudaGetLastError() after them (0 = launched).
extern "C" int paged_decode_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, void* ws, int B,
                                   int Hq, int Hkv, int D, int num_pages, int ps, int P, int split,
                                   float scale, int dtype, void* stream) {
  return dispatch(dtype, -1, q, k_pool, v_pool, nullptr, nullptr, table, pos, out, ws, B, 1, Hq,
                  Hkv, D, num_pages, ps, P, split, scale, stream);
}

extern "C" int paged_verify_launch(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* pos, void* out, void* ws, int B,
                                   int S, int Hq, int Hkv, int D, int num_pages, int ps, int P,
                                   int split, float scale, int dtype, void* stream) {
  return dispatch(dtype, -1, q, k_pool, v_pool, nullptr, nullptr, table, pos, out, ws, B, S, Hq,
                  Hkv, D, num_pages, ps, P, split, scale, stream);
}

// Quantized pools (kv_dtype 0 = int8, 1 = fp8 e4m3) with their [num_pages,
// Hkv] f32 scales; D must be a multiple of 16 (one 16-byte copy per 16
// values).
extern "C" int paged_decode_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* table, const void* pos, void* out, void* ws,
                                         int B, int Hq, int Hkv, int D, int num_pages, int ps, int P,
                                         int split, float scale, int dtype, int kv_dtype,
                                         void* stream) {
  return dispatch(dtype, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out, ws, B, 1,
                  Hq, Hkv, D, num_pages, ps, P, split, scale, stream);
}

extern "C" int paged_verify_quant_launch(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* table, const void* pos, void* out, void* ws,
                                         int B, int S, int Hq, int Hkv, int D, int num_pages,
                                         int ps, int P, int split, float scale, int dtype,
                                         int kv_dtype, void* stream) {
  return dispatch(dtype, kv_dtype, q, k_pool, v_pool, k_scale, v_scale, table, pos, out, ws, B, S,
                  Hq, Hkv, D, num_pages, ps, P, split, scale, stream);
}

// Dynamic shared memory of the split kernel that these arguments select.
extern "C" unsigned long long paged_attention_shared_bytes(int S, int Hq, int Hkv, int D, int ps,
                                                           int split, int dtype, int kv_dtype) {
  return (unsigned long long)shared_bytes(S, Hq, Hkv, D, ps, split, dtype, kv_dtype);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
