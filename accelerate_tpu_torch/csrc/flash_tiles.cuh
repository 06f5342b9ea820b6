// Tile building blocks for the Hopper flash-attention kernels of
// flash_attention.cu (K3 forward, K4 dK/dV, K5 dQ): TMA loads into a ring of
// shared-memory stages with mbarrier completion, wgmma shared-memory
// descriptors, the wgmma instructions themselves as inline PTX, and the
// host-side tensor maps.
//
// Element types: __nv_bfloat16 and __half, two bytes each, so both share
// every layout, descriptor and swizzle below; they differ only in the
// wgmma instruction's type (.bf16 or .f16), the tensor map's data type and
// the narrowing of fp32 values to register fragments (`Elem`).
//
// Layout. A tile of `Rows` rows of a [B*H, S, D] array lies in shared
// memory as Panels<D>::kCount panels of [Rows, kCols]: 128-byte rows (64
// columns) swizzled 128B for D 64, 128 and 256 (one, two or four panels),
// 64-byte rows (32 columns) swizzled 64B for D 32 and 96 (one or three
// panels), one panel of 32-byte rows (16 columns) swizzled 32B for D 16
// (T5-tiny's d_kv: its score products are one k16 step, its p.v and dK/dV
// products m64n16). TMA writes that layout
// (one 3-D box per panel) and wgmma reads it through descriptors of the same
// swizzle: K-major when the contraction runs along D (q.k, do.v), MN-major
// when it runs along the rows (p.v, ds.k; p^T.do, ds^T.q in K4), so one copy
// of a tile serves both products. Every tile starts on a 1024-byte boundary,
// the period of the 128B pattern, so descriptors carry base offset 0.
//
// The tensor maps are 3-D, [B*H, S, D]: TMA zero-fills rows past S within a
// head. A 2-D [B*H*S, D] map would fill a ragged last tile with the next
// head's rows instead.
//
// Build: sm_90a (wgmma exists only there), no -lcuda: the one driver call,
// cuTensorMapEncodeTiled, is reached through cudaGetDriverEntryPoint.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tiles {

constexpr int kWarpgroup = 128;

// Error codes above every cudaError_t: a failed tensor-map encode returns
// kTensorMapError + its CUresult.
constexpr int kNoTensorMapEncoder = 1 << 20;
constexpr int kTensorMapError = kNoTensorMapEncoder + 1;

// Panels of a row of D two-byte values in shared memory.
template <int D>
struct Panels {
  static_assert(D == 16 || D == 32 || D == 64 || D == 96 || D == 128 || D == 256,
                "head dims 16, 32, 64, 96, 128, 256");
  static constexpr int kCols = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);  // columns per panel
  static constexpr int kCount = D / kCols;
  static constexpr int kRowBytes = kCols * 2;  // 32, 64 or 128
  // wgmma's swizzle field: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
  __host__ __device__ static constexpr int tile_bytes(int rows) { return rows * D * 2; }
};

// ------------------------------------------------------------ device side
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the barrier's phase `parity` has completed. A copy that never
// completes (a bad tensor map, a miscounted byte total) traps after about
// ten seconds, so the launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + Rows) of head `bh` into a tile at `dst`, completing on `bar`
// (one thread issues it; rows past the map's S arrive as zeros).
template <int D, int Rows>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row0,
                                          int bh) {
  using P = Panels<D>;
  mbar_expect_tx(bar, P::tile_bytes(Rows));
#pragma unroll
  for (int p = 0; p < P::kCount; ++p)
    tma_load_3d(dst + p * Rows * P::kRowBytes, map, bar, p * P::kCols, row0, bh);
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand for the 16 values of D from 16 * t on: the rows of a tile
// are its M (or N) rows, 8-row groups 8 * kRowBytes apart; a step along D
// moves 32 bytes within a swizzled row (the hardware swizzles the address it
// forms), or to the next panel.
template <int D, int Rows>
__device__ __forceinline__ uint64_t k_major_desc(uint32_t tile, int t) {
  using P = Panels<D>;
  const int col = 16 * t;
  const uint32_t addr = tile + (col / P::kCols) * (Rows * P::kRowBytes) + (col % P::kCols) * 2;
  return make_desc(addr, 16, 8 * P::kRowBytes, P::kLayout);
}

// MN-major operand for tile rows [16 t, 16 t + 16) as the contraction (K)
// side and D as N: 8-row groups 8 * kRowBytes apart (SBO), panels of D
// Rows * kRowBytes apart (LBO).
template <int D, int Rows>
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t tile, int t) {
  using P = Panels<D>;
  return make_desc(tile + 16 * t * P::kRowBytes, Rows * P::kRowBytes, 8 * P::kRowBytes, P::kLayout);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two fp32 values as one bf16x2 (f16x2) register, the first in the low half,
// each rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 x = __float22half2_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&x);
}

// What differs between the two element types.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool kHalf = false;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
};

template <>
struct Elem<__half> {
  static constexpr bool kHalf = true;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
};

// wgmma.m64nNk16.f32.TY.TY, TY = bf16 or f16 as T is, N = 2 x the
// accumulator floats per thread (8 -> n16, 16 -> n32, 32 -> n64, 64 ->
// n128). `ss` (n64, n128: the score tiles): A and B from shared memory by
// descriptor; `rs` (n16, n32, n64, n128; `gemm_regs` combines them for D 96
// and 256): A from four two-value registers per thread. scale_d = 0 overwrites the accumulator, 1 adds to it.
// TransB = 1 reads B MN-major. Each body is written once, as FLASH_WGMMA(TY).
template <int TransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, %35;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, %67;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

template <int TransB, typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
#define FLASH_WGMMA(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TransB))
  if constexpr (Elem<T>::kHalf) FLASH_WGMMA("f16"); else FLASH_WGMMA("bf16");
#undef FLASH_WGMMA
}

// acc (+)= A . B^T over D with A [64, D] and B [N, D] tiles in shared memory,
// both K-major (q.k^T, do.v^T; k.q^T, v.do^T in K4). Issue between
// wgmma_fence and wgmma_commit.
template <typename T, int D, int RowsA, int RowsB, int NF>
__device__ __forceinline__ void gemm_rows(float (&acc)[NF], uint32_t a_tile, uint32_t b_tile) {
  static_assert(2 * NF == RowsB, "the accumulator spans the B tile's rows");
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
    wgmma_ss<0, T>(acc, k_major_desc<D, RowsA>(a_tile, t), k_major_desc<D, RowsB>(b_tile, t), t > 0);
}

// acc += X . B[:, col0 : col0 + 2 NF] with X [64, Keys] in registers as T A
// fragments (x[t] holds keys [16 t, 16 t + 16)) and B a [Keys, D] tile in
// shared memory, read MN-major (p.v, ds.k; in K4 the keys are query rows:
// p^T.do, ds^T.q). The 2 NF columns go to wgmmas of at most 128 columns over
// whole panels, widest first (D 96: n64 + n32; D 256: two n128); an
// m64nN accumulator's floats run column chunk by column chunk, so each
// wgmma's accumulator is a contiguous slice of acc. col0 is a multiple of
// the panel width (K4 at D 256 owns half of D's columns).
template <typename T, int D, int Keys, int NF>
__device__ __forceinline__ void gemm_regs(float (&acc)[NF], const uint32_t (&x)[Keys / 16][4], uint32_t b_tile,
                                          int col0 = 0) {
  using P = Panels<D>;
  constexpr int kN = 2 * NF;
  constexpr int kFirst = kN >= 128 ? 128 : (kN >= 64 ? 64 : (kN >= 32 ? 32 : 16));
  static_assert(kN % P::kCols == 0 && kN <= D, "whole panels of B");
  float(&head)[kFirst / 2] = *reinterpret_cast<float(*)[kFirst / 2]>(&acc[0]);
  const uint32_t tile = b_tile + (col0 / P::kCols) * Keys * P::kRowBytes;
#pragma unroll
  for (int t = 0; t < Keys / 16; ++t) wgmma_rs<1, T>(head, x[t], mn_major_desc<D, Keys>(tile, t), 1);
  if constexpr (kFirst < kN) {
    float(&rest)[NF - kFirst / 2] = *reinterpret_cast<float(*)[NF - kFirst / 2]>(&acc[kFirst / 2]);
    gemm_regs<T, D, Keys, NF - kFirst / 2>(rest, x, b_tile, col0 + kFirst);
  }
}

// The accumulator of an m64nN wgmma as seen by one thread of a block of one
// warpgroup: float i of it is row 16 * warp + lane / 4 + 8 * half(i) and
// column column(i) of the 64 x N tile.
struct Frag {
  int row;  // the thread's first row; its second is row + 8
  int col;  // column of float 0 within each 8-column chunk
  __device__ Frag() : row(16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4), col(2 * (threadIdx.x % 4)) {}
  __device__ static constexpr int half(int i) { return (i >> 1) & 1; }
  __device__ int column(int i) const { return 8 * (i / 4) + col + (i & 1); }
};

// Row max and sum over the four lanes that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// An m64nN fp32 accumulator (N keys) narrowed to the T A fragments of the
// next wgmma, which contracts over those keys: register j of k-step t holds
// floats 8 t + 2 j and 8 t + 2 j + 1, the accumulator's own layout.
template <typename T, int NF>
__device__ __forceinline__ void to_fragments(const float (&x)[NF], uint32_t (&frag)[NF / 8][4]) {
#pragma unroll
  for (int t = 0; t < NF / 8; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j) frag[t][j] = Elem<T>::pack(x[8 * t + 2 * j], x[8 * t + 2 * j + 1]);
}

// A ring of kStages shared-memory stages, each a pair of tiles of kN rows
// (K and V in K3 and K5, Q and dO in K4), with one TMA-completion barrier per
// tile. Tile j of the walk lives in stage j % kStages; its barrier completes
// phase j / kStages.
template <int D, int kN, int kStages>
struct PairRing {
  static constexpr int kTileBytes = Panels<D>::tile_bytes(kN);
  static constexpr int kBytes = 2 * kStages * kTileBytes;
  static constexpr int kBarBytes = 2 * kStages * 8;
  uint32_t base;  // first tiles, then second tiles, 1024-aligned
  uint32_t bars;  // first barriers, then second barriers

  __device__ PairRing(uint32_t base_, uint32_t bars_) : base(base_), bars(bars_) {}
  __device__ uint32_t first(int j) const { return base + (j % kStages) * kTileBytes; }
  __device__ uint32_t second(int j) const { return base + (kStages + j % kStages) * kTileBytes; }
  __device__ uint32_t first_bar(int j) const { return bars + 8 * (j % kStages); }
  __device__ uint32_t second_bar(int j) const { return bars + 8 * (kStages + j % kStages); }
  __device__ void init() const {
    for (int i = 0; i < 2 * kStages; ++i) mbar_init(bars + 8 * i, 1);
  }
  // One thread: rows [row0, row0 + kN) of head bh of each map into tile j's stage.
  __device__ void issue(int j, const CUtensorMap* a, const CUtensorMap* b, int bh, int row0) const {
    load_tile<D, kN>(first(j), a, first_bar(j), row0, bh);
    load_tile<D, kN>(second(j), b, second_bar(j), row0, bh);
  }
  __device__ void wait_first(int j) const { mbar_wait(first_bar(j), (j / kStages) & 1); }
  __device__ void wait_second(int j) const { mbar_wait(second_bar(j), (j / kStages) & 1); }
};

__device__ __forceinline__ uint32_t align_1024(uint32_t addr) { return (addr + 1023) & ~1023u; }

// -------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D map over a contiguous T [BH, rows, D] array whose box is one
// panel of box_rows rows, swizzled as Panels<D> says. Returns 0 or an error
// code (kNoTensorMapEncoder, kTensorMapError + CUresult).
template <typename T, int D>
int encode_tile_map(CUtensorMap* map, const void* base, int BH, int rows, int box_rows) {
  using P = Panels<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoTensorMapEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};  // bytes, dims 1 and 2
  const cuuint32_t box[3] = {(cuuint32_t)P::kCols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, Elem<T>::kMapType, 3, const_cast<void*>(base), dims, strides,
                            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, P::kSwizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

}  // namespace flash_tiles
