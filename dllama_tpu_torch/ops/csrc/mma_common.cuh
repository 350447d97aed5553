// The Q80 dequant-matmul's tensor-core machinery (q8_matmul.cu): the BM x
// 128 output tile, the cp.async copies that stage a step's tiles into
// shared memory with zero-fill (also the Q40 tensor-core body's fallback
// copies, q40_matmul.cu, and kernel 8's scale copies), and the ldmatrix /
// mma.sync m16n8k16 (bf16 in, f32 accumulate) wrappers.  The Q40 body is a
// Hopper body of its own (sm90_common.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMmaBN = 128;       // output columns a block: ops/q8.py MMA_BN
constexpr int kMmaBK = 64;        // rows of n a step: ops/q8.py MMA_BK
constexpr int kXS = kMmaBK + 8;   // bf16 row stride of the x tile
constexpr int kWS = kMmaBN + 8;   // bf16 row stride of a dequantized tile
constexpr int kMaxSmem = 232448;

// f16 bits (the low 16 of `bits`) widened to f32, exactly
__device__ __forceinline__ float f16_bits(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int sz = ok ? N : 0;
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(sz)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(N),
                 "r"(sz)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void stage_rows_n(unsigned char* dst, int dst_stride,
                                             const unsigned char* src, long stride, int rows,
                                             int row_bytes, int valid_rows, int valid_bytes) {
  const int per = row_bytes / N;  // a power of two
  const int shift = __ffs(per) - 1;
  for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
    const int r = e >> shift;
    const int i = e & (per - 1);
    const bool ok = r < valid_rows && (i + 1) * N <= valid_bytes;
    cp_async_zfill<N>(dst + r * dst_stride + i * N, ok ? src + r * stride + i * N : src, ok);
  }
}

// `rows` rows of `row_bytes` (64..256, a power of two) from global rows
// `stride` bytes apart into shared rows `dst_stride` bytes apart; rows at
// or past `valid_rows` and bytes at or past `valid_bytes` of a row are
// zero.  `al` (16, 8 or 4) divides the stride, `src` and `valid_bytes`;
// al == 0 (a row stride of odd bytes) copies byte by byte with plain loads.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src, long stride, int rows,
                                           int row_bytes, int valid_rows, int valid_bytes,
                                           int al) {
  switch (al) {
    case 16:
      stage_rows_n<16>(dst, dst_stride, src, stride, rows, row_bytes, valid_rows, valid_bytes);
      break;
    case 8:
      stage_rows_n<8>(dst, dst_stride, src, stride, rows, row_bytes, valid_rows, valid_bytes);
      break;
    case 4:
      stage_rows_n<4>(dst, dst_stride, src, stride, rows, row_bytes, valid_rows, valid_bytes);
      break;
    default:
      for (int e = threadIdx.x; e < rows * row_bytes; e += blockDim.x) {
        const int r = e / row_bytes;
        const int i = e - r * row_bytes;
        dst[r * dst_stride + i] =
            r < valid_rows && i < valid_bytes ? src[r * stride + i] : static_cast<unsigned char>(0);
      }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Threads a block (256, or 512 for BM = 128, one block an SM) in WM x WN
// warps: WM along M (MT m16 tiles each), WN along N (NT n8 tiles each)
template <int BM> struct MmaShape {
  static constexpr int Threads = BM == 128 ? 512 : 256;
  static constexpr int MinBlocks = BM == 128 ? 1 : 2;
  static constexpr int WM = BM == 128 ? 4 : (BM >= 32 ? 2 : 1);
  static constexpr int WN = Threads / 32 / WM;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = kMmaBN / WN / 8;
  static constexpr int RowsEach = kMmaBK * 32 / Threads;  // dequantized Q80 rows a thread
};

}  // namespace
