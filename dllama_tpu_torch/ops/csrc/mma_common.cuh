// The small pieces the matmul kernels and kernel 8 share: the opt-in
// shared memory of a block, the exact f16 widening, the zero-filling
// cp.async copies (the tensor-core body's fallback copies of the weights,
// wgmma_matmul.cuh, and kernel 8's scale copies,
// paged_prefill_attention.cu), and the mma.sync m16n8k16 wrapper (bf16 in,
// f32 accumulate) of the decode body (gemv_common.cuh).  The tensor-core
// body of both codecs is a Hopper body (wgmma_matmul.cuh over
// sm90_common.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
