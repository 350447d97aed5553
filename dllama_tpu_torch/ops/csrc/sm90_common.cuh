// The Hopper (sm_90a) machinery the port's TMA / wgmma kernels share
// (paged_prefill_attention.cu: kernel 8; wgmma_matmul.cuh: the
// tensor-core body of the Q40 and Q80 kernels, 1-3 and 5-6): mbarriers, TMA tile copies and the
// cp.async arrivals a stage barrier can track, the async-proxy fence,
// wgmma's fence / commit / wait, the 128-byte-swizzle descriptors and
// the SS / RS wgmma wrappers (bf16 or f16 in, f32 accumulate: templates
// on the operand type, bf16 by default), and the host's
// tensor-map encoder (cuTensorMapEncodeTiled through the runtime's driver
// entry point: no -lcuda) with a cache of encoded maps.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

// -- mbarriers, TMA, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the barrier's phase also waits for this thread's cp.async copies so far
__device__ __forceinline__ void bar_track_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// generic-proxy shared-memory writes made visible to the async proxy
// (wgmma reads the tiles the threads wrote)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the operand types of the wrappers below
template <typename T>
constexpr bool kWgmmaOperand =
    std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;

// the accumulators are written by wgmma behind the compiler's back: pin
// them after a wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr`: `lbo` the byte stride between 64-element blocks of an MN-major
// operand's MN extent (unused K-major), `sbo` between 8-row groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major; `acc`
// 0 ignores d's old value (scale-d)
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31" \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]) \
        : "l"(a), "l"(b), "r"(acc))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d += A B, m64n64k16, A from registers (operand pairs), B MN-major
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %37, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31" \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d += A B, m64n128k16, A from registers (operand pairs), B MN-major
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d += A B, m64n192k16, A from registers (operand pairs), B MN-major
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %101, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, " \
        "%72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, " \
        "%88, %89, %90, %91, %92, %93, %94, %95" \
        "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d += A B, m64n256k16, A from registers (operand pairs), B MN-major
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %133, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63, " \
        "%64, %65, %66, %67, %68, %69, %70, %71, " \
        "%72, %73, %74, %75, %76, %77, %78, %79, " \
        "%80, %81, %82, %83, %84, %85, %86, %87, " \
        "%88, %89, %90, %91, %92, %93, %94, %95, " \
        "%96, %97, %98, %99, %100, %101, %102, %103, " \
        "%104, %105, %106, %107, %108, %109, %110, %111, " \
        "%112, %113, %114, %115, %116, %117, %118, %119, " \
        "%120, %121, %122, %123, %124, %125, %126, %127" \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), \
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), \
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), \
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
          "+f"(d[126]), "+f"(d[127]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d (+)= A B, m64n16k16, A from registers (operand pairs: wgmma's A
// fragment), B K-major from shared memory (no transpose); `acc` 0 ignores
// d's old value (scale-d)
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %13, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7" \
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_kmaj_n16(float (&d)[8], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d (+)= A B, m64n32k16, A from registers (operand pairs: wgmma's A
// fragment), B K-major from shared memory (no transpose); `acc` 0 ignores
// d's old value (scale-d)
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %21, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15" \
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_kmaj_n32(float (&d)[16], const uint32_t (&a)[4],
                                                  uint64_t b, int acc) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// d (+)= A B, m64n128k16, A from registers (operand pairs: wgmma's A
// fragment), B K-major from shared memory (no transpose); `acc` 0 ignores
// d's old value (scale-d)
#define DLLAMA_WGMMA(TY) \
  asm volatile( \
        "{\n.reg .pred p;\n" \
        "setp.ne.b32 p, %69, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
        "%0, %1, %2, %3, %4, %5, %6, %7, " \
        "%8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, " \
        "%24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, " \
        "%40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, " \
        "%56, %57, %58, %59, %60, %61, %62, %63" \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n" \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc))
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_kmaj_n128(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b, int acc) {
  static_assert(kWgmmaOperand<T>, "wgmma's operands here are bf16 or f16");
  if constexpr (std::is_same<T, __half>::value) {
    DLLAMA_WGMMA("f16");
  } else {
    DLLAMA_WGMMA("bf16");
  }
}
#undef DLLAMA_WGMMA

// One 64-row slab of a 128-byte-swizzled bf16 tile: 64 rows of 128 bytes
// (64 bf16 of the row's contiguous extent).
constexpr int kSw128Slab = 64 * 128;

// Byte offset of 16-byte chunk `ch` (8 elements of the contiguous extent)
// of row r in a 128-byte-swizzled bf16 tile of 64 rows: slabs of 64 rows
// of 128 bytes, the chunk index XORed with the row's low three bits
// (TMA's 128-byte swizzle, which the wgmma descriptors name).
__device__ __forceinline__ int sw_chunk(int r, int ch) {
  return (ch >> 3) * kSw128Slab + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// -- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through the runtime (no -lcuda)
inline cudaError_t encode_fn(EncodeTiled* out) {
  static EncodeTiled fn_ptr = nullptr;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  if (fn_ptr == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &got);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &got);
#endif
    if (e != cudaSuccess) return e;
    if (fn == nullptr || got != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    fn_ptr = reinterpret_cast<EncodeTiled>(fn);
  }
  *out = fn_ptr;
  return cudaSuccess;
}

// A 2-D tiled map of `dtype` over `rows` rows of `cols` elements, rows
// `row_bytes` apart, boxes of box_c x box_r, OOB reads zero-filled.
inline cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* ptr,
                             unsigned long long cols, unsigned long long rows,
                             unsigned long long row_bytes, unsigned box_c, unsigned box_r,
                             CUtensorMapSwizzle swizzle) {
  EncodeTiled enc;
  cudaError_t e = encode_fn(&enc);
  if (e != cudaSuccess) return e;
  const cuuint32_t unit[2] = {1, 1};
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_r)};
  const CUresult r = enc(map, dtype, 2, const_cast<void*>(ptr), dim, stride, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of static operands (pools, weight planes) encoded once and kept,
// keyed by everything the map encodes; the oldest entry goes first.
struct MapKey {
  const void* ptr;
  unsigned long long cols, rows, row_bytes;
  int dtype, box_c, box_r, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && cols == o.cols && rows == o.rows && row_bytes == o.row_bytes &&
           dtype == o.dtype && box_c == o.box_c && box_r == o.box_r && swizzle == o.swizzle;
  }
};

inline cudaError_t cached_map_2d(CUtensorMap* out, CUtensorMapDataType dtype, const void* ptr,
                                 unsigned long long cols, unsigned long long rows,
                                 unsigned long long row_bytes, unsigned box_c, unsigned box_r,
                                 CUtensorMapSwizzle swizzle) {
  constexpr int kMaps = 64;
  static std::mutex mu;
  static MapKey keys[kMaps];
  static CUtensorMap maps[kMaps];
  static int n = 0, next = 0;
  const MapKey k{ptr, cols, rows, row_bytes, static_cast<int>(dtype), static_cast<int>(box_c),
                 static_cast<int>(box_r), static_cast<int>(swizzle)};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i) {
    if (keys[i] == k) {
      *out = maps[i];
      return cudaSuccess;
    }
  }
  keys[next].ptr = nullptr;
  const cudaError_t e =
      encode_2d(&maps[next], dtype, ptr, cols, rows, row_bytes, box_c, box_r, swizzle);
  if (e != cudaSuccess) return e;
  keys[next] = k;
  *out = maps[next];
  next = (next + 1) % kMaps;
  if (n < kMaps) ++n;
  return cudaSuccess;
}

}  // namespace
