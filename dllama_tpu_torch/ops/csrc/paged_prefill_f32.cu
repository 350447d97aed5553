// Kernel 8's f32 pool body (paged_prefill_attention.cuh), instantiated
// apart from the others so that nvcc builds them in parallel.

#include "paged_prefill_attention.cuh"

namespace dllama_prefill {

cudaError_t pass1_f32(int dhp, const Args& a) {
  switch (dhp) {
    case 64:
      return a.dh == 64 ? launch_f32<64, true>(a) : launch_f32<64, false>(a);
    case 128:
      return a.dh == 128 ? launch_f32<128, true>(a) : launch_f32<128, false>(a);
    case 192:
      return a.dh == 192 ? launch_f32<192, true>(a) : launch_f32<192, false>(a);
    case 256:
      return a.dh == 256 ? launch_f32<256, true>(a) : launch_f32<256, false>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dllama_prefill
