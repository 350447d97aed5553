// Kernel 8's f16 pool bodies (paged_prefill_attention.cuh), instantiated
// apart from the others so that nvcc builds them in parallel.

#include "paged_prefill_attention.cuh"

namespace dllama_prefill {

cudaError_t pass1_f16(int dhp, const Args& a) { return pass1_tc<__half>(dhp, a); }

}  // namespace dllama_prefill
