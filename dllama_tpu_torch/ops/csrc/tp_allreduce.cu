// Tensor-parallel all-reduce of f32 partial sums for Hopper (sm_90a):
// kernel 4, bound to PyTorch through ctypes.
//
// Replaces the TPU kernel dllama_tpu/ops/q40.py:988 _tp_ring_allreduce
// (Pallas body _ring_reduce_kernel, :923): every column-sharded matmul (wo,
// w2, an expert's down) leaves a (t, d) f32 partial sum on each of the tp
// ranks, and every rank needs their sum.  The function is the TPU
// kernel's, add for add: with h = d / 2, rank r writes
//
//   o_r[:, :h] = ((x_r + x_{r-1}) + x_{r-2}) + ... + x_{r-tp+1}
//   o_r[:, h:] = ((x_r + x_{r+1}) + x_{r+2}) + ... + x_{r+tp-1}
//
// (indices mod tp): the first half arrives from the left neighbour, the
// second from the right one, as the TPU's bidirectional ring circulates
// them.  For tp = 2 every rank's sum is the same; for tp >= 3 the ranks may
// differ in the last bits, as they do on the TPU.  The adds are __fadd_rn
// (no contraction), so the plain PyTorch version (ops/q40.py
// tp_allreduce_plain) equals this kernel bit for bit.
//
// What bounds it on this card: latency.  At decode a partial is t * d * 4
// bytes a rank (16 KB at t = 1, d = 4096), so reading tp partials and
// writing one output takes well under a microsecond of HBM or NVLink time;
// a forward makes two calls a layer (64 at Llama-2-7B), each one launch.
// On the TPU the ring exists because ICI links join neighbours; H100s of
// one host are joined all to all (NVLink), so the design here is a
// one-shot read-all: each rank reads every peer's partial directly and
// adds them in its ring order in registers.  One launch per rank, no
// communication buffers, no atomics: results repeat bit for bit.
//
//  * The tp input and output pointers travel by value in the kernel's
//    parameters (a struct of up to kMaxTp of each), so a call copies
//    nothing from the host.
//  * Ranks on one card (a one-card machine, or --device cuda:K):
//    one launch, blockIdx.y = rank, on the caller's stream.
//  * Ranks on distinct cards: one launch per rank on that card's stream,
//    reading the peers' partials through peer pointers (peer access is
//    enabled once by tp_enable_peer); the wrapper orders each launch after
//    every peer's "partial ready" event and keeps the partials alive until
//    the readers finish (record_stream).
//  * Loads and stores are 16 bytes a thread (float4) when a vector never
//    straddles the two halves or a row (h % 4 == 0) and the buffers are
//    16-byte aligned; a scalar path covers any other even d.
// A later PR may fold the two calls of a layer into one persistent launch,
// or go two-shot (reduce-scatter + all-gather) for t = 128 prefill across
// cards, where the bytes start to matter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTp = 8;        // python: ops/q40.py TP_MAX
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // grid-stride beyond this

struct Ranks {
  const float* in[kMaxTp];
  float* out[kMaxTp];
};

__device__ __forceinline__ void add_to(float& a, float b) { a = __fadd_rn(a, b); }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  a.x = __fadd_rn(a.x, b.x);
  a.y = __fadd_rn(a.y, b.y);
  a.z = __fadd_rn(a.z, b.z);
  a.w = __fadd_rn(a.w, b.w);
}

// T is float (one column a thread step) or float4 (four); n_vec, d_vec and
// h_vec count T elements: the whole (t, d) partial, a row, a half row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
tp_allreduce_kernel(Ranks ranks, int tp, int rank0, long long n_vec, int d_vec,
                    int h_vec) {
  const int r = rank0 + blockIdx.y;
  T* out = reinterpret_cast<T*>(ranks.out[r]);
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * kThreads) {
    // the first half walks to the left (r - 1 = r + tp - 1 mod tp), the
    // second to the right
    const int step = (int)(i % d_vec) < h_vec ? tp - 1 : 1;
    int src = r;
    T acc = reinterpret_cast<const T*>(ranks.in[src])[i];
    for (int s = 1; s < tp; ++s) {
      src += step;
      if (src >= tp) src -= tp;
      add_to(acc, reinterpret_cast<const T*>(ranks.in[src])[i]);
    }
    out[i] = acc;
  }
}

}  // namespace

// Rank r's sum for r in rank0 .. rank0 + n_ranks - 1, in one launch on
// `stream`: ins[0..tp-1] are the partials (t, d) f32, outs[0..tp-1] the
// outputs (only those of the launched ranks are written).  vec = 4 takes
// the float4 path (the caller checked h % 4 == 0 and 16-byte alignment).
// Returns a CUDA error code (0 on success).
extern "C" int tp_allreduce(const void* const* ins, void* const* outs, int tp,
                            int rank0, int n_ranks, int t, int d, int vec,
                            void* stream) {
  if (tp < 1 || tp > kMaxTp || rank0 < 0 || n_ranks < 1 || rank0 + n_ranks > tp ||
      t < 1 || d < 2 || d % 2 || (vec != 1 && vec != 4) || (vec == 4 && (d / 2) % 4))
    return (int)cudaErrorInvalidValue;
  Ranks ranks = {};
  for (int i = 0; i < tp; ++i) {
    ranks.in[i] = static_cast<const float*>(ins[i]);
    ranks.out[i] = static_cast<float*>(outs[i]);
  }
  const long long n_vec = (long long)t * d / vec;
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(want < kMaxBlocks ? want : kMaxBlocks), (unsigned)n_ranks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    tp_allreduce_kernel<float4><<<grid, kThreads, 0, s>>>(ranks, tp, rank0, n_vec,
                                                         d / 4, d / 8);
  else
    tp_allreduce_kernel<float><<<grid, kThreads, 0, s>>>(ranks, tp, rank0, n_vec, d,
                                                        d / 2);
  return (int)cudaGetLastError();
}

// Let card `dev` read card `peer`'s memory (once per ordered pair; an
// already enabled pair is success).  Returns 0, a CUDA error code, or -1
// when the two cards have no peer access at all.
extern "C" int tp_enable_peer(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return -1;
  int cur = 0;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error status the call left behind
    e = cudaSuccess;
  }
  cudaSetDevice(cur);
  return (int)e;
}
