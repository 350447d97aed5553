// Q40 dequant-matmul for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces: the Pallas kernels of dllama_tpu/ops/q40.py — _q40_kernel
// (entered through _pallas_matmul, the 2-D wcls head) and
// _stacked_q40_kernel (entered through _pallas_matmul_stacked, the
// layer-stacked wqkv/wo/w13/w2), "classic" variant:
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,   W[k, j] = bf16(f32(nib(k, j) - 8) * f32(s[k/32, j]))
//
// Storage (block-local, byte-identical to the JAX package): packed row
// 16b + r of the (np/2, d) uint8 plane holds logical row 32b + r in its low
// nibble and 32b + 16 + r in its high nibble, biased +8; scales are f16
// (np/32, d).  Rows past n (pack padding) have zero scales and are never
// read: the reduction stops at n, so x is never read past n either.
//
// What bounds it on this card: at decode (t = 1) each weight is read once
// and used once, so the kernel is bound by the bytes of the packed planes,
// 0.5625 B/weight (0.5 nibble + 0.0625 scale), against 3.35 TB/s of HBM on
// an H100 SXM: 3.74 GB per Llama-2-7B token, a floor of about 1.1 ms.
//
// What the design does about it:
//  * Loads are coalesced along d, the contiguous axis of both planes: each
//    thread owns 4 adjacent output columns and reads 4 packed bytes (one
//    32-bit load) per packed row and 4 scales (one 64-bit load) per block;
//    a warp reads 128 contiguous bytes per row.
//  * Each thread loads the 16 packed rows of a quantization block into
//    registers before it unpacks any, so 16 loads per thread are in flight.
//  * At decode d / 512 column blocks alone would leave most of the 132 SMs
//    idle (8 blocks for d = 4096), so the reduction over n is split across
//    blockIdx.y into an f32 scratch (splits, t, d) that the caller
//    allocates; a second pass adds the splits in a fixed order.  No float
//    atomics: results repeat bit for bit, so greedy runs do too.
//  * The unpack is the compute side of the bound (about 10 operations per
//    byte is the card's ratio of CUDA-core rate to memory rate), so it is
//    kept short: a nibble becomes (v - 8) as a float with one OR and one
//    subtract (the 2^23 magic-number trick, exact) instead of an int->float
//    conversion, and the bf16 rounding of the lo and hi weights is one
//    paired __floats2bfloat162_rn (round to nearest even, the same rounding
//    as __float2bfloat16_rn on each).
//  * Activations are staged through shared memory in chunks of 8 blocks
//    (256 rows of x), read as broadcasts.  Rows of x are processed in groups
//    of TG (a template parameter: 1 at decode, up to 8), so t = 128 loops
//    over 16 row groups instead of holding 128 accumulators per thread.
// wgmma, TMA and a software pipeline are left to later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                   // threads per block
constexpr int kCols = 4;                        // output columns per thread
constexpr int kBlockCols = kThreads * kCols;    // 512: BLOCK_COLS in q40.py
constexpr int kChunk = 8;                       // quant blocks of x staged per pass

// (nib - 8) as a float, exactly: 0x4B000000 is 2^23, so the OR builds
// 2^23 + nib and the subtraction of 2^23 + 8 is exact.
__device__ __forceinline__ float nib_minus_8(uint32_t nib) {
  return __uint_as_float(0x4B000000u | nib) - 8388616.0f;
}

template <int TG>
__global__ void __launch_bounds__(kThreads)
q40_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n)
                  const uint8_t* __restrict__ qp,         // (np/2, d), this layer
                  const __half* __restrict__ sc,          // (np/32, d), this layer
                  float* __restrict__ part,               // (splits, t, d)
                  int t, int n, int d, int kb_per) {
  __shared__ float xs[TG][kChunk * 32];
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int nb = n / 32;
  const int kb_begin = blockIdx.y * kb_per;
  const int kb_end = min(nb, kb_begin + kb_per);
  const bool vec = (d % kCols == 0) && (col0 + kCols <= d);
  float* dst = part + (size_t)blockIdx.y * t * d;

  for (int g0 = 0; g0 < t; g0 += TG) {
    const int tg = min(TG, t - g0);
    float acc[TG][kCols];
#pragma unroll
    for (int i = 0; i < TG; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

    for (int cb = kb_begin; cb < kb_end; cb += kChunk) {
      const int span = min(kChunk, kb_end - cb) * 32;
      __syncthreads();  // every thread is done with the previous chunk
      for (int idx = threadIdx.x; idx < TG * span; idx += kThreads) {
        const int row = idx / span;
        const int k = idx - row * span;
        xs[row][k] = row < tg
            ? __bfloat162float(x[(size_t)(g0 + row) * n + cb * 32 + k]) : 0.f;
      }
      __syncthreads();
      if (col0 >= d) continue;
      for (int bb = 0; bb < span / 32; ++bb) {
        const size_t b = (size_t)(cb + bb);
        float s[kCols];
        if (vec) {
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(sc + b * d + col0));
          s[0] = __half2float(__ushort_as_half((unsigned short)(raw.x & 0xFFFFu)));
          s[1] = __half2float(__ushort_as_half((unsigned short)(raw.x >> 16)));
          s[2] = __half2float(__ushort_as_half((unsigned short)(raw.y & 0xFFFFu)));
          s[3] = __half2float(__ushort_as_half((unsigned short)(raw.y >> 16)));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            s[c] = col0 + c < d ? __half2float(sc[b * d + col0 + c]) : 0.f;
        }
        // all 16 packed rows of the block are loaded before any is used,
        // so each thread keeps 16 independent loads in flight
        const uint8_t* rowp = qp + b * 16 * d + col0;
        uint32_t w4[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (vec) {
            w4[r] = __ldg(reinterpret_cast<const unsigned int*>(rowp + (size_t)r * d));
          } else {
            w4[r] = 0x88888888u;  // nibbles of 8: weight 0 in the masked columns
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (col0 + c < d)
                w4[r] = (w4[r] & ~(0xFFu << (8 * c))) |
                        ((uint32_t)rowp[(size_t)r * d + c] << (8 * c));
          }
        }
#pragma unroll
        for (int r = 0; r < 16; ++r) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t byte = (w4[r] >> (8 * c)) & 0xFFu;
            const __nv_bfloat162 w = __floats2bfloat162_rn(
                nib_minus_8(byte & 0xFu) * s[c], nib_minus_8(byte >> 4) * s[c]);
            const float wlo = __low2float(w);
            const float whi = __high2float(w);
#pragma unroll
            for (int i = 0; i < TG; ++i) {
              acc[i][c] = fmaf(xs[i][bb * 32 + r], wlo, acc[i][c]);
              acc[i][c] = fmaf(xs[i][bb * 32 + 16 + r], whi, acc[i][c]);
            }
          }
        }
      }
    }
    if (col0 < d) {
#pragma unroll
      for (int i = 0; i < TG; ++i) {
        if (i >= tg) break;
        float* o = dst + (size_t)(g0 + i) * d + col0;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (col0 + c < d) o[c] = acc[i][c];
      }
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in split order: deterministic.
__global__ void q40_reduce_splits(const float* __restrict__ part,
                                  float* __restrict__ out, int splits,
                                  size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
  out[i] = s;
}

template <int TG>
void launch(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
            float* part, int t, int n, int d, int splits, int kb_per,
            cudaStream_t stream) {
  const dim3 grid((d + kBlockCols - 1) / kBlockCols, splits);
  q40_matmul_kernel<TG><<<grid, kThreads, 0, stream>>>(x, qp, sc, part, t, n,
                                                        d, kb_per);
}

}  // namespace

// x (t, n) bf16; qpacked (L, np/2, d) u8 or (np/2, d); scales (L, np/32, d)
// f16 or (np/32, d); out (t, d) f32; scratch (splits, t, d) f32 when
// splits > 1.  Reads layer `layer` of the stacked planes in place.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int q40_matmul(const void* x, const void* qpacked,
                          const void* scales, void* out, void* scratch, int t,
                          int n, int np, int d, long long layer, int splits,
                          int kb_per, void* stream) {
  const uint8_t* qp = static_cast<const uint8_t*>(qpacked) +
                      (size_t)layer * (size_t)(np / 2) * (size_t)d;
  const __half* sc = static_cast<const __half*>(scales) +
                     (size_t)layer * (size_t)(np / 32) * (size_t)d;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 1)
    launch<1>(xb, qp, sc, part, t, n, d, splits, kb_per, s);
  else if (t == 2)
    launch<2>(xb, qp, sc, part, t, n, d, splits, kb_per, s);
  else if (t <= 4)
    launch<4>(xb, qp, sc, part, t, n, d, splits, kb_per, s);
  else
    launch<8>(xb, qp, sc, part, t, n, d, splits, kb_per, s);
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    q40_reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* q40_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
