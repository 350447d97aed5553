// Q80 dequant-matmul for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces: the Pallas kernels of dllama_tpu/ops/q8.py — _q8_kernel
// (entered through _pallas_matmul, the 2-D wcls head) and
// _stacked_q8_kernel (entered through _pallas_matmul_stacked, the
// layer-stacked wqkv/wo/w13/w2 and the layer x expert up/gate/down):
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,   W[k, j] = bf16(f32(v[k, j]) * f32(s[k/32, j]))
//
// one bf16 round of the file codec's f32 dequant, products of bf16 values
// (exact in f32) summed in f32: the TPU kernel's numerics.
//
// Storage (byte-identical to the JAX package): int8 values (np, d), one row
// per input position; f16 scales (np/32, d).  Rows past n (pack padding)
// have zero values and scales and are never read: the reduction stops at
// n, so x needs no zero padding to np (the padded rows would add 0 * 0).
// Stacked planes (layers, or layer x expert of an MoE stack) are one
// buffer; the plane to read is an int32 in device memory, read by every
// block (the counterpart of the TPU kernel's scalar-prefetched index), so
// an expert chosen by a top-k on the device needs no host read.
//
// What bounds it on this card: at decode (t = 1) each weight is read once
// and used once, so the kernel is bound by the bytes of the planes, 1.0625
// B/weight (1 value + 0.0625 scale), against 3.35 TB/s of HBM on an H100
// SXM: 7.2 GB per Llama-2-7B token, a floor of about 2.1 ms.
//
// What the design does about it (the Q40 kernel's, csrc/q40_matmul.cu):
//  * Loads are coalesced along d, the contiguous axis of both planes: each
//    thread owns 4 adjacent output columns and reads their 4 int8 values
//    (one 32-bit load) per row and 4 scales (one 64-bit load) per block;
//    a warp reads 128 contiguous bytes per row.
//  * Each thread loads the 32 rows of a quantization block into registers
//    before it converts any, so 32 loads per thread are in flight.
//  * The reduction over n is split across blockIdx.y into an f32 scratch
//    (splits, t, d) that the caller allocates, and a second pass adds the
//    splits in a fixed order: enough blocks for the 132 SMs at decode, no
//    float atomics, results that repeat bit for bit.
//  * An int8 becomes a float with one XOR, one OR and one subtract (the
//    2^23 magic-number trick, exact), and two weights round to bf16 in one
//    paired __floats2bfloat162_rn (round to nearest even).
//  * Activations are staged through shared memory in chunks of 8 blocks
//    (256 rows of x), read as broadcasts; rows of x go in groups of TG (1
//    at decode, up to 8), so t = 128 loops over 16 row groups.
// wgmma, TMA and a software pipeline are left to later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                   // threads per block
constexpr int kCols = 4;                        // output columns per thread
constexpr int kBlockCols = kThreads * kCols;    // 512: q40.BLOCK_COLS
constexpr int kChunk = 8;                       // quant blocks of x staged per pass

// The int8 in the low byte of `byte` as a float, exactly: XOR 0x80 gives
// v + 128 in 0..255, the OR builds 2^23 + v + 128, and the subtraction of
// 2^23 + 128 is exact.
__device__ __forceinline__ float i8_to_f32(uint32_t byte) {
  return __uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.0f;
}

__device__ __forceinline__ float f16_bits(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

template <int TG>
__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n)
                 const int8_t* __restrict__ qvals,       // (n_planes, np, d)
                 const __half* __restrict__ scales,      // (n_planes, np/32, d)
                 const int* __restrict__ plane_p,        // the plane to read
                 float* __restrict__ part,               // (splits, t, d)
                 int t, int n, int np, int d, int n_planes, int kb_per) {
  __shared__ float xs[TG][kChunk * 32];
  // the plane index lives in device memory (a layer, or layer*E + expert
  // chosen on the device); clamping keeps a bad value inside the planes
  const size_t plane = (size_t)min(max(*plane_p, 0), n_planes - 1);
  const uint8_t* qv = reinterpret_cast<const uint8_t*>(qvals) +
                      plane * (size_t)np * (size_t)d;
  const __half* sc = scales + plane * (size_t)(np / 32) * (size_t)d;
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
      for (int e = threadIdx.x; e < TG * span; e += kThreads) {
        const int row = e / span;
        const int k = e - row * span;
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
          s[0] = f16_bits(raw.x & 0xFFFFu);
          s[1] = f16_bits(raw.x >> 16);
          s[2] = f16_bits(raw.y & 0xFFFFu);
          s[3] = f16_bits(raw.y >> 16);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            s[c] = col0 + c < d ? __half2float(sc[b * d + col0 + c]) : 0.f;
        }
        // all 32 rows of the block are loaded before any is used, so each
        // thread keeps 32 independent loads in flight
        const uint8_t* rowp = qv + b * 32 * d + col0;
        uint32_t w4[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (vec) {
            w4[r] = __ldg(reinterpret_cast<const unsigned int*>(rowp + (size_t)r * d));
          } else {
            w4[r] = 0u;  // value 0: weight 0 in the masked columns
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (col0 + c < d) w4[r] |= (uint32_t)rowp[(size_t)r * d + c] << (8 * c);
          }
        }
#pragma unroll
        for (int r = 0; r < 32; ++r) {
#pragma unroll
          for (int c = 0; c < kCols; c += 2) {
            const __nv_bfloat162 w = __floats2bfloat162_rn(
                i8_to_f32((w4[r] >> (8 * c)) & 0xFFu) * s[c],
                i8_to_f32((w4[r] >> (8 * c + 8)) & 0xFFu) * s[c + 1]);
            const float w0 = __low2float(w);
            const float w1 = __high2float(w);
#pragma unroll
            for (int i = 0; i < TG; ++i) {
              acc[i][c] = fmaf(xs[i][bb * 32 + r], w0, acc[i][c]);
              acc[i][c + 1] = fmaf(xs[i][bb * 32 + r], w1, acc[i][c + 1]);
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
__global__ void q8_reduce_splits(const float* __restrict__ part,
                                 float* __restrict__ out, int splits,
                                 size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
  out[i] = s;
}

template <int TG>
void launch(const __nv_bfloat16* x, const int8_t* qv, const __half* sc,
            const int* idx, float* part, int t, int n, int np, int d,
            int n_planes, int splits, int kb_per, cudaStream_t stream) {
  const dim3 grid((d + kBlockCols - 1) / kBlockCols, splits);
  q8_matmul_kernel<TG><<<grid, kThreads, 0, stream>>>(
      x, qv, sc, idx, part, t, n, np, d, n_planes, kb_per);
}

}  // namespace

// x (t, n) bf16; qvals (n_planes, np, d) int8 (any leading dims,
// flattened); scales (n_planes, np/32, d) f16; idx one int32 in device
// memory, the plane to read (clamped to 0..n_planes-1); out (t, d) f32;
// scratch (splits, t, d) f32 when splits > 1.  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int q8_matmul(const void* x, const void* qvals, const void* scales,
                         void* out, void* scratch, const void* idx, int t, int n,
                         int np, int d, int n_planes, int splits, int kb_per,
                         void* stream) {
  const int8_t* qv = static_cast<const int8_t*>(qvals);
  const __half* sc = static_cast<const __half*>(scales);
  const int* ip = static_cast<const int*>(idx);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 1)
    launch<1>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, s);
  else if (t == 2)
    launch<2>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, s);
  else if (t <= 4)
    launch<4>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, s);
  else
    launch<8>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, s);
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    q8_reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}
