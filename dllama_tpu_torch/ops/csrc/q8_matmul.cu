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
// Two bodies: for calls of t < T_MMA rows (decode) the decode body of
// csrc/gemv_common.cuh, one template with the Q40 kernel's (the Q8 codec
// here), one launch a call; the tensor-core body below for t >= T_MMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "mma_common.cuh"

namespace {

// out[i] = part[0][i] + part[1][i] + ... in split order: deterministic
// (the tensor-core body's split-K).
__global__ void q8_reduce_splits(const float* __restrict__ part,
                                 float* __restrict__ out, int splits,
                                 size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// The tensor-core body, for t >= T_MMA rows (python: ops/q8.py T_MMA).
//
// T_MMA: the crossover with the decode body that chip_smoke.py phase 9
// measures (PERF.md).  Above a few rows the decode body re-reads and
// re-dequantizes every weight once a group of 8 rows.  This body
// dequantizes each weight once per BM rows of x and multiplies on the
// tensor cores:
//  * A block owns a BM x 128 output tile (BM in 16, 32, 64, 128: the least
//    that covers t; ops/q8.py mma_plan) and walks its share of n in steps
//    of 64 rows (two quantization blocks).  Up to BM = 64 a block has 256
//    threads and an SM holds two; at BM = 128, 512 threads and one.  The M
//    tiles of one weight tile are neighbours in the grid, so they share its
//    bytes in L2.  The split-K count fills about one wave of the SMs'
//    blocks; partial sums go
//    to f32 scratch (splits, t, d) and add in a fixed order
//    (q8_reduce_splits), so results repeat bit for bit.
//  * cp.async brings the raw int8 tile (64 x 128 bytes), its two f16 scale
//    rows and the bf16 x tile (BM x 64) into a ring of kMmaStages stages,
//    zero-filling rows past t and n and columns past d; the widest copy
//    that the row stride and the pointers allow (16, 8 or 4 bytes).
//  * The threads dequantize step s+1's int8 tile into one of two bf16 tiles
//    in shared memory, bf16(f32(v) * f32(s)) rounded to nearest even (the
//    GEMV body's numerics; the int8 values widen four at a time with byte
//    permutes), while the warps run mma.sync m16n8k16 (bf16 in, f32
//    accumulate) on step s's tile: x through ldmatrix, the (k, d) weight
//    tile through ldmatrix.trans.  One barrier a step.  Rows of both shared
//    tiles are padded by 16 bytes, so ldmatrix reads no bank twice.
// Products of bf16 values are exact in f32, so the result differs from the
// GEMV body's only in the order of the f32 sums.

// The tile constants (kMmaBN, kMmaBK, the padded strides), the cp.async,
// ldmatrix and mma.sync helpers and MmaShape are mma_common.cuh's, shared
// with the Q40 kernel's tensor-core body.
constexpr int kMmaStages = 4;     // ring stages

// int8 byte `k` of `u` (its bytes already XORed with 0x80) as a float,
// exactly: the byte permute builds 2^23 + v + 128, the subtraction is exact
template <int K>
__device__ __forceinline__ float i8x4_f32(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + K)) - 8388736.0f;
}

template <int BM>
__host__ __device__ constexpr int mma_stage_bytes() {
  return kMmaBK * kMmaBN + 2 * kMmaBN * 2 + BM * kXS * 2;  // int8 tile, scales, x tile
}

template <int BM>
__host__ __device__ constexpr int mma_smem_bytes() {
  return kMmaStages * mma_stage_bytes<BM>() + 2 * kMmaBK * kWS * 2;  // + two bf16 tiles
}

template <int BM>
__global__ void __launch_bounds__(MmaShape<BM>::Threads, MmaShape<BM>::MinBlocks)
q8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,  // (t, n)
                     const int8_t* __restrict__ qvals,      // (n_planes, np, d)
                     const __half* __restrict__ scales,     // (n_planes, np/32, d)
                     const int* __restrict__ plane_p,       // the plane to read
                     float* __restrict__ part,              // (splits, t, d)
                     int t, int n, int np, int d, int n_planes, int steps_per, int w_al,
                     int s_al) {
  using S = MmaShape<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = mma_stage_bytes<BM>();
  __nv_bfloat16* wbs = reinterpret_cast<__nv_bfloat16*>(smem + kMmaStages * kStage);

  const size_t plane = (size_t)min(max(*plane_p, 0), n_planes - 1);
  const unsigned char* qv = reinterpret_cast<const unsigned char*>(qvals) +
                            plane * (size_t)np * (size_t)d;
  const unsigned char* sc = reinterpret_cast<const unsigned char*>(
      scales + plane * (size_t)(np / 32) * (size_t)d);
  const int m0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kMmaBN;
  const int n_steps = (n + kMmaBK - 1) / kMmaBK;
  const int s_begin = blockIdx.z * steps_per;
  const int n_mine = min(n_steps, s_begin + steps_per) - s_begin;
  const int vc = min(kMmaBN, d - col0);  // live columns of the tile
  const int nb = n / 32;

  auto fetch = [&](int i) {
    unsigned char* st = smem + (i % kMmaStages) * kStage;
    const int k0 = (s_begin + i) * kMmaBK;
    stage_rows(st, kMmaBN, qv + (size_t)k0 * d + col0, d, kMmaBK, kMmaBN, n - k0, vc, w_al);
    stage_rows(st + kMmaBK * kMmaBN, 2 * kMmaBN, sc + ((size_t)(k0 / 32) * d + col0) * 2,
               2L * d, 2, 2 * kMmaBN, nb - k0 / 32, 2 * vc, s_al);
    stage_rows(st + kMmaBK * kMmaBN + 4 * kMmaBN, kXS * 2,
               reinterpret_cast<const unsigned char*>(x + (size_t)m0 * n + k0), 2L * n, BM,
               2 * kMmaBK, t - m0, 2 * min(kMmaBK, n - k0), 16);
  };

  // dequantization: thread owns columns 4*cg..4*cg+3 of RowsEach rows from
  // RowsEach*rg, all in one quantization block
  const int cg = threadIdx.x & 31;
  const int rg = threadIdx.x >> 5;
  auto dequant = [&](int i) {
    const unsigned char* st = smem + (i % kMmaStages) * kStage;
    __nv_bfloat16* wb = wbs + (i & 1) * kMmaBK * kWS;
    const uint2 sraw = *reinterpret_cast<const uint2*>(
        st + kMmaBK * kMmaBN + (rg * S::RowsEach >> 5) * 2 * kMmaBN + cg * 8);
    const float s0 = f16_bits(sraw.x & 0xFFFFu), s1 = f16_bits(sraw.x >> 16);
    const float s2 = f16_bits(sraw.y & 0xFFFFu), s3 = f16_bits(sraw.y >> 16);
#pragma unroll
    for (int r = 0; r < S::RowsEach; ++r) {
      const int row = rg * S::RowsEach + r;
      const uint32_t u =
          *reinterpret_cast<const uint32_t*>(st + row * kMmaBN + cg * 4) ^ 0x80808080u;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(i8x4_f32<0>(u) * s0, i8x4_f32<1>(u) * s1);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(i8x4_f32<2>(u) * s2, i8x4_f32<3>(u) * s3);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(wb + row * kWS + cg * 4) = packed;
    }
  };

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / S::WN;
  const int wn = warp - wm * S::WN;
  // ldmatrix: this lane's row (of 16) and 8-column half of the four 8x8
  // matrices it addresses
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lc = (lane >> 4) * 8;
  float acc[S::MT][S::NT][4];
#pragma unroll
  for (int i = 0; i < S::MT; ++i)
#pragma unroll
    for (int j = 0; j < S::NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

#pragma unroll
  for (int i = 0; i < kMmaStages - 1; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }
  cp_async_wait<kMmaStages - 2>();
  __syncthreads();
  dequant(0);
  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait<kMmaStages - 3>();
    // step it+1 landed and step it's bf16 tile is whole; step it-1's mma
    // is done with its stage and its bf16 tile
    __syncthreads();
    if (it + kMmaStages - 1 < n_mine) fetch(it + kMmaStages - 1);
    cp_async_commit();
    if (it + 1 < n_mine) dequant(it + 1);

    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + (it % kMmaStages) * kStage + kMmaBK * kMmaBN + 4 * kMmaBN);
    const __nv_bfloat16* wb = wbs + (it & 1) * kMmaBK * kWS;
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t a[S::MT][4];
#pragma unroll
      for (int i = 0; i < S::MT; ++i)
        ldmatrix_x4(a[i], xs + (wm * (BM / S::WM) + i * 16 + lr) * kXS + kk * 16 + lc);
#pragma unroll
      for (int j = 0; j < S::NT; j += 2) {
        uint32_t bfr[4];
        ldmatrix_x4_trans(bfr, wb + (kk * 16 + lr) * kWS + wn * (kMmaBN / S::WN) + j * 8 + lc);
#pragma unroll
        for (int i = 0; i < S::MT; ++i) {
          mma_bf16(acc[i][j], a[i], bfr[0], bfr[1]);
          mma_bf16(acc[i][j + 1], a[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = part + (size_t)blockIdx.z * t * d;
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int i = 0; i < S::MT; ++i) {
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
      const int col = col0 + wn * (kMmaBN / S::WN) + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * (BM / S::WM) + i * 16 + gid + h * 8;
        if (row >= t) continue;
        float* o = dst + (size_t)row * d;
        if (col < d) o[col] = acc[i][j][2 * h];
        if (col + 1 < d) o[col + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

template <int BM>
cudaError_t launch_mma(const __nv_bfloat16* x, const int8_t* qv, const __half* sc,
                       const int* idx, float* part, int t, int n, int np, int d,
                       int n_planes, int splits, int steps_per, int w_al, int s_al,
                       cudaStream_t stream) {
  auto kern = q8_matmul_mma_kernel<BM>;
  // the dynamic shared-memory opt-in, once per instantiation and device
  static unsigned done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(done >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < 32) done |= 1u << dev;
  }
  const dim3 grid((t + BM - 1) / BM, (d + kMmaBN - 1) / kMmaBN, splits);
  kern<<<grid, MmaShape<BM>::Threads, mma_smem_bytes<BM>(), stream>>>(
      x, qv, sc, idx, part, t, n, np, d, n_planes, steps_per, w_al, s_al);
  return cudaGetLastError();
}

}  // namespace

// The decode body (t < T_MMA; a call of more rows launches once a group of
// 8): x (t, n) bf16, t <= 8; qvals (n_planes, np, d) int8 (any leading
// dims, flattened); scales (n_planes, np/32, d) f16; idx one int32 in
// device memory, the plane to read (clamped to 0..n_planes-1); out (t, d)
// f32; the reduction over n cut into `splits` ranges of `kb_per`
// quantization blocks (ops/q40.py gemv_plan); with splits > 1, part
// (splits, ceil(d / 64), t, 64) f32 and count (ceil(d / 64)) int32, zero
// and left zero, the workspace where the splits of a column tile meet; vw
// the bytes of a value piece (8, 4 or 1, dividing d and the pointers).
// One launch.  Returns cudaGetLastError() after it (0 = success).
extern "C" int q8_matmul(const void* x, const void* qvals, const void* scales, void* out,
                         const void* idx, void* part, void* count, int t, int n, int np, int d,
                         int n_planes, int splits, int kb_per, int vw, void* stream) {
  return launch_gemv<Q8>(x, qvals, scales, out, idx, part, count, t, n, np, d, n_planes,
                         splits, kb_per, vw, RowMajor{d}, stream);
}

// The tensor-core body: x (t, n) bf16 (16-byte aligned); qvals, scales, idx
// and out as q8_matmul; bm in 16, 32, 64, 128; the reduction over n cut
// into `splits` ranges of `steps_per` 64-row steps (ops/q8.py mma_plan),
// scratch (splits, t, d) f32 when splits > 1; w_al / s_al the widest copy
// (16, 8, 4, or 0 for plain byte loads) that the value / scale rows allow.
extern "C" int q8_matmul_mma(const void* x, const void* qvals, const void* scales, void* out,
                             void* scratch, const void* idx, int t, int n, int np, int d,
                             int n_planes, int bm, int splits, int steps_per, int w_al,
                             int s_al, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* qv = static_cast<const int8_t*>(qvals);
  const __half* sc = static_cast<const __half*>(scales);
  const int* ip = static_cast<const int*>(idx);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bm) {
    case 16:
      e = launch_mma<16>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, s);
      break;
    case 32:
      e = launch_mma<32>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, s);
      break;
    case 64:
      e = launch_mma<64>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, s);
      break;
    case 128:
      e = launch_mma<128>(xb, qv, sc, ip, part, t, n, np, d, n_planes, splits, steps_per,
                          w_al, s_al, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    q8_reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}
