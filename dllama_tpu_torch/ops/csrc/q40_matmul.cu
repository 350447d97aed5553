// Q40 dequant-matmul for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces: the Pallas kernels of dllama_tpu/ops/q40.py — _q40_kernel
// (entered through _pallas_matmul, the 2-D wcls head), _stacked_q40_kernel
// (entered through _pallas_matmul_stacked, the layer-stacked
// wqkv/wo/w13/w2) and, through the q40_matmul_blocked entry (kernel 3),
// _stacked_q40_kernel over tile-contiguous planes (entered through
// _pallas_matmul_blocked, DLLAMA_Q40_LAYOUT=blocked).  Kernels 1-2 compute
// the JAX kernel's four dequant variants (DLLAMA_Q40_VARIANT; the `variant`
// int of the entry points, ops/q40.py VARIANTS), x rounded to bf16, v the
// nibble, s the block's f16 scale, bs_b the f32 sum of x over block b:
//
//   classic  y (t, d) f32 = bf16(x) (t, n) @ W,   W[k, j] = bf16(f32(v(k, j) - 8) * f32(s[k/32, j]))
//   fma      W = bf16(v * s + (-8 * s)): equal in value to classic's (both
//            products are exact in f32; only a zero's sign differs, which
//            no f32 sum sees: tests/test_torch_q40_variants.py
//            test_fma_equals_classic_for_every_nibble_and_finite_scale
//            checks every nibble against every finite f16 scale), so it
//            runs classic's arithmetic, counted under its own name
//   folded   y = x @ bf16(bf16(v) * bf16(s)) - 8 * sum_b bf16(bs_b) * bf16(s_b)
//   exact    y = sum_b (p_b - 8 * bs_b) * s_b,   p_b = x . v over block b
//            (the raw nibbles, exact in bf16: no weight rounds to bf16)
//
// Kernel 3 (blocked planes) computes classic only, as the JAX package's
// _pallas_matmul_blocked does.
//
// Stacked planes (layers, or layer x expert of an MoE stack) are one
// buffer; the plane to read is an int32 in device memory, read by every
// block (the counterpart of the TPU kernel's scalar-prefetched index), so
// an expert chosen by a top-k on the device needs no host read.
//
// Storage (block-local, byte-identical to the JAX package): packed row
// 16b + r of the (np/2, d) uint8 plane holds logical row 32b + r in its low
// nibble and 32b + 16 + r in its high nibble, biased +8; scales are f16
// (np/32, d).  Rows past n (pack padding) have zero scales and are never
// read: the reduction stops at n, so x is never read past n either.
//
// Blocked storage (kernel 3, byte-identical to the JAX package's
// BlockedQTensor): the same planes cut into (bn, td) tiles, each one
// contiguous run, (n2/bn, dp/td, bn, td) a plane with dp = d padded to a
// td multiple (zero scales in the pad columns); the scales the same cut of
// the f16 plane, (n2/bn, dp/td, bn/16, td).  Packed row r, column c lives
// at ((r/bn)*nJ + c/td)*bn*td + (r%bn)*td + c%td.  A quantization block's
// 16 packed rows never straddle a tile (bn % 16 == 0) and a load never
// crosses a column tile (its width divides td, a multiple of 4), so the
// two layouts differ only in where a block's rows start and in their
// stride (d or td): each body is one template over a Layout
// (csrc/gemv_common.cuh), and with the same plan both layouts add the same
// products in the same order, bit for bit.  On the TPU the tiles
// lengthened the HBM DMA bursts; here a warp already reads 128 contiguous
// bytes a row in the row-major layout, so kernel 3 is expected to time
// like kernels 1-2.
//
// What bounds it on this card: at decode (t = 1) each weight is read once
// and used once, so the kernel is bound by the bytes of the packed planes,
// 0.5625 B/weight (0.5 nibble + 0.0625 scale), against 3.35 TB/s of HBM on
// an H100 SXM: 3.74 GB per Llama-2-7B token, a floor of about 1.1 ms.
//
// Two bodies share the storage and the entry points' operands: for calls
// of t < T_MMA rows (decode) the decode body of csrc/gemv_common.cuh, one
// template with the Q80 kernel's (the Q4 codec here), one launch a call;
// the tensor-core body below for t >= T_MMA (prefill chunks, mixed steps,
// lockstep batches; ops/q40.py route).  In both, folded and exact cost
// fewer instructions a weight than classic (a byte permute, a LOP3 and one
// bf16x2 FMA for two weights, against a LOP3 and an FMA a weight and a
// bf16x2 convert) plus a per-block fold of the block sums into the
// accumulators; the block sums are taken once a call (decode body) or once
// a step (tensor-core body) from the staged x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "mma_common.cuh"

namespace {

// out[i] = part[0][i] + part[1][i] + ... in split order: deterministic
// (the tensor-core body's split-K).
__global__ void q40_reduce_splits(const float* __restrict__ part,
                                  float* __restrict__ out, int splits,
                                  size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
  out[i] = s;
}

// ---------------------------------------------------------------------------
// The tensor-core body, for t >= T_MMA rows (python: ops/q40.py T_MMA,
// route), in both layouts: the Q80 kernel's tensor-core body (q8_matmul.cu
// q8_matmul_mma_kernel, its machinery in mma_common.cuh) with a Q40 weight
// tile.  The decode body dequantizes every weight once a group of up to 8
// rows of x; this body dequantizes it once per BM rows:
//  * A block owns a BM x 128 output tile (BM in 16, 32, 64, 128: the least
//    that covers t; ops/q40.py mma_plan, the Q80 body's plan) and walks its
//    share of n in steps of 64 logical rows: two quantization blocks, 32
//    packed rows.  Partial sums of the split-K go to f32 scratch (splits, t,
//    d) and add in a fixed order (q40_reduce_splits): results repeat bit for
//    bit.
//  * cp.async brings a step's packed tile (32 x 128 bytes), its two f16
//    scale rows and the bf16 x tile (BM x 64) into a ring of kQ4Stages
//    stages, zero-filling rows of x past t, a second block past n/32 (n/32
//    odd) and columns past the plane's stored width; copies of 16, 8 or 4
//    bytes, the widest every row start allows.  Each quantization block's 16
//    packed rows are addressed through the Layout (val, scale, stride), so
//    in the blocked layout a step's two blocks may lie in two row tiles and
//    a 128-column tile may span column tiles: a copy never crosses one, as
//    its width divides td.  The blocked pad columns d..dp carry zero scales
//    and are never written.
//  * The threads unpack step s+1's tile into one of two bf16 (k, d) tiles in
//    shared memory while the warps run mma.sync on step s's: a byte of packed
//    row 16b + r gives logical row 32b + r (low nibble) and 32b + 16 + r
//    (high nibble), each bf16(f32(nib - 8) * f32(s)) rounded to nearest even,
//    the GEMV body's numerics (nibbles widen four at a time with byte
//    permutes, the 2^23 trick).  Then ldmatrix (x), ldmatrix.trans (the
//    weight tile) and mma.sync m16n8k16 with f32 accumulation, as the Q80
//    body.  One barrier a step.
// Both layouts take the same plan on the logical d and add the same
// products in the same order, so kernel 3 equals kernels 1-2 bit for bit
// under this body too; products of bf16 values are exact in f32, so the
// result differs from the GEMV body's only in the order of the f32 sums.

constexpr int kQ4Stages = 4;                  // ring stages
constexpr int kQ4Tile = kMmaBK / 2 * kMmaBN;  // packed bytes a step: 32 rows x 128 columns
constexpr int kQ4Scales = 2 * kMmaBN * 2;     // two f16 scale rows

template <int BM>
__host__ __device__ constexpr int q4_stage_bytes() {
  return kQ4Tile + kQ4Scales + BM * kXS * 2;  // packed tile, scales, x tile
}

template <int BM>
__host__ __device__ constexpr int q4_smem_bytes() {
  return kQ4Stages * q4_stage_bytes<BM>() + 2 * kMmaBK * kWS * 2;  // + two bf16 tiles
}

// Packed rows r0, r0 + rs, ... < 32 of a step's tile at byte column c, in
// copies of N bytes (N = 1: plain byte loads, for a row-major plane of
// d % 4 != 0) from qp + v0|v1 (the step's two blocks) + vc (the column) +
// the row within the block; rows of a block at or past n_blk, and a column
// that is not `live`, are zero.
template <int N>
__device__ __forceinline__ void stage_packed(unsigned char* dst, const uint8_t* qp, size_t v0,
                                             size_t v1, size_t vc, int stride, int r0, int rs,
                                             int c, bool live, int n_blk) {
  for (int r = r0; r < 32; r += rs) {
    const bool ok = live && (r >> 4) < n_blk;
    const uint8_t* src = ok ? qp + ((r >> 4) ? v1 : v0) + vc + (size_t)(r & 15) * stride : qp;
    if constexpr (N >= 4)
      cp_async_zfill<N>(dst + r * kMmaBN + c, src, ok);
    else
      dst[r * kMmaBN + c] = ok ? *src : static_cast<unsigned char>(0);
  }
}

// One copy of N bytes of a scale row (N = 2: a plain load of one scale)
template <int N>
__device__ __forceinline__ void stage_scale(unsigned char* dst, const __half* src, bool ok) {
  if constexpr (N >= 4)
    cp_async_zfill<N>(dst, src, ok);
  else
    *reinterpret_cast<__half*>(dst) = ok ? *src : __ushort_as_half(static_cast<unsigned short>(0));
}

// nibble byte `k` of `v` (bytes 0..15) minus 8 as a float, exactly: the
// byte permute builds 2^23 + nib, the subtraction of 2^23 + 8 is exact
template <int K>
__device__ __forceinline__ float nib4_f32(uint32_t v) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650 + K)) - 8388616.0f;
}

// four weights bf16((nib_c - 8) * s_c) of nibble bytes `v` into p[0..3]
__device__ __forceinline__ void store_w4(__nv_bfloat16* p, uint32_t v, float s0, float s1,
                                         float s2, float s3) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(nib4_f32<0>(v) * s0, nib4_f32<1>(v) * s1);
  const __nv_bfloat162 b = __floats2bfloat162_rn(nib4_f32<2>(v) * s2, nib4_f32<3>(v) * s3);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&a);
  packed.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = packed;
}

// folded / exact: four weights of nibble bytes `v` into p[0..3], two a
// bf16x2 FMA: columns 0, 1 and 2, 3 as bf16x2 (128 + nib) (a byte permute
// and an OR), then n01 / n23 (NibScale: bf16(nib * sb), or the raw nib)
__device__ __forceinline__ void store_w4_nib(__nv_bfloat16* p, uint32_t v, const NibScale& n01,
                                             const NibScale& n23) {
  uint2 packed;
  packed.x = n01(__byte_perm(v, 0u, 0x4140) | 0x43004300u);
  packed.y = n23(__byte_perm(v, 0u, 0x4342) | 0x43004300u);
  *reinterpret_cast<uint2*>(p) = packed;
}

// a NibScale over two columns' scales (folded: bf16(s0), bf16(s1))
__device__ __forceinline__ NibScale nib_scale2(float sb0, float sb1) {
  const uint32_t b0 = bf16_bits(sb0), b1 = bf16_bits(sb1);
  const uint32_t m0 = bf16_bits(-128.f * sb0), m1 = bf16_bits(-128.f * sb1);
  return {b0 | b1 << 16, m0 | m1 << 16};
}

template <int BM, class Layout, int V>
__global__ void __launch_bounds__(MmaShape<BM>::Threads, MmaShape<BM>::MinBlocks)
q40_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n)
                      const uint8_t* __restrict__ qpacked,    // n_planes planes
                      const __half* __restrict__ scales,      // n_planes planes
                      const int* __restrict__ plane_p,        // the plane to read
                      float* __restrict__ part,               // (splits, t, d)
                      int t, int n, int np, int d, int n_planes, int steps_per, int w_al,
                      int s_al, Layout lay) {
  using S = MmaShape<BM>;
  constexpr bool kSums = V == kFolded || V == kExact;
  static_assert(V == kClassic || kSums, "fma runs the classic body");
  static_assert(BM * 4 <= S::Threads, "four threads a row take the block sums");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = q4_stage_bytes<BM>();
  // packed rows a thread unpacks a step: 4 (256 threads) or 2, in one block
  constexpr int kPk = kMmaBK / 2 * 32 / S::Threads;
  __nv_bfloat16* wbs = reinterpret_cast<__nv_bfloat16*>(smem + kQ4Stages * kStage);
  // folded, exact: a step's block sums of x, (row, block), two buffers as
  // the bf16 tiles (folded: rounded to bf16)
  __shared__ float bsm[2][kSums ? BM * 2 : 1];

  const size_t plane = (size_t)min(max(*plane_p, 0), n_planes - 1);
  const uint8_t* qp = qpacked + plane * (size_t)(np / 2) * (size_t)lay.cols();
  const __half* sc = scales + plane * (size_t)(np / 32) * (size_t)lay.cols();
  const int m0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kMmaBN;
  const int n_steps = (n + kMmaBK - 1) / kMmaBK;
  const int s_begin = blockIdx.z * steps_per;
  const int n_mine = min(n_steps, s_begin + steps_per) - s_begin;
  const int vc = min(kMmaBN, lay.cols() - col0);  // stored columns of the tile
  const int nb = n / 32;

  // the copies this thread issues every step, fixed for the block: packed
  // rows wr0, wr0 + wrs, ... < 32 of the tile at byte column wc in copies of
  // wcp bytes, and, when sr < 2, scale row sr at column scn in copies of scp
  // bytes.  The widths (w_al, s_al: 16, 8, 4, or 0 for plain loads) divide
  // every row start and, blocked, td and 2 td: no copy crosses a column
  // tile.  Columns at or past vc are zero.
  const int wcp = w_al ? w_al : 1, wper = kMmaBN / wcp;
  const int wc = threadIdx.x % wper * wcp;
  const int wr0 = threadIdx.x / wper, wrs = S::Threads / wper;
  const bool wlive = wc + wcp <= vc;
  const size_t wcol = lay.vcol(col0 + wc);
  const int scp = s_al ? s_al : 2, sper = 2 * kMmaBN / scp;
  const int scn = threadIdx.x % sper * (scp / 2);
  const int sr = threadIdx.x / sper;
  const bool slive = scn + scp / 2 <= vc;
  const size_t scol = lay.scol(col0 + scn);
  // fetch runs for steps 0, 1, 2, ... in order: the cursor follows it
  auto cur = lay.cursor((unsigned)s_begin * 2);

  auto fetch = [&](int i) {
    unsigned char* st = smem + (i % kQ4Stages) * kStage;
    const int k0 = (s_begin + i) * kMmaBK;
    const int n_blk = nb - k0 / 32;  // blocks of the step inside n: 1 or more
    size_t vrow[2], srow[2];
    lay.step_rows(cur, vrow, srow);
    const int stride = lay.stride();
    switch (wcp) {
      case 16:
        stage_packed<16>(st, qp, vrow[0], vrow[1], wcol, stride, wr0, wrs, wc, wlive, n_blk);
        break;
      case 8:
        stage_packed<8>(st, qp, vrow[0], vrow[1], wcol, stride, wr0, wrs, wc, wlive, n_blk);
        break;
      case 4:
        stage_packed<4>(st, qp, vrow[0], vrow[1], wcol, stride, wr0, wrs, wc, wlive, n_blk);
        break;
      default:
        stage_packed<1>(st, qp, vrow[0], vrow[1], wcol, stride, wr0, wrs, wc, wlive, n_blk);
    }
    if (sr < 2) {
      const bool ok = slive && sr < n_blk;
      const __half* src = ok ? sc + (sr ? srow[1] : srow[0]) + scol : sc;
      unsigned char* sdst = st + kQ4Tile + sr * 2 * kMmaBN + scn * 2;
      switch (scp) {
        case 16: stage_scale<16>(sdst, src, ok); break;
        case 8: stage_scale<8>(sdst, src, ok); break;
        case 4: stage_scale<4>(sdst, src, ok); break;
        default: stage_scale<2>(sdst, src, ok);
      }
    }
    stage_rows(st + kQ4Tile + kQ4Scales, kXS * 2,
               reinterpret_cast<const unsigned char*>(x + (size_t)m0 * n + k0), 2L * n, BM,
               2 * kMmaBK, t - m0, 2 * min(kMmaBK, n - k0), 16);
  };

  // unpacking: thread owns columns 4*cg..4*cg+3 of packed rows kPk*rg ..
  // kPk*rg + kPk - 1, all in quantization block blk of the step
  const int cg = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kPk;
  const int blk = r0 >> 4;
  auto dequant = [&](int i) {
    const unsigned char* st = smem + (i % kQ4Stages) * kStage;
    __nv_bfloat16* wb = wbs + (i & 1) * kMmaBK * kWS;
    const uint2 sraw =
        *reinterpret_cast<const uint2*>(st + kQ4Tile + blk * 2 * kMmaBN + cg * 8);
    const float s0 = f16_bits(sraw.x & 0xFFFFu), s1 = f16_bits(sraw.x >> 16);
    const float s2 = f16_bits(sraw.y & 0xFFFFu), s3 = f16_bits(sraw.y >> 16);
    NibScale n01 = NibScale::raw(), n23 = NibScale::raw();  // exact: the raw nibbles
    if constexpr (V == kFolded) {
      n01 = nib_scale2(bf16_round(s0), bf16_round(s1));
      n23 = nib_scale2(bf16_round(s2), bf16_round(s3));
    }
#pragma unroll
    for (int r = 0; r < kPk; ++r) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(st + (r0 + r) * kMmaBN + cg * 4);
      const int lo = 32 * blk + ((r0 + r) & 15);  // logical row of the low nibbles
      if constexpr (kSums) {
        store_w4_nib(wb + lo * kWS + cg * 4, u & 0x0F0F0F0Fu, n01, n23);
        store_w4_nib(wb + (lo + 16) * kWS + cg * 4, (u >> 4) & 0x0F0F0F0Fu, n01, n23);
      } else {
        store_w4(wb + lo * kWS + cg * 4, u & 0x0F0F0F0Fu, s0, s1, s2, s3);
        store_w4(wb + (lo + 16) * kWS + cg * 4, (u >> 4) & 0x0F0F0F0Fu, s0, s1, s2, s3);
      }
    }
    if constexpr (kSums) {
      // the step's block sums from its staged x tile: thread 4 row + 2 b + h
      // sums half h (16 columns) of block b of the row, its neighbour the
      // other half; lo half + hi half, as the JAX kernel adds them
      if (threadIdx.x < BM * 4) {
        const int row = threadIdx.x >> 2, b = (threadIdx.x >> 1) & 1, h = threadIdx.x & 1;
        const uint4* xp = reinterpret_cast<const uint4*>(
            st + kQ4Tile + kQ4Scales + (row * kXS + 32 * b + 16 * h) * 2);
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 v = xp[q];
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum = sum + __uint_as_float(w[e] << 16) + __uint_as_float(w[e] & 0xFFFF0000u);
        }
        const float hi = __shfl_xor_sync(0xFFFFFFFFu, sum, 1);  // h = 0: the hi half's
        if (h == 0) bsm[i & 1][row * 2 + b] = V == kFolded ? bf16_round(sum + hi) : sum + hi;
      }
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
  for (int i = 0; i < kQ4Stages - 1; ++i) {
    if (i < n_mine) fetch(i);
    cp_async_commit();
  }
  cp_async_wait<kQ4Stages - 2>();
  __syncthreads();
  dequant(0);
  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait<kQ4Stages - 3>();
    // step it+1 landed and step it's bf16 tile is whole; step it-1's mma
    // is done with its stage and its bf16 tile
    __syncthreads();
    if (it + kQ4Stages - 1 < n_mine) fetch(it + kQ4Stages - 1);
    cp_async_commit();
    if (it + 1 < n_mine) dequant(it + 1);

    const unsigned char* st = smem + (it % kQ4Stages) * kStage;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + kQ4Tile + kQ4Scales);
    const __nv_bfloat16* wb = wbs + (it & 1) * kMmaBK * kWS;
    // the step's two quantization blocks, two k16 steps each: classic and
    // folded into acc; exact into a fresh fragment p, folded into acc as
    // (p - 8 bs) * s after its block (folded adds -8 bf16(bs) bf16(s) then)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float p[V == kExact ? S::MT : 1][V == kExact ? S::NT : 1][4];
      if constexpr (V == kExact) {
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
#pragma unroll
          for (int j = 0; j < S::NT; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) p[i][j][k] = 0.f;
      }
#pragma unroll
      for (int kk = 2 * b; kk < 2 * b + 2; ++kk) {
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
            if constexpr (V == kExact) {
              mma_bf16(p[i][j], a[i], bfr[0], bfr[1]);
              mma_bf16(p[i][j + 1], a[i], bfr[2], bfr[3]);
            } else {
              mma_bf16(acc[i][j], a[i], bfr[0], bfr[1]);
              mma_bf16(acc[i][j + 1], a[i], bfr[2], bfr[3]);
            }
          }
        }
      }
      if constexpr (kSums) {
        // C fragment: rows gid, gid + 8 of the m16 tile, columns 2 tig, +1
        // of the n8 tile; block b's scales from the step's stage, read once
        // a column pair, its block sums once a row
        float sc[S::NT][2];
#pragma unroll
        for (int j = 0; j < S::NT; ++j) {
          const int col = wn * (kMmaBN / S::WN) + j * 8 + (lane & 3) * 2;
          const uint32_t sr = *reinterpret_cast<const uint32_t*>(
              st + kQ4Tile + b * 2 * kMmaBN + col * 2);
          sc[j][0] = f16_bits(sr & 0xFFFFu);
          sc[j][1] = f16_bits(sr >> 16);
          if constexpr (V == kFolded) sc[j][0] = bf16_round(sc[j][0]), sc[j][1] = bf16_round(sc[j][1]);
        }
#pragma unroll
        for (int i = 0; i < S::MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * (BM / S::WM) + i * 16 + (lane >> 2) + h * 8;
            const float r = -8.f * bsm[it & 1][row * 2 + b];
#pragma unroll
            for (int j = 0; j < S::NT; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                float& o = acc[i][j][2 * h + c];
                if constexpr (V == kExact)
                  o = fmaf(p[i][j][2 * h + c] + r, sc[j][c], o);
                else
                  o = fmaf(r, sc[j][c], o);
              }
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

template <int BM, class Layout, int V>
cudaError_t launch_mma(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
                       const int* idx, float* part, int t, int n, int np, int d,
                       int n_planes, int splits, int steps_per, int w_al, int s_al, Layout lay,
                       cudaStream_t stream) {
  auto kern = q40_matmul_mma_kernel<BM, Layout, V>;
  // the dynamic shared-memory opt-in, once per instantiation and device
  static unsigned done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(done >> dev & 1u)) {
    // the body's own need: static shared memory (folded and exact's block
    // sums) and the dynamic opt-in together stay under the block's limit
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q4_smem_bytes<BM>());
    if (e != cudaSuccess) return e;
    if (dev < 32) done |= 1u << dev;
  }
  const dim3 grid((t + BM - 1) / BM, (d + kMmaBN - 1) / kMmaBN, splits);
  kern<<<grid, MmaShape<BM>::Threads, q4_smem_bytes<BM>(), stream>>>(
      x, qp, sc, idx, part, t, n, np, d, n_planes, steps_per, w_al, s_al, lay);
  return cudaGetLastError();
}

// Both tensor-core entry points: the tile height by bm, then the
// fixed-order reduce of the splits.
template <class Layout, int V>
int run_mma(const void* x, const void* qpacked, const void* scales, void* out, void* scratch,
            const void* idx, int t, int n, int np, int d, int n_planes, int bm, int splits,
            int steps_per, int w_al, int s_al, Layout lay, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(qpacked);
  const __half* sc = static_cast<const __half*>(scales);
  const int* ip = static_cast<const int*>(idx);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bm) {
    case 16:
      e = launch_mma<16, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 32:
      e = launch_mma<32, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 64:
      e = launch_mma<64, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 128:
      e = launch_mma<128, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                          s_al, lay, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    q40_reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The decode body (t < T_MMA; a call of more rows launches once a group of
// 8): x (t, n) bf16, t <= 8; qpacked (n_planes, np/2, d) u8 (any leading
// dims, flattened); scales (n_planes, np/32, d) f16; idx one int32 in
// device memory, the plane to read (clamped to 0..n_planes-1); out (t, d)
// f32; the reduction over n cut into `splits` ranges of `kb_per`
// quantization blocks (ops/q40.py gemv_plan); with splits > 1, part
// (splits, ceil(d / 128), t, 128) f32 and count (ceil(d / 128)) int32, zero
// and left zero, the workspace where the splits of a column tile meet; vw
// the bytes of a value piece (16, 8, 4 or 1, dividing d and the pointers);
// variant the dequant variant (Variant: 0 classic, 1 fma, 2 folded, 3
// exact).  One launch.  Returns cudaGetLastError() after it (0 = success).
extern "C" int q40_matmul(const void* x, const void* qpacked, const void* scales, void* out,
                          const void* idx, void* part, void* count, int t, int n, int np, int d,
                          int n_planes, int splits, int kb_per, int vw, int variant,
                          void* stream) {
  switch (variant) {
    case kClassic:
    case kFma:
      return launch_gemv<Q4>(x, qpacked, scales, out, idx, part, count, t, n, np, d, n_planes,
                             splits, kb_per, vw, RowMajor{d}, stream);
    case kFolded:
      return launch_gemv<Q4V<kFolded>>(x, qpacked, scales, out, idx, part, count, t, n, np, d,
                                       n_planes, splits, kb_per, vw, RowMajor{d}, stream);
    case kExact:
      return launch_gemv<Q4V<kExact>>(x, qpacked, scales, out, idx, part, count, t, n, np, d,
                                      n_planes, splits, kb_per, vw, RowMajor{d}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel 3: the same product over blocked planes, qpacked (n_planes, np/2/bn,
// nJ, bn, td) u8 and scales (n_planes, np/2/bn, nJ, bn/16, td) f16, with
// bn % 16 == 0 and td % 4 == 0 (vw divides td); writes the (t, d) logical
// columns only.
extern "C" int q40_matmul_blocked(const void* x, const void* qpacked, const void* scales,
                                  void* out, const void* idx, void* part, void* count, int t,
                                  int n, int np, int d, int n_planes, int splits, int kb_per,
                                  int vw, int bn, int td, int nJ, void* stream) {
  return launch_gemv<Q4>(x, qpacked, scales, out, idx, part, count, t, n, np, d, n_planes,
                         splits, kb_per, vw, Blocked{bn, td, nJ}, stream);
}

// The tensor-core body (t >= T_MMA) of kernels 1-2: x (t, n) bf16 (16-byte
// aligned); qpacked, scales, idx and out as q40_matmul; bm in 16, 32, 64,
// 128; the reduction over n cut into `splits` ranges of `steps_per` 64-row
// steps (ops/q40.py mma_plan), scratch (splits, t, d) f32 when splits > 1;
// w_al / s_al the widest copy (16, 8, 4, or 0 for plain loads) that the
// value / scale rows allow; variant as q40_matmul's.
extern "C" int q40_matmul_mma(const void* x, const void* qpacked, const void* scales,
                              void* out, void* scratch, const void* idx, int t, int n,
                              int np, int d, int n_planes, int bm, int splits, int steps_per,
                              int w_al, int s_al, int variant, void* stream) {
  switch (variant) {
    case kClassic:
    case kFma:
      return run_mma<RowMajor, kClassic>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                         n_planes, bm, splits, steps_per, w_al, s_al,
                                         RowMajor{d}, stream);
    case kFolded:
      return run_mma<RowMajor, kFolded>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                        n_planes, bm, splits, steps_per, w_al, s_al,
                                        RowMajor{d}, stream);
    case kExact:
      return run_mma<RowMajor, kExact>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                       n_planes, bm, splits, steps_per, w_al, s_al,
                                       RowMajor{d}, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core body of kernel 3: operands as q40_matmul_blocked, the
// plan as q40_matmul_mma's on the logical d; w_al / s_al copy widths that
// divide td / 2*td (never 0: td % 4 == 0).
extern "C" int q40_matmul_blocked_mma(const void* x, const void* qpacked, const void* scales,
                                      void* out, void* scratch, const void* idx, int t, int n,
                                      int np, int d, int n_planes, int bm, int splits,
                                      int steps_per, int w_al, int s_al, int bn, int td,
                                      int nJ, void* stream) {
  return run_mma<Blocked, kClassic>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                    n_planes, bm, splits, steps_per, w_al, s_al,
                                    Blocked{bn, td, nJ}, stream);
}

extern "C" const char* q40_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
