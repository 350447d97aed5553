// The tensor-core body of the Q40 and Q80 dequant-matmul kernels
// (q40_matmul.cu: kernels 1-3, both layouts, every dequant variant;
// q8_matmul.cu: kernels 5-6), for calls of t >= T_MMA rows (python:
// ops/q40.py and ops/q8.py T_MMA, route, mma_plan): one template over a
// codec policy (gemv_common.cuh's Q4V<V> or Q8, with their tensor-core
// parts in Wg<Codec> below) and a layout (row-major, or kernel 3's
// tile-contiguous planes), on sm90_common.cuh's Hopper machinery.
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,  W[k, j] = bf16(f32(w(k, j)) * f32(s[k/32, j]))
//
// (w = nib - 8 for Q40, the int8 value for Q80; Q40's folded and exact
// variants as q40_matmul.cu's top says).  It dequantizes a weight once per
// BM rows of x (the decode body once per 8), so at the main path's widths
// (prefill chunks, the 8-slot mixed step's 128 rows, the scoring forward's
// 4096) it is bound by the tensor cores' operations, not by the bytes of
// the planes.  The design:
//  * A block owns 128 output columns by BM rows of x (BM 32 or 128, and
//    16 for Q80: mma_plan) and walks its share of n in steps of 64 logical
//    rows (two quantization blocks: 32 packed Q40 rows, 64 Q80 rows).
//    Partial sums of the split-K go to f32 scratch (splits, t, d) and add
//    in a fixed order (reduce_splits): results repeat bit for bit.
//  * The product is computed transposed, y^T = W^T x^T: the dequantized
//    weights are wgmma's A operand, straight from registers (wgmma RS,
//    m64nBMk16), and x the B operand, K-major from shared memory.  So no
//    bf16 weight tile is written to or read from shared memory: a step's
//    shared-memory traffic is its copies and x's reads (an SS-mode body
//    that staged a swizzled bf16 weight tile was shared-memory bound).
//  * 288 threads: two consumer warpgroups, 64 output columns each, and a
//    producer warp.  Nine warps put three on one sub-partition, so a thread
//    holds at most 168 registers (setmaxnreg does not lift what ptxas
//    allocates; a 256-row tile, 128 accumulators a thread, had its wgmma
//    serialized for want of registers and was dropped).  The producer keeps
//    a ring of kStages stages full, with full and empty mbarriers: a stage
//    holds the BM x 64 bf16 x tile (one TMA box of a map over (t, n),
//    128-byte swizzled; rows past t and columns past n read as zeros), the
//    step's stored value rows x 128 bytes (one TMA box of a quantization
//    block's kRowsPerBlock rows, 128-byte swizzled so that the consumers'
//    reads of one column pair from four rows meet no bank conflict) and
//    its two 128-wide f16 scale rows, from maps over the planes seen as
//    rows of their stored stride (d, or kernel 3's td; the plane index is
//    read on the card).  Where TMA cannot take the weights (a row stride
//    or a pointer off 16 bytes, a blocked td that 128 does not divide) the
//    producer warp copies them with cp.async (or plain loads) addressed
//    through the Layout cursor, into the same swizzled places, and the
//    stage barrier tracks the copies.
//  * A consumer thread (lane g·4 + q of warp w of warpgroup wg) owns output
//    columns c, c + 1 (c = 64 wg + 16 w + 2 g): the A fragment's rows g and
//    g + 8.  Its A registers of a k16 slice hold logical rows 2q, 2q + 1,
//    2q + 8, 2q + 9 of the slice: two bytes a row (its two columns), one
//    16-bit load (Wg<Codec>::frags: Q40's two k16 slices of a block are the
//    low and the high nibbles of the same 16 packed rows; Q80's are its
//    rows 0-15 and 16-31).  Each weight is bf16(f32(w) * f32(s)) rounded
//    to nearest even from one FFMA (the decode body's exact trick), the
//    decode body's numerics; blocks past n are zero.  The warpgroup
//    unpacks step s+1's registers (a second buffer) after issuing step s's
//    wgmma (commit, then wait_group 1): no barrier between the warpgroups.
//    Measured on an H100, the unpacking does not overlap the products in
//    flight: a step costs their sum (PERF.md).
//  * Q40's folded adds -8 bf16(bs) bf16(s) a block into a second register
//    set (wgmma owns the accumulators while a product is in flight), added
//    at the end; exact keeps a second set p for each block's products
//    (scale-d 0 at the block's first k16), waits for them and folds (p - 8
//    bs) s into the accumulators; both take the block sums bs of x from
//    shared memory, summed once a step by all consumer threads (then one
//    named barrier a step).
// Both layouts take the same plan on the logical d and add the same
// products in the same order, so kernel 3 equals kernels 1-2 bit for bit;
// products of bf16 values are exact in f32, so the result differs from the
// decode body's only in the order of the f32 sums.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "gemv_common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

// out[i] = part[0][i] + part[1][i] + ... in split order: deterministic
// (the split-K).  Templated on the codec family so that a profile names
// whose it is.
template <class Codec>
__global__ void reduce_splits(const float* __restrict__ part, float* __restrict__ out,
                              int splits, size_t total) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * total + i];
  out[i] = s;
}

constexpr int kWgBN = 128;                     // output columns a block: ops/q40.py MMA_BN
constexpr int kWgBK = 64;                      // rows of n a step: ops/q40.py MMA_BK
constexpr int kWgConsumers = 256;              // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp
constexpr int kWgScales = 2 * kWgBN * 2;       // two f16 scale rows

// Byte of stored row r, column c in a step's swizzled value tile (TMA's
// 128-byte swizzle: the 16-byte chunk XORed with the row's low three bits;
// a block's rows start on 1024)
__device__ __forceinline__ int vsw(int r, int c) {
  return r * kWgBN + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The codec's tensor-core parts: Family (its classic policy, which names
// the split reduce in a profile), kBlockSums (the block keeps buffers for
// the variants' block sums of x), kMinBM (its least tile height: the
// 16-row tile measured faster than the 32-row one for Q80 only), and
// frags, a consumer's A registers of a step (a[kk], kk the k16 slice) from
// its stage's value tile and scale rows, `live` the step's blocks that
// hold weights (the rest are zero).
template <class Codec>
struct Wg;

// Q40: the A registers of a block's two k16 slices: `v` the raw bytes of
// packed rows 2q and 2q+1 (bytes 0, 1: columns c, c+1 of row 2q; bytes 2,
// 3: of row 2q+1), `w` those of rows 2q+8, 2q+9; s0, s1 the two columns'
// scales.  A register holds (k, k+1) of one column: reg 0 column c at k =
// 2q, 2q+1; reg 1 column c+1 there; regs 2, 3 the same at k = 2q+8, 2q+9;
// lo the slice of the low nibbles (the block's first 16 rows), hi the high.
// classic: each weight is one LOP3 and one FFMA before its bf16 round (the
// decode body's exact trick, gemv_common.cuh field_f32: the nibble ORed
// at mantissa bit p into the exponent of 2^(23-p) is 2^(23-p) + nib, and
// fma(2^(23-p) + nib, s, -(2^(23-p) + 8) s) = (nib - 8) s exactly for p in
// 8, 12, 16); folded, exact: two weights a bf16x2 FMA (NibScale).
template <int V>
__device__ __forceinline__ void q4_frags(uint32_t (&lo)[4], uint32_t (&hi)[4], uint32_t v,
                                         uint32_t w, float s0, float s1) {
  if constexpr (V == kClassic) {
    // (word, mask, exponent) of each nibble: byte 0 of `u` from u << 8,
    // byte 1 from u, byte 2 from u >> 8, byte 3 from u >> 12
    const float c0[3] = {-32776.f * s0, -2056.f * s0, -136.f * s0};
    const float c1[3] = {-32776.f * s1, -2056.f * s1, -136.f * s1};
    auto pair = [&](uint32_t u, uint32_t (&l)[4], uint32_t (&h)[4], int e) {
      const uint32_t u8 = u << 8, d8 = u >> 8, d12 = u >> 12;
      // column c: bytes 0 (row k) and 2 (row k + 1); column c+1: bytes 1, 3
      l[e] = bf16x2_bits(fmaf(field_f32<0xF00u, 0x47000000u>(u8), s0, c0[0]),
                         fmaf(field_f32<0xF00u, 0x47000000u>(d8), s0, c0[0]));
      h[e] = bf16x2_bits(fmaf(field_f32<0xF000u, 0x45000000u>(u8), s0, c0[1]),
                         fmaf(field_f32<0xF000u, 0x45000000u>(d8), s0, c0[1]));
      l[e + 1] = bf16x2_bits(fmaf(field_f32<0xF00u, 0x47000000u>(u), s1, c1[0]),
                             fmaf(field_f32<0xF000u, 0x45000000u>(d12), s1, c1[1]));
      h[e + 1] = bf16x2_bits(fmaf(field_f32<0xF000u, 0x45000000u>(u), s1, c1[1]),
                             fmaf(field_f32<0xF0000u, 0x43000000u>(d12), s1, c1[2]));
    };
    pair(v, lo, hi, 0);
    pair(w, lo, hi, 2);
  } else {
    NibScale n0 = NibScale::raw(), n1 = NibScale::raw();  // exact: the raw nibbles
    if constexpr (V == kFolded) {
      n0 = NibScale::of(bf16_round(s0));
      n1 = NibScale::of(bf16_round(s1));
    }
    // bf16x2 (128 + nib) of bytes 0, 2 (column c) or 1, 3 (column c+1)
    const uint32_t vl = v & 0x0F0F0F0Fu, vh = (v >> 4) & 0x0F0F0F0Fu;
    const uint32_t wl = w & 0x0F0F0F0Fu, wh = (w >> 4) & 0x0F0F0F0Fu;
    lo[0] = n0(__byte_perm(vl, 0u, 0x4240) | 0x43004300u);
    lo[1] = n1(__byte_perm(vl, 0u, 0x4341) | 0x43004300u);
    lo[2] = n0(__byte_perm(wl, 0u, 0x4240) | 0x43004300u);
    lo[3] = n1(__byte_perm(wl, 0u, 0x4341) | 0x43004300u);
    hi[0] = n0(__byte_perm(vh, 0u, 0x4240) | 0x43004300u);
    hi[1] = n1(__byte_perm(vh, 0u, 0x4341) | 0x43004300u);
    hi[2] = n0(__byte_perm(wh, 0u, 0x4240) | 0x43004300u);
    hi[3] = n1(__byte_perm(wh, 0u, 0x4341) | 0x43004300u);
  }
}

// the 16-bit piece (columns c, c+1) of stored row r of a block's swizzled tile
__device__ __forceinline__ uint32_t wg_pair(const unsigned char* vb, int r, int c) {
  return *reinterpret_cast<const uint16_t*>(vb + vsw(r, c));
}

template <int V>
struct Wg<Q4V<V>> {
  using Family = Q4;
  static constexpr bool kBlockSums = true;  // one layout for every variant
  static constexpr int kMinBM = 32;
  __device__ static void frags(uint32_t (&a)[4][4], const unsigned char* vals,
                               const unsigned char* scs, int c, int q, int live) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b >= live) {  // a block past n holds no weights
#pragma unroll
        for (int e = 0; e < 4; ++e) a[2 * b][e] = a[2 * b + 1][e] = 0u;
        continue;
      }
      const unsigned char* vb = vals + b * 16 * kWgBN;
      const uint32_t v = wg_pair(vb, 2 * q, c) | wg_pair(vb, 2 * q + 1, c) << 16;
      const uint32_t w = wg_pair(vb, 2 * q + 8, c) | wg_pair(vb, 2 * q + 9, c) << 16;
      const uint32_t sr = *reinterpret_cast<const uint32_t*>(scs + b * 2 * kWgBN + c * 2);
      q4_frags<V>(a[2 * b], a[2 * b + 1], v, w, f16_bits(sr & 0xFFFFu), f16_bits(sr >> 16));
    }
  }
};

// Q80: the float 2^15 + 128 + v of int8 byte K of `u` (its bytes already
// XORed with 0x80, so byte K is v + 128): one byte permute puts it at
// mantissa bits 8..15 under 2^15's exponent (Q8::value's float, built with
// a PRMT in place of a shift and a LOP3)
template <int K>
__device__ __forceinline__ float q8_field(uint32_t u) {
  return __uint_as_float(__byte_perm(u, 0x47000000u, 0x7504 | (K << 4)));
}

template <>
struct Wg<Q8> {
  using Family = Q8;
  static constexpr bool kBlockSums = false;
  static constexpr int kMinBM = 16;
  // k16 slice 2b + h is rows 16h .. 16h + 15 of block b; the thread's rows
  // 16h + 2q, + 1, + 8, + 9 of it, two bytes (columns c, c+1) each.  A
  // weight is fma(2^15 + 128 + v, s, -(2^15 + 128) s) = v s exactly, then
  // two round to a bf16 pair (Q8::value's numerics).
  __device__ static void frags(uint32_t (&a)[4][4], const unsigned char* vals,
                               const unsigned char* scs, int c, int q, int live) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (b >= live) {  // a block past n holds no weights
#pragma unroll
        for (int e = 0; e < 4; ++e) a[2 * b][e] = a[2 * b + 1][e] = 0u;
        continue;
      }
      const uint32_t sr = *reinterpret_cast<const uint32_t*>(scs + b * 2 * kWgBN + c * 2);
      const float s0 = f16_bits(sr & 0xFFFFu), s1 = f16_bits(sr >> 16);
      const float m0 = -32896.f * s0, m1 = -32896.f * s1;
      const unsigned char* vb = vals + b * 32 * kWgBN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * h + 2 * q;
        // bytes 0, 1: columns c, c+1 of row r; bytes 2, 3: of row r + 1
        const uint32_t v = (wg_pair(vb, r, c) | wg_pair(vb, r + 1, c) << 16) ^ 0x80808080u;
        const uint32_t w = (wg_pair(vb, r + 8, c) | wg_pair(vb, r + 9, c) << 16) ^ 0x80808080u;
        uint32_t (&f)[4] = a[2 * b + h];
        f[0] = bf16x2_bits(fmaf(q8_field<0>(v), s0, m0), fmaf(q8_field<2>(v), s0, m0));
        f[1] = bf16x2_bits(fmaf(q8_field<1>(v), s1, m1), fmaf(q8_field<3>(v), s1, m1));
        f[2] = bf16x2_bits(fmaf(q8_field<0>(w), s0, m0), fmaf(q8_field<2>(w), s0, m0));
        f[3] = bf16x2_bits(fmaf(q8_field<1>(w), s1, m1), fmaf(q8_field<3>(w), s1, m1));
      }
    }
  }
};

// The block's shared memory (from a 1024-byte-aligned base): the ring's x
// tiles, value tiles and scale rows, for Q40 three buffers of a step's
// block sums (folded, exact), then the full and empty barriers; kStages
// ring stages (a stage's copies take about a microsecond to land, so the
// ring runs several steps ahead), kAcc accumulators a thread.
// ops/q40.py and ops/q8.py MMA_STAGES, MMA_SMEM hold the same numbers.
template <class Codec, int BM>
struct WgShape {
  static constexpr int kStages = 8;
  static constexpr int kAcc = BM / 2;
  static constexpr int kX = BM * kWgBK * 2;
  static constexpr int kVals = 2 * Codec::kRowsPerBlock * kWgBN;  // a step's stored rows x 128
  static constexpr int kVOff = kStages * kX;
  static constexpr int kSOff = kVOff + kStages * kVals;
  static constexpr int kBsOff = kSOff + kStages * kWgScales;
  static constexpr int kBarOff = kBsOff + (Wg<Codec>::kBlockSums ? 3 * 2 * BM * 4 : 0);
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;
  static_assert(kSmem <= kMaxSmem, "the tensor-core body exceeds the opt-in shared memory");
};

// The producer warp's copies of a step's weights where TMA cannot take
// them: 2 RPB stored rows of 128 bytes in pieces of N (16, 8, 4; 1 = plain
// byte loads) into their swizzled places in `vals`, and two scale rows in
// pieces of SN bytes (16, 8, 4; 2 = plain loads) into `scs`; row r of the
// step lives at qp + v[r / RPB] + (r % RPB) * stride (scales: sc + s[r]),
// column c of the tile at lay.vcol / lay.scol(col0 + c).  Columns at or
// past vc (the plane's stored width) and blocks at or past n_blk are zero.
template <int N, int RPB, class Layout>
__device__ __forceinline__ void copy_vals(unsigned char* vals, const uint8_t* qp,
                                          const size_t* v, const Layout& lay, int col0, int vc,
                                          int n_blk, int lane) {
  constexpr int kPer = kWgBN / N;
  for (int e = lane; e < 2 * RPB * kPer; e += 32) {
    const int r = e / kPer, c = (e % kPer) * N;
    const bool ok = c + N <= vc && r / RPB < n_blk;
    const uint8_t* src =
        ok ? qp + v[r / RPB] + lay.vcol(col0 + c) + (size_t)(r % RPB) * lay.stride() : qp;
    if constexpr (N >= 4)
      cp_async_zfill<N>(vals + vsw(r, c), src, ok);
    else
      vals[vsw(r, c)] = ok ? *src : static_cast<unsigned char>(0);
  }
}

template <int SN, class Layout>
__device__ __forceinline__ void copy_scales(unsigned char* scs, const __half* sc,
                                            const size_t* s, const Layout& lay, int col0, int vc,
                                            int n_blk, int lane) {
  constexpr int kPer = 2 * kWgBN / SN;
  for (int e = lane; e < 2 * kPer; e += 32) {
    const int r = e / kPer, c = (e % kPer) * (SN / 2);
    const bool ok = c + SN / 2 <= vc && r < n_blk;
    const __half* src = ok ? sc + s[r] + lay.scol(col0 + c) : sc;
    unsigned char* dst = scs + r * 2 * kWgBN + c * 2;
    if constexpr (SN >= 4)
      cp_async_zfill<SN>(dst, src, ok);
    else
      *reinterpret_cast<__half*>(dst) = ok ? *src : __ushort_as_half(static_cast<unsigned short>(0));
  }
}

// A step's two quantization blocks (RPB stored rows each), moving the
// cursor on by two blocks; no division.  step_rows: the element offsets of
// each block's first stored row and of its scale row within a plane, for
// the copies; tma_rows: their stored rows (of the plane's rows of
// `stride`) in column tile `ct` (kernel 3's c / td; 0 row-major), for the
// TMA boxes.  The blocked layout holds Q40 planes only.
template <int RPB>
__device__ __forceinline__ void step_rows(const RowMajor& l, RowMajor::Cursor& c, size_t* v,
                                          size_t* s) {
  v[0] = (size_t)c.b * RPB * l.d;
  v[1] = v[0] + (size_t)RPB * l.d;
  s[0] = (size_t)c.b * l.d;
  s[1] = s[0] + l.d;
  c.b += 2;
}

template <int RPB>
__device__ __forceinline__ void step_rows(const Blocked& l, Blocked::Cursor& c, size_t* v,
                                          size_t* s) {
  static_assert(RPB == 16, "the blocked layout holds Q40 planes");
  unsigned q1 = c.q, rem1 = c.rem;
  l.next_block(q1, rem1);
  v[0] = ((size_t)c.q * l.nJ * l.bn + c.rem) * l.td;
  v[1] = ((size_t)q1 * l.nJ * l.bn + rem1) * l.td;
  s[0] = ((size_t)c.q * l.nJ * (l.bn / 16) + c.rem / 16) * l.td;
  s[1] = ((size_t)q1 * l.nJ * (l.bn / 16) + rem1 / 16) * l.td;
  l.next_block(q1, rem1);
  c = {q1, rem1};
}

template <int RPB>
__device__ __forceinline__ void tma_rows(const RowMajor&, RowMajor::Cursor& c, int, int* v,
                                         int* s) {
  v[0] = (int)c.b * RPB;
  v[1] = v[0] + RPB;
  s[0] = (int)c.b;
  s[1] = s[0] + 1;
  c.b += 2;
}

template <int RPB>
__device__ __forceinline__ void tma_rows(const Blocked& l, Blocked::Cursor& c, int ct, int* v,
                                         int* s) {
  static_assert(RPB == 16, "the blocked layout holds Q40 planes");
  unsigned q1 = c.q, rem1 = c.rem;
  l.next_block(q1, rem1);
  v[0] = (int)((c.q * l.nJ + ct) * l.bn + c.rem);
  v[1] = (int)((q1 * l.nJ + ct) * l.bn + rem1);
  s[0] = (int)((c.q * l.nJ + ct) * (l.bn / 16) + c.rem / 16);
  s[1] = (int)((q1 * l.nJ + ct) * (l.bn / 16) + rem1 / 16);
  l.next_block(q1, rem1);
  c = {q1, rem1};
}

// wgmma m64nBMk16 RS with a K-major B
template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  if constexpr (BM == 16)
    wgmma_rs_kmaj_n16(d, a, b, acc);
  else if constexpr (BM == 32)
    wgmma_rs_kmaj_n32(d, a, b, acc);
  else
    wgmma_rs_kmaj_n128(d, a, b, acc);
}

template <class Codec, int BM, class Layout>
__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_matmul(const __grid_constant__ CUtensorMap map_x,  // x (t, n) bf16, boxes 64 x BM
             const __grid_constant__ CUtensorMap map_v,  // values as rows of stride bytes
             const __grid_constant__ CUtensorMap map_s,  // scales as rows of stride f16
             const uint8_t* __restrict__ qpacked, const __half* __restrict__ scales,
             const int* __restrict__ plane_p, float* __restrict__ part, int t, int n, int np,
             int d, int n_planes, int steps_per, int tma, int w_al, int s_al, Layout lay) {
  using S = WgShape<Codec, BM>;
  constexpr int V = Codec::kVariant;
  constexpr int RPB = Codec::kRowsPerBlock;
  constexpr bool kSums = V == kFolded || V == kExact;
  static_assert(V == kClassic || kSums, "fma runs the classic body");
  static_assert(!kSums || Wg<Codec>::kBlockSums, "the variants keep block sums");
  const int m0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kWgBN;
  const int n_steps = (n + kWgBK - 1) / kWgBK;
  const int s_begin = blockIdx.z * steps_per;
  const int n_mine = min(n_steps, s_begin + steps_per) - s_begin;
  if (n_mine <= 0) return;
  const int nb = n / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t full0 = smem_u32(base + S::kBarOff);
  const uint32_t empty0 = full0 + 8 * S::kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      bar_init(full0 + 8 * i, 1);   // the producer's arrival (and its copies' bytes)
      bar_init(empty0 + 8 * i, 8);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are ready: no block-wide sync after this

  if (threadIdx.x >= kWgConsumers) {
    // -- the producer warp ----------------------------------------------------
    const int lane = threadIdx.x & 31;
    const int plane = min(max(*plane_p, 0), n_planes - 1);
    const int stride = lay.stride();
    const int per_row = lay.cols() / stride;  // stored rows a logical row: nJ blocked, 1
    const int vrows = np / 32 * RPB;          // stored value rows of a plane
    const uint8_t* qp = qpacked + (size_t)plane * (size_t)vrows * (size_t)lay.cols();
    const __half* sc = scales + (size_t)plane * (size_t)(np / 32) * (size_t)lay.cols();
    const int vrow0 = plane * vrows * per_row, srow0 = plane * (np / 32) * per_row;
    const int vc = min(kWgBN, lay.cols() - col0);  // stored columns of the tile
    const int ctile = col0 / stride, ccol = col0 - ctile * stride;  // the box's column
    auto cur = lay.cursor((unsigned)s_begin * 2);
    const int tx = S::kX + (tma ? S::kVals + kWgScales : 0);
    for (int i = 0; i < n_mine; ++i) {
      const int s = i % S::kStages;
      const uint32_t full = full0 + 8 * s;
      const int k0 = (s_begin + i) * kWgBK;
      size_t v[2], sr[2];
      int vr[2], srr[2];
      if (tma)
        tma_rows<RPB>(lay, cur, ctile, vr, srr);
      else
        step_rows<RPB>(lay, cur, v, sr);
      if (i >= S::kStages) bar_wait(empty0 + 8 * s, (i / S::kStages - 1) & 1);
      unsigned char* vals = base + S::kVOff + s * S::kVals;
      unsigned char* scs = base + S::kSOff + s * kWgScales;
      if (!tma) {
        const int n_blk = nb - k0 / 32;
        switch (w_al) {
          case 16: copy_vals<16, RPB>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          case 8: copy_vals<8, RPB>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          case 4: copy_vals<4, RPB>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          default: copy_vals<1, RPB>(vals, qp, v, lay, col0, vc, n_blk, lane);
        }
        switch (s_al) {
          case 16: copy_scales<16>(scs, sc, sr, lay, col0, vc, n_blk, lane); break;
          case 8: copy_scales<8>(scs, sc, sr, lay, col0, vc, n_blk, lane); break;
          case 4: copy_scales<4>(scs, sc, sr, lay, col0, vc, n_blk, lane); break;
          default: copy_scales<2>(scs, sc, sr, lay, col0, vc, n_blk, lane);
        }
        bar_track_cp_async(full);
      }
      __syncwarp();
      if (lane == 0) {
        bar_expect(full, tx);
        tma_2d(smem_u32(base + s * S::kX), &map_x, k0, m0, full);
        if (tma) {
          // a block's RPB stored rows and its scale row
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            tma_2d(smem_u32(vals + b * RPB * kWgBN), &map_v, ccol, vrow0 + vr[b], full);
            tma_2d(smem_u32(scs + b * 2 * kWgBN), &map_s, ccol, srow0 + srr[b], full);
          }
        }
      }
    }
    if (!tma) cp_async_wait<0>();
    return;
  }

  // -- the consumer warpgroups ------------------------------------------------
  const int lane = threadIdx.x & 31;
  const int q = lane & 3;
  const int c = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) * 2;
  float* bsm = reinterpret_cast<float*>(base + S::kBsOff);  // [3][2][BM]

  // step i's A registers from its stage
  auto dequant = [&](int i, uint32_t (&a)[4][4]) {
    const int s = i % S::kStages;
    Wg<Codec>::frags(a, base + S::kVOff + s * S::kVals, base + S::kSOff + s * kWgScales, c, q,
                     nb - (s_begin + i) * 2);
  };

  // the k16 products of step i's x tile (B) and A registers, k16 slices
  // kk0 .. kk1 - 1, into dst (a fresh sum at kk0 when `fresh`)
  auto products = [&](int i, const uint32_t (&a)[4][4], float (&dst)[S::kAcc], int kk0, int kk1,
                      bool fresh) {
    const uint32_t xt = smem_u32(base + (i % S::kStages) * S::kX);
    wg_fence();
#pragma unroll
    for (int kk = kk0; kk < kk1; ++kk)
      wgmma_rs<BM>(dst, a[kk], sw128_desc(xt + kk * 32, 16, 1024), !(fresh && kk == kk0));
    wg_commit();
  };

  // folded, exact: step i's block sums of x, rows m x blocks b, into buffer
  // i % 3: thread u sums block u & 1 of row u >> 1 (its low 16 columns,
  // then its high 16, as the JAX kernel adds them) from the swizzled x tile
  auto block_sums = [&](int i) {
    const unsigned char* xs = base + (i % S::kStages) * S::kX;
    for (int u = threadIdx.x; u < 2 * BM; u += kWgConsumers) {
      const int r = u >> 1, b = u & 1;
      float half[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ch = 4 * b + 2 * h + k;
          const uint4 x4 = *reinterpret_cast<const uint4*>(xs + r * 128 + (((ch ^ r) & 7) << 4));
          const uint32_t wd[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum = sum + __uint_as_float(wd[e] << 16) + __uint_as_float(wd[e] & 0xFFFF0000u);
        }
        half[h] = sum;
      }
      const float bs = half[0] + half[1];
      bsm[((i % 3) * 2 + b) * BM + r] = V == kFolded ? bf16_round(bs) : bs;
    }
  };

  float acc[S::kAcc];
  float ext[S::kAcc];  // folded: the folds; exact: a block's p (unused classic)
#pragma unroll
  for (int e = 0; e < S::kAcc; ++e) acc[e] = 0.f;
  if constexpr (kSums) {
#pragma unroll
    for (int e = 0; e < S::kAcc; ++e) ext[e] = 0.f;
  }

  // fold block b of step i: exact acc += (p - 8 bs) s, folded ext += -8 bs s;
  // accumulator 4j + e is x row 8j + 2q + e at column c, 4j + 2 + e at c + 1
  auto fold = [&](int i, int b) {
    if ((s_begin + i) * 2 + b >= nb) return;  // a block past n holds no weights
    const uint32_t sr = *reinterpret_cast<const uint32_t*>(
        base + S::kSOff + (i % S::kStages) * kWgScales + b * 2 * kWgBN + c * 2);
    float s0 = f16_bits(sr & 0xFFFFu), s1 = f16_bits(sr >> 16);
    if constexpr (V == kFolded) s0 = bf16_round(s0), s1 = bf16_round(s1);
    const float* bsr = bsm + ((i % 3) * 2 + b) * BM;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const float2 bs = *reinterpret_cast<const float2*>(bsr + 8 * j + 2 * q);
      const float r[2] = {-8.f * bs.x, -8.f * bs.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (V == kExact) {
          acc[4 * j + e] = fmaf(ext[4 * j + e] + r[e], s0, acc[4 * j + e]);
          acc[4 * j + 2 + e] = fmaf(ext[4 * j + 2 + e] + r[e], s1, acc[4 * j + 2 + e]);
        } else {
          ext[4 * j + e] = fmaf(r[e], s0, ext[4 * j + e]);
          ext[4 * j + 2 + e] = fmaf(r[e], s1, ext[4 * j + 2 + e]);
        }
      }
    }
  };

  uint32_t a[2][4][4];  // the A registers of two steps
  // step i, its A registers in buffer P (the next step's go to 1 - P)
  auto step = [&](int i, auto P) {
    constexpr int p = decltype(P)::value;
    if constexpr (V == kExact) {
      // block 0 alone, waited for and folded; block 1 runs under the dequant
      products(i, a[p], ext, 0, 2, true);
      wg_wait();
      reg_fence(ext);
      fold(i, 0);
      products(i, a[p], ext, 2, 4, true);
    } else {
      products(i, a[p], acc, 0, 4, false);
    }
    wg_wait_n<1>();  // step i-1's products are done: its stage and registers are free
    if (i > 0) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) bar_arrive(empty0 + 8 * ((i - 1) % S::kStages));
    }
    if (i + 1 < n_mine) {
      bar_wait(full0 + 8 * ((i + 1) % S::kStages), ((i + 1) / S::kStages) & 1);
      dequant(i + 1, a[1 - p]);
      if constexpr (kSums) block_sums(i + 1);
    }
    if constexpr (V == kFolded) {
      fold(i, 0);
      fold(i, 1);
    }
    if constexpr (V == kExact) {
      wg_wait();
      reg_fence(ext);
      fold(i, 1);
    }
    // step i + 1's block sums are written; step i's were read (by both
    // warpgroups) before buffer (i + 1) % 3's next write, at step i + 3
    if constexpr (kSums) asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
  };

  bar_wait(full0, 0);
  dequant(0, a[0]);
  if constexpr (kSums) {
    block_sums(0);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
  }
  for (int i = 0; i < n_mine; i += 2) {
    step(i, std::integral_constant<int, 0>{});
    if (i + 1 < n_mine) step(i + 1, std::integral_constant<int, 1>{});
  }
  wg_wait();
  reg_fence(acc);
  if constexpr (V == kFolded) {
#pragma unroll
    for (int e = 0; e < S::kAcc; ++e) acc[e] += ext[e];
  }

  // accumulator 4j + e: x row 8j + 2q + e, column c; 4j + 2 + e: column c + 1
  float* dst = part + (size_t)blockIdx.z * t * d;
  const int col = col0 + c;
  const bool pairs = (d & 1) == 0 && col + 1 < d;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * q + e;
      if (row >= t) continue;
      float* o = dst + (size_t)row * d + col;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        if (col < d) o[0] = v0;
        if (col + 1 < d) o[1] = v1;
      }
    }
}

// The tensor-core body's launch: the x map each call (x moves), the
// weight maps once per plane pointer and shape (cached_map_2d); with `tma`
// 0 the weights go by the producer's copies and their maps are unused.
template <class Codec, int BM, class Layout>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
                         const int* idx, float* part, int t, int n, int np, int d, int n_planes,
                         int splits, int steps_per, int tma, int w_al, int s_al, Layout lay,
                         int stride, int per_row, cudaStream_t stream) {
  using S = WgShape<Codec, BM>;
  constexpr int RPB = Codec::kRowsPerBlock;
  CUtensorMap mx, mv, ms;
  cudaError_t e = encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, n, t, 2ull * n, kWgBK, BM,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  memset(&mv, 0, sizeof(mv));
  memset(&ms, 0, sizeof(ms));
  if (tma) {
    const unsigned long long rows = (unsigned long long)n_planes * (np / 32 * RPB) * per_row;
    e = cached_map_2d(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, qp, stride, rows, stride, kWgBN, RPB,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = cached_map_2d(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, sc, stride,
                        (unsigned long long)n_planes * (np / 32) * per_row, 2ull * stride, kWgBN,
                        1, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  auto kern = wgmma_matmul<Codec, BM, Layout>;
  // the dynamic shared-memory opt-in, once per instantiation and device
  static unsigned done = 0;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !(done >> dev & 1u)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (e != cudaSuccess) return e;
    if (dev < 32) done |= 1u << dev;
  }
  const dim3 grid((t + BM - 1) / BM, (d + kWgBN - 1) / kWgBN, splits);
  kern<<<grid, kWgThreads, S::kSmem, stream>>>(mx, mv, ms, qp, sc, idx, part, t, n, np, d,
                                               n_planes, steps_per, tma, w_al, s_al, lay);
  return cudaGetLastError();
}

// The tensor-core entry points' body: the tile height by bm, then the
// fixed-order reduce of the splits.  `stride` is the bytes between two
// stored rows (d, or kernel 3's td), `per_row` the stored rows of a logical
// row (1, or kernel 3's nJ column tiles).
template <class Codec, class Layout>
int run_wgmma(const void* x, const void* qpacked, const void* scales, void* out, void* scratch,
              const void* idx, int t, int n, int np, int d, int n_planes, int bm, int splits,
              int steps_per, int tma, int w_al, int s_al, Layout lay, int stride, int per_row,
              void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(qpacked);
  const __half* sc = static_cast<const __half*>(scales);
  const int* ip = static_cast<const int*>(idx);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bm) {
    case 16:  // the codec's 16-row tile, where it has one
      if constexpr (Wg<Codec>::kMinBM > 16)
        return (int)cudaErrorInvalidValue;
      else
        e = launch_wgmma<Codec, 16, Layout>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits,
                                            steps_per, tma, w_al, s_al, lay, stride, per_row, s);
      break;
    case 32:
      e = launch_wgmma<Codec, 32, Layout>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits,
                                          steps_per, tma, w_al, s_al, lay, stride, per_row, s);
      break;
    case 128:
      e = launch_wgmma<Codec, 128, Layout>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits,
                                           steps_per, tma, w_al, s_al, lay, stride, per_row, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    reduce_splits<typename Wg<Codec>::Family><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}

// The block at tile height bm (the layout reports of both codecs): out[0]
// threads, out[1] dynamic shared memory in bytes, out[2] ring stages.
template <class Codec>
int wg_layout(int bm, int* out) {
  switch (bm) {
    case 16:
      if constexpr (Wg<Codec>::kMinBM > 16) {
        return (int)cudaErrorInvalidValue;
      } else {
        out[1] = WgShape<Codec, 16>::kSmem;
        out[2] = WgShape<Codec, 16>::kStages;
      }
      break;
    case 32:
      out[1] = WgShape<Codec, 32>::kSmem;
      out[2] = WgShape<Codec, 32>::kStages;
      break;
    case 128:
      out[1] = WgShape<Codec, 128>::kSmem;
      out[2] = WgShape<Codec, 128>::kStages;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  out[0] = kWgThreads;
  return 0;
}

}  // namespace
