// The decode-width body of the Q40 and Q80 dequant-matmul kernels
// (q40_matmul.cu: kernels 1-3, both layouts; q8_matmul.cu: kernels 5-6),
// for calls of t < T_MMA rows (ops/q40.py, ops/q8.py route): one template
// over a codec policy (Q40's paired nibble rows, Q80's int8 rows) and a
// layout (row-major, or kernel 3's tile-contiguous planes).
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,  W[k, j] = bf16(f32(w(k, j)) * f32(s[k/32, j]))
//
// with w = nib - 8 (Q40) or the int8 value (Q80): the "classic" numerics.
// The Q40 codec also computes two other dequant variants of the JAX
// kernel (dllama_tpu/ops/q40.py _q40_kernel, DLLAMA_Q40_VARIANT; ops/q40.py
// here), with bs_b the f32 sum of bf16(x) over block b (its lo half's sum
// plus its hi half's), taken once a call from the staged x pairs:
//   folded: y = x @ bf16(bf16(v) * bf16(s)) - 8 * sum_b bf16(bs_b) * bf16(s_b)
//   exact:  y = sum_b (p_b - 8 * bs_b) * s_b,  p_b = x . v over block b
// (v the raw nibble).  "fma" takes the classic codec (q40_matmul.cu).
//
// What bounds it on this card: at t = 1 each weight is read once and used
// once, so the bytes of the planes (0.5625 B a weight for Q40, 1.0625 for
// Q80) against 3.35 TB/s, of which a stream of 128-byte row pieces reaches
// well under all at these sizes; and, close behind, the instructions that
// turn a byte into bf16 weights (the card issues about 10 operations for
// every byte its memory delivers).  What the design does about them:
//  * One launch a call.  A block owns a tile of kCols output columns and a
//    split of n; its 8 warps walk the split, each a contiguous run of
//    quantization blocks, and add their partials through shared memory in
//    warp order.  The plan (ops/q40.py gemv_plan, which sees the call's own
//    d, so a tensor-parallel rank's slice gets its own) splits n as far as
//    one wave of two blocks an SM allows: d = 4096 gives 32 tiles of 128
//    columns, so 8 splits.  The splits of a tile meet in a small workspace
//    the wrapper allocates once (a sum a split and tile, a count a tile):
//    each split stores its sum, and the last to arrive (an atomic count
//    after a fence) adds every split's sum in split order, writes the
//    output and sets the count back to 0.  No second launch, no float
//    atomics, one fixed order: results repeat bit for bit.  (Thread-block
//    clusters adding through distributed shared memory timed slower, and
//    slower still at 8 blocks a cluster; PERF.md.)
//  * Long blocks, wide loads, two blocks of weights in flight a warp.  A
//    thread reads its columns' row pieces of a block in pieces of VW bytes
//    (16 where the row stride and the pointers allow, then 8, 4 or 1:
//    ragged d, kernel 3's td = 100) with non-allocating loads into
//    registers, and keeps the next block's loads in flight while it unpacks
//    this one (a register double buffer: on this card a cp.async ring in
//    shared memory streamed the same pattern more slowly, at any depth);
//    the first two blocks are issued before the block stages its slice of
//    x, so the prologue (the plane index, x) overlaps them.
//  * The tensor cores do the multiply-adds, so the FP32 pipe only unpacks:
//    the weights of a quantization block are the A operand of mma.sync
//    m16n8k16 (m = 16 output columns, k = 16 rows of n), x the B operand
//    (n = 8 rows of x; t < 8 leaves rows of zeros).  The k order inside a
//    step is free, so it follows the storage: a register pairs rows
//    32b + r and 32b + 16 + r (one byte's two nibbles in Q40, rows r and
//    r + 16 in Q80), and x is staged in the same pairs.  A warp's 32 lanes
//    (8 groups of 4) own 16 (Q40) or 8 (Q80) columns a group: the lane's
//    group picks the columns, its place in the group the rows.
//  * A weight is one LOP3 and one FFMA before its bf16 round: the OR of a
//    nibble (or a sign-flipped int8) at mantissa bit p into the exponent of
//    2^(23-p) gives the float 2^(23-p) + v exactly, and
//    fma(2^(23-p) + v, s, -(2^(23-p) + bias) * s) = (v - bias) * s exactly:
//    the product is formed exactly inside the FMA, the constant
//    (2^(23-p) + bias) * s is an exact f32 (bias 8 for Q40 with p in 8, 12,
//    16; 128 for Q80 with p = 8: at most 24 significant bits), and the
//    result, at most 15 (Q40) or 19 (Q80) bits, is representable.  Two such
//    weights round to a bf16 pair in one cvt.rn.bf16x2.f32 (round to
//    nearest even): the same bf16 as bf16(f32(w) * f32(s)) of the plain
//    version.  Products of bf16 values are exact, so the result differs
//    from the plain version's only in the order of the f32 sums.
// Both layouts take the same plan on the logical (n, d) and add the same
// products in the same order, so kernel 3 equals kernels 1-2 bit for bit;
// the blocked layout's rows are addressed by a cursor (no division in the
// loop).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

constexpr int kGemvWarps = 8;                     // ops/q40.py GEMV_WARPS
constexpr int kGemvThreads = 32 * kGemvWarps;
constexpr int kGemvRows = 8;                      // rows of x a launch: the mma's n

// Where a quantization block's stored rows and scales live.  The GEMV body
// walks a warp's blocks in order: cursor(b) at its first block (kernel 3:
// one division), gemv_rows the offsets of the cursor's block (its first
// stored row and its scale row within a plane), gemv_next moves the cursor
// on by one block; vcol/scol add a column; stride() is the distance of two
// stored rows, cols() a plane's stored width (d, or dp when blocked).  The
// tensor-core body (wgmma_matmul.cuh) walks two blocks a step (its
// step_rows and tma_rows).
struct RowMajor {
  int d;
  __device__ int stride() const { return d; }
  __device__ int cols() const { return d; }
  struct Cursor {
    unsigned b;
  };
  __device__ Cursor cursor(unsigned b0) const { return {b0}; }
  // RPB stored rows a block: 16 packed Q40 rows, 32 Q80 rows
  template <int RPB>
  __device__ void gemv_rows(const Cursor& c, size_t& v, size_t& s) const {
    v = (size_t)c.b * RPB * d;
    s = (size_t)c.b * d;
  }
  __device__ void gemv_next(Cursor& c) const { ++c.b; }
  __device__ size_t vcol(int c) const { return c; }
  __device__ size_t scol(int c) const { return c; }
};

// Kernel 3's planes: (n2/bn, dp/td, bn, td) packed bytes, (n2/bn, dp/td,
// bn/16, td) scales.  The cursor holds the row tile q and the packed row
// rem within it of its block; a block either follows the one before in its
// row tile or opens the next (bn % 16 == 0).
struct Blocked {
  int bn, td, nJ;  // packed rows a tile (a multiple of 16), columns a tile, column tiles
  __device__ int stride() const { return td; }
  __device__ int cols() const { return nJ * td; }
  struct Cursor {
    unsigned q, rem;
  };
  __device__ Cursor cursor(unsigned b0) const { return {b0 * 16 / bn, b0 * 16 % bn}; }
  __device__ void next_block(unsigned& q, unsigned& rem) const {
    rem += 16;
    if (rem == (unsigned)bn) {
      rem = 0;
      ++q;
    }
  }
  template <int RPB>
  __device__ void gemv_rows(const Cursor& c, size_t& v, size_t& s) const {
    static_assert(RPB == 16, "the blocked layout holds Q40 planes");
    v = ((size_t)c.q * nJ * bn + c.rem) * td;
    s = ((size_t)c.q * nJ * (bn / 16) + c.rem / 16) * td;
  }
  __device__ void gemv_next(Cursor& c) const { next_block(c.q, c.rem); }
  __device__ size_t vcol(int c) const { return (size_t)(c / td) * bn * td + c % td; }
  __device__ size_t scol(int c) const { return (size_t)(c / td) * (bn / 16) * td + c % td; }
};

// The float 2^(23-p) + v for the field of `bits` at mantissa bits p.. (the
// field masked by kMask, the exponent and, for Q80, the sign flip in kK):
// one LOP3, (bits & kMask) ^ kK (C++ would split it in two)
template <uint32_t kMask, uint32_t kK>
__device__ __forceinline__ float field_f32(uint32_t bits) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(r) : "r"(bits), "n"(kMask), "n"(kK));
  return __uint_as_float(r);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 w = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// The Q40 dequant variants (ops/q40.py VARIANTS, by index: "fma", 1, is
// served by kClassic's arithmetic).
enum Variant : int { kClassic = 0, kFma = 1, kFolded = 2, kExact = 3 };

// d = a * b + c on two bf16 lanes, rounded once to nearest even
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// f32 to bf16 bits, rounded to nearest even
__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// f32 rounded to the nearest bf16 (even on a tie), as an f32
__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// Of a bf16x2 word (128 + a, 128 + b) (nibbles a, b under the exponent of
// 128, exact): (a * sb, b * sb) each rounded once to bf16 (folded; s2 is
// bf16x2 (sb, sb), m2 (-128 sb, -128 sb), the product exact inside the
// FMA), or the raw (a, b) (exact: s2 1.0, m2 -128).
struct NibScale {
  uint32_t s2, m2;
  __device__ static NibScale of(float sb) {
    const uint32_t b = bf16_bits(sb), m = bf16_bits(-128.f * sb);
    return {b | b << 16, m | m << 16};
  }
  __device__ static NibScale raw() { return {0x3F803F80u, 0xC300C300u}; }
  __device__ uint32_t operator()(uint32_t biased) const { return fma_bf16x2(biased, s2, m2); }
};

// Q40: packed row 16b + r holds rows 32b + r (low nibble) and 32b + 16 + r
// (high nibble).  A thread owns 16 columns (a 16-byte piece of a packed
// row) and reads 4 packed rows of each block, r = tig + 4j (j = 0..3): the
// k pairs tig and tig + 4 of the block's two mma steps.  V: the variant.
template <int V>
struct Q4V {
  static constexpr int kVariant = V;
  static constexpr int kCols = 16;          // columns a thread
  static constexpr int kRowsPerBlock = 16;  // stored rows a quantization block
  static constexpr int kRows = 4;           // stored rows a thread reads a block
  static constexpr int kValWords = kRows * kCols / 4;
  __device__ static int row(int j, int tig) { return tig + 4 * j; }
  // folded, exact: the nibble pair (v(32b + r, c), v(32b + 16 + r, c)) of
  // pair row j as bf16x2 (128 + lo, 128 + hi): one byte permute puts the
  // byte at bits 0 and (shifted by 4) 16, one LOP3 masks and adds 128
  __device__ static uint32_t biased_pair(const uint32_t* w, int j, int c) {
    const uint32_t u = w[j * (kCols / 4) + (c >> 2)];
    const int k = c & 3;
    return (__byte_perm(u, u >> 4, k * 0x11 + (4 + k) * 0x1100) & 0x000F000Fu) | 0x43004300u;
  }
  // classic: the bf16 pair (w(32b + r, c), w(32b + 16 + r, c)) of pair row j
  __device__ static uint32_t pair(const uint32_t* w, int j, int c, float s) {
    const uint32_t u = w[j * (kCols / 4) + (c >> 2)];
    float lo, hi;
    switch (c & 3) {  // the byte's place in its word
      case 0:  // nibbles to bits 8 and 12
        lo = fmaf(field_f32<0xF00u, 0x47000000u>(u << 8), s, -32776.f * s);
        hi = fmaf(field_f32<0xF000u, 0x45000000u>(u << 8), s, -2056.f * s);
        break;
      case 1:
        lo = fmaf(field_f32<0xF00u, 0x47000000u>(u), s, -32776.f * s);
        hi = fmaf(field_f32<0xF000u, 0x45000000u>(u), s, -2056.f * s);
        break;
      case 2:  // low nibble at bit 16, high nibble to bit 12
        lo = fmaf(field_f32<0xF0000u, 0x43000000u>(u), s, -136.f * s);
        hi = fmaf(field_f32<0xF000u, 0x45000000u>(u >> 8), s, -2056.f * s);
        break;
      default:
        lo = fmaf(field_f32<0xF0000u, 0x43000000u>(u >> 8), s, -136.f * s);
        hi = fmaf(field_f32<0xF000u, 0x45000000u>(u >> 16), s, -2056.f * s);
    }
    return bf16x2_bits(lo, hi);
  }
};
using Q4 = Q4V<kClassic>;

// Q80: one int8 row per position.  A thread owns 8 columns (an 8-byte
// piece of a row) and reads rows r and r + 16 of each block for
// r = tig + 4j: stored row j (< 4) is 32b + r, j + 4 is 32b + 16 + r.
struct Q8 {
  static constexpr int kVariant = kClassic;
  static constexpr int kCols = 8;
  static constexpr int kRowsPerBlock = 32;
  static constexpr int kRows = 8;
  static constexpr int kValWords = kRows * kCols / 4;
  __device__ static int row(int j, int tig) { return tig + 4 * (j & 3) + 16 * (j >> 2); }
  __device__ static float value(uint32_t u, int c, float s) {
    // the byte to bits 8..15, its sign flipped (v + 128), under 2^15's
    // exponent: 2^15 + 128 + v; minus (2^15 + 128) s in the FMA
    const uint32_t b = (c & 3) == 0 ? u << 8 : (c & 3) == 1 ? u : (c & 3) == 2 ? u >> 8 : u >> 16;
    return fmaf(field_f32<0xFF00u, 0x47008000u>(b), s, -32896.f * s);
  }
  __device__ static uint32_t pair(const uint32_t* w, int j, int c, float s) {
    return bf16x2_bits(value(w[j * (kCols / 4) + (c >> 2)], c, s),
                       value(w[(j + 4) * (kCols / 4) + (c >> 2)], c, s));
  }
};

// N bytes from src into the words w at byte offset off (zero when !ok):
// non-allocating vector loads for the weights (each read once), cached
// loads for the scales (the four lanes of a group share them)
template <int N, bool kStream>
__device__ __forceinline__ void load_bytes(uint32_t* w, int off, const uint8_t* src, bool ok) {
  if constexpr (N >= 16) {
#pragma unroll
    for (int h = 0; h < N / 16; ++h) {
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        if constexpr (kStream)
          asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
              : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
              : "l"(src + 16 * h));
        else
          r = __ldg(reinterpret_cast<const uint4*>(src + 16 * h));
      }
      w[off / 4 + 4 * h] = r.x;
      w[off / 4 + 4 * h + 1] = r.y;
      w[off / 4 + 4 * h + 2] = r.z;
      w[off / 4 + 4 * h + 3] = r.w;
    }
  } else if constexpr (N == 8) {
    uint2 r = make_uint2(0u, 0u);
    if (ok) {
      if constexpr (kStream)
        asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
            : "=r"(r.x), "=r"(r.y)
            : "l"(src));
      else
        r = __ldg(reinterpret_cast<const uint2*>(src));
    }
    w[off / 4] = r.x;
    w[off / 4 + 1] = r.y;
  } else if constexpr (N == 4) {
    w[off / 4] = ok ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
  } else {  // 2 or 1 bytes: into part of a word, the word's first piece clears it
    uint32_t r = 0;
    if (ok)
      r = N == 2 ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(src))
                 : (uint32_t)__ldg(src);
    const int sh = 8 * (off & 3);
    w[off / 4] = sh ? (w[off / 4] | r << sh) : r;
  }
}

// A thread's share of one quantization block, in registers: kRows stored
// row pieces of kCols bytes (words w[j * kCols / 4 ...]), then the kCols
// f16 scales (words w[kValWords ...], two a word)
template <class Codec>
struct Frag {
  uint32_t w[Codec::kValWords + Codec::kCols / 2];
};

// Load the cursor's block: kRows row pieces of VW bytes at each live
// column piece, and their scales, 2 VW bytes a piece
template <class Codec, int VW, class Layout>
__device__ __forceinline__ void gemv_load(Frag<Codec>& f, const uint8_t* qp, const __half* sc,
                                          const Layout& lay, const typename Layout::Cursor& cur,
                                          const size_t (&vcol)[Codec::kCols / VW],
                                          const size_t (&scol)[Codec::kCols / VW],
                                          const bool (&live)[Codec::kCols / VW], int tig) {
  size_t vr, sr;
  lay.template gemv_rows<Codec::kRowsPerBlock>(cur, vr, sr);
  const size_t stride = (size_t)lay.stride();
#pragma unroll
  for (int j = 0; j < Codec::kRows; ++j) {
    const uint8_t* row = qp + vr + (size_t)Codec::row(j, tig) * stride;
#pragma unroll
    for (int p = 0; p < Codec::kCols / VW; ++p)
      load_bytes<VW, true>(f.w + j * (Codec::kCols / 4), p * VW, row + vcol[p], live[p]);
  }
  const uint8_t* srow = reinterpret_cast<const uint8_t*>(sc + sr);
#pragma unroll
  for (int p = 0; p < Codec::kCols / VW; ++p)
    load_bytes<2 * VW, false>(f.w + Codec::kValWords, p * 2 * VW, srow + 2 * scol[p], live[p]);
}

// The block's products: kCols/2 m16 tiles (columns c = 2i for the mma rows
// of the lane group, 2i + 1 for the rows 8 below), two k16 steps each; x
// pairs (4 words, one for each pair row j) from shared memory.  The C
// fragment's rows are x rows 2 tig (acc[i][0], [2]) and 2 tig + 1 ([1],
// [3]); bs holds those two rows' block sums (folded: rounded to bf16).
template <class Codec>
__device__ __forceinline__ void gemv_mma(float (&acc)[Codec::kCols / 2][4], const Frag<Codec>& f,
                                         const uint4 xw, const float2 bs) {
  const uint32_t* w = f.w;
  const uint32_t xr[4] = {xw.x, xw.y, xw.z, xw.w};
#pragma unroll
  for (int i = 0; i < Codec::kCols / 2; ++i) {
    const uint32_t sb = w[Codec::kValWords + i];
    const float s0 = f16_bits(sb), s1 = f16_bits(sb >> 16);
    if constexpr (Codec::kVariant == kClassic) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t a[4] = {Codec::pair(w, 2 * k, 2 * i, s0),
                               Codec::pair(w, 2 * k, 2 * i + 1, s1),
                               Codec::pair(w, 2 * k + 1, 2 * i, s0),
                               Codec::pair(w, 2 * k + 1, 2 * i + 1, s1)};
        mma_bf16(acc[i], a, xr[2 * k], xr[2 * k + 1]);
      }
    } else {
      // folded: bf16(v) * bf16(s) a pair, into acc, then the bias;
      // exact: raw nibbles into a fresh fragment, then (p - 8 bs) * s
      constexpr bool kFold = Codec::kVariant == kFolded;
      const float b0 = kFold ? bf16_round(s0) : s0, b1 = kFold ? bf16_round(s1) : s1;
      const NibScale n0 = kFold ? NibScale::of(b0) : NibScale::raw();
      const NibScale n1 = kFold ? NibScale::of(b1) : NibScale::raw();
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t a[4] = {n0(Codec::biased_pair(w, 2 * k, 2 * i)),
                               n1(Codec::biased_pair(w, 2 * k, 2 * i + 1)),
                               n0(Codec::biased_pair(w, 2 * k + 1, 2 * i)),
                               n1(Codec::biased_pair(w, 2 * k + 1, 2 * i + 1))};
        mma_bf16(kFold ? acc[i] : p, a, xr[2 * k], xr[2 * k + 1]);
      }
      const float r0 = -8.f * bs.x, r1 = -8.f * bs.y;  // exact: 8 bs is exact
      if constexpr (kFold) {
        acc[i][0] = fmaf(r0, b0, acc[i][0]);
        acc[i][1] = fmaf(r1, b0, acc[i][1]);
        acc[i][2] = fmaf(r0, b1, acc[i][2]);
        acc[i][3] = fmaf(r1, b1, acc[i][3]);
      } else {
        acc[i][0] = fmaf(p[0] + r0, s0, acc[i][0]);
        acc[i][1] = fmaf(p[1] + r1, s0, acc[i][1]);
        acc[i][2] = fmaf(p[2] + r0, s1, acc[i][2]);
        acc[i][3] = fmaf(p[3] + r1, s1, acc[i][3]);
      }
    }
  }
}

// Shared memory a block: x pairs of a chunk of n during the walk, the
// warps' partials after it
constexpr int kGemvSmemWords = 8192;  // 32 KB

template <class Codec, class Layout, int VW>
__global__ void __launch_bounds__(kGemvThreads, 2)
gemv_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n), t <= kGemvRows
            const uint8_t* __restrict__ vals,      // n_planes planes
            const __half* __restrict__ scales,     // n_planes planes
            const int* __restrict__ plane_p,       // the plane to read
            float* __restrict__ out,               // (t, d)
            float* __restrict__ part,              // (splits, tiles, t, kCols)
            int* __restrict__ count,               // one a column tile, all 0
            int t, int n, int np, int d, int n_planes, int kb_per, Layout lay) {
  constexpr int kCols = Codec::kCols * 8;  // a column tile
  constexpr int kPieces = Codec::kCols / VW;
  static_assert(kGemvWarps * kGemvRows * kCols <= kGemvSmemWords, "partials fit");
  constexpr bool kSums = Codec::kVariant != kClassic;
  __shared__ __align__(16) uint32_t smem[kGemvSmemWords];
  // folded, exact: the block sums of x, (block of the chunk, row)
  __shared__ float bsm[kSums ? kGemvSmemWords / 16 : 1];
  __shared__ int last;
  float* red = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the plane index lives in device memory (a layer, or layer*E + expert
  // chosen on the device); clamping keeps a bad value inside the planes
  const size_t plane = (size_t)min(max(*plane_p, 0), n_planes - 1);
  const uint8_t* qp =
      vals + plane * (size_t)(np / 32 * Codec::kRowsPerBlock) * (size_t)lay.cols();
  const __half* sc = scales + plane * (size_t)(np / 32) * (size_t)lay.cols();
  const int tile0 = blockIdx.x * kCols;
  size_t vcol[kPieces], scol[kPieces];
  bool live[kPieces];
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = tile0 + Codec::kCols * gid + p * VW;
    live[p] = c + VW <= lay.cols();
    vcol[p] = live[p] ? lay.vcol(c) : 0;
    scol[p] = live[p] ? lay.scol(c) : 0;
  }
  const int nb = n / 32;
  const int b_begin = min(nb, (int)blockIdx.y * kb_per), b_end = min(nb, b_begin + kb_per);
  const int tg = t;
  const int chunk = kGemvSmemWords / (16 * tg);  // blocks of x pairs smem holds
  float acc[Codec::kCols / 2][4];
#pragma unroll
  for (int i = 0; i < Codec::kCols / 2; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int cb = b_begin; cb < b_end; cb += chunk) {
    const int len = min(chunk, b_end - cb);
    const int per = (len + kGemvWarps - 1) / kGemvWarps;
    const int k0 = cb + min(len, warp * per), k1 = cb + min(len, (warp + 1) * per);
    auto cur = lay.cursor((unsigned)k0);
    Frag<Codec> f[2];
    // the warp's first two blocks go in flight before x is staged
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (k0 + i < k1) {
        gemv_load<Codec, VW>(f[i], qp, sc, lay, cur, vcol, scol, live, tig);
        lay.gemv_next(cur);
      }
    __syncthreads();  // the previous chunk's x pairs are read
    // x pairs of the chunk: word ((kb * tg + g) * 16 + 4 * tig + j) holds
    // bf16 (x[g][32 kb + r], x[g][32 kb + 16 + r]) for r = tig + 4 j
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
    for (int e = threadIdx.x; e < len * tg * 16; e += kGemvThreads) {
      const int w16 = e & 15, row = e >> 4;
      const int kb = row / tg, g = row - kb * tg;
      const size_t k = (size_t)32 * (cb + kb) + (w16 >> 2) + 4 * (w16 & 3);
      const unsigned short* xr = xh + (size_t)g * n + k;
      smem[e] = (uint32_t)xr[0] | (uint32_t)xr[16] << 16;
    }
    __syncthreads();
    if constexpr (kSums) {
      // block sums, once a call: the lo halves' sum plus the hi halves'
      for (int e = threadIdx.x; e < len * tg; e += kGemvThreads) {
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const uint32_t v = smem[e * 16 + q];
          lo += __uint_as_float(v << 16);
          hi += __uint_as_float(v & 0xFFFF0000u);
        }
        bsm[e] = Codec::kVariant == kFolded ? bf16_round(lo + hi) : lo + hi;
      }
      __syncthreads();
    }
    auto xpairs = [&](int kb) {
      return gid < tg ? *reinterpret_cast<const uint4*>(smem + ((kb - cb) * tg + gid) * 16 +
                                                        4 * tig)
                      : make_uint4(0u, 0u, 0u, 0u);
    };
    // this lane's two C rows' block sums (rows past t: 0)
    auto xsums = [&](int kb) {
      if constexpr (!kSums) return make_float2(0.f, 0.f);
      const float* b = bsm + (kb - cb) * tg;
      return make_float2(2 * tig < tg ? b[2 * tig] : 0.f, 2 * tig + 1 < tg ? b[2 * tig + 1] : 0.f);
    };
    // two blocks in registers: one unpacked while the other's loads fly,
    // its registers then refilled with the block two ahead (four deep, at
    // 255 registers a thread, timed slower on the card)
    for (int kb = k0; kb < k1; kb += 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kb + i < k1) {
          gemv_mma<Codec>(acc, f[i], xpairs(kb + i), xsums(kb + i));
          if (kb + i + 2 < k1) {
            gemv_load<Codec, VW>(f[i], qp, sc, lay, cur, vcol, scol, live, tig);
            lay.gemv_next(cur);
          }
        }
      }
    }
  }

  // the warps' partials, (warp, row, column) in smem: lane group gid's
  // tile i holds columns kCols_thread * gid + 2i (c0, c1) and + 1 (c2, c3)
  // at rows 2 tig (c0, c2) and 2 tig + 1 (c1, c3)
  __syncthreads();  // every warp is done with the x pairs
#pragma unroll
  for (int i = 0; i < Codec::kCols / 2; ++i) {
    const int c = Codec::kCols * gid + 2 * i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * tig + h;
      if (r < tg) {
        red[(warp * tg + r) * kCols + c] = acc[i][h];
        red[(warp * tg + r) * kCols + c + 1] = acc[i][2 + h];
      }
    }
  }
  __syncthreads();
  if (gridDim.y == 1) {  // the whole of n: the warps' sum is the output
    for (int e = threadIdx.x; e < tg * kCols; e += kGemvThreads) {
      const int r = e / kCols, c = e % kCols;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kGemvWarps; ++w) s += red[(w * tg + r) * kCols + c];
      if (tile0 + c < d) out[(size_t)r * d + tile0 + c] = s;
    }
    return;
  }
  // a split of n: the warps' sum to this split's slot; the tile's last
  // split to finish adds every split's sum in split order and resets the
  // tile's count for the next launch
  const size_t slot = (size_t)tg * kCols;
  float* mine = part + (blockIdx.y * (size_t)gridDim.x + blockIdx.x) * slot;
  for (int e = threadIdx.x; e < tg * kCols; e += kGemvThreads) {
    const int r = e / kCols, c = e % kCols;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) s += red[(w * tg + r) * kCols + c];
    mine[e] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < tg * kCols; e += kGemvThreads) {
    const int c = e % kCols;
    float s = 0.f;
    for (unsigned q = 0; q < gridDim.y; ++q)
      s += __ldcg(part + (q * (size_t)gridDim.x + blockIdx.x) * slot + e);
    if (tile0 + c < d) out[(size_t)(e / kCols) * d + tile0 + c] = s;
  }
  if (threadIdx.x == 0) count[blockIdx.x] = 0;
}

// Launch the body: grid (ceil(d / kCols), splits) for one row group of
// t <= kGemvRows rows (ops/q40.py gemv_plan: kb_per quantization blocks a
// split).  Returns the launch's error.
template <class Codec, class Layout, int VW>
cudaError_t launch_gemv_vw(const void* x, const void* vals, const void* scales, void* out,
                           const void* idx, void* part, void* count, int t, int n, int np,
                           int d, int n_planes, int splits, int kb_per, Layout lay,
                           cudaStream_t stream) {
  if (t < 1 || t > kGemvRows || splits < 1) return cudaErrorInvalidValue;
  constexpr int kCols = Codec::kCols * 8;
  const dim3 grid((d + kCols - 1) / kCols, splits);
  gemv_kernel<Codec, Layout, VW><<<grid, kGemvThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(vals),
      static_cast<const __half*>(scales), static_cast<const int*>(idx), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int*>(count), t, n, np, d, n_planes, kb_per, lay);
  return cudaGetLastError();
}

// The load width vw (bytes of a value piece: Codec::kCols, 8, 4 or 1, which
// divides the row stride and the pointers; ops/q40.py _gemv_width) picks the
// instantiation.  Returns cudaGetLastError() after the launch.
template <class Codec, class Layout>
int launch_gemv(const void* x, const void* vals, const void* scales, void* out, const void* idx,
                void* part, void* count, int t, int n, int np, int d, int n_planes, int splits,
                int kb_per, int vw, Layout lay, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (vw) {
    case 16:
      if constexpr (Codec::kCols >= 16) {
        e = launch_gemv_vw<Codec, Layout, 16>(x, vals, scales, out, idx, part, count, t, n, np,
                                              d, n_planes, splits, kb_per, lay, s);
        break;
      }
      return (int)cudaErrorInvalidValue;
    case 8:
      e = launch_gemv_vw<Codec, Layout, 8>(x, vals, scales, out, idx, part, count, t, n, np, d,
                                           n_planes, splits, kb_per, lay, s);
      break;
    case 4:
      e = launch_gemv_vw<Codec, Layout, 4>(x, vals, scales, out, idx, part, count, t, n, np, d,
                                           n_planes, splits, kb_per, lay, s);
      break;
    case 1:
      e = launch_gemv_vw<Codec, Layout, 1>(x, vals, scales, out, idx, part, count, t, n, np, d,
                                           n_planes, splits, kb_per, lay, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // namespace
