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
#include <string.h>

#include <type_traits>

#include "gemv_common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

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
// route, mma_plan), in both layouts; the Hopper machinery is
// sm90_common.cuh's.  It dequantizes a weight once per BM rows of x (the
// decode body once per 8), so at the main path's widths (prefill chunks,
// the 8-slot mixed step's 128 rows, the scoring forward's 4096) it is
// bound by the tensor cores' operations, not by the 0.5625 bytes a weight.
// The design:
//  * A block owns 128 output columns by BM rows of x (BM 32 or 128:
//    ops/q40.py mma_plan) and walks its share of n in steps of 64 logical
//    rows (two quantization blocks, 32 packed rows).  Partial sums of the
//    split-K go to f32 scratch (splits, t, d) and add in a fixed order
//    (q40_reduce_splits): results repeat bit for bit.
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
//    step's 32 x 128 packed bytes (one 16-row TMA box a quantization block,
//    128-byte swizzled so that the consumers' reads of one column pair from
//    four rows meet no bank conflict) and its two 128-wide f16 scale rows,
//    from maps over the planes seen as rows of their stored stride (d, or
//    kernel 3's td; the plane index is read on the card).  Where TMA cannot
//    take the weights (a row stride or a pointer off 16 bytes, a blocked
//    td that 128 does not divide) the producer warp copies them with
//    cp.async (or plain loads) addressed through the Layout cursor, into
//    the same swizzled places, and the stage barrier tracks the copies.
//  * A consumer thread (lane g·4 + q of warp w of warpgroup wg) owns output
//    columns c, c + 1 (c = 64 wg + 16 w + 2 g): the A fragment's rows g and
//    g + 8.  Its A registers of a k16 step hold logical rows 2q, 2q + 1,
//    2q + 8, 2q + 9 of the step's k16 slice; in Q40's storage those are the
//    low nibbles (first k16 of a block) or the high nibbles (second) of
//    packed rows 2q, 2q+1, 2q+8, 2q+9 of the block: two bytes a row, one
//    16-bit load.  Each weight is bf16(f32(nib - 8) * f32(s)) rounded to
//    nearest even (one LOP3 and one FFMA, the decode body's exact trick),
//    the decode body's numerics; blocks past n are zero.  The warpgroup
//    unpacks step s+1's registers (a second buffer) after issuing step s's
//    wgmma (commit, then wait_group 1): no barrier between the warpgroups.
//    Measured on an H100, the unpacking does not overlap the products in
//    flight: a step costs their sum (PERF.md).
//  * folded adds -8 bf16(bs) bf16(s) a block into a second register set
//    (wgmma owns the accumulators while a product is in flight), added at
//    the end; exact keeps a second set p for each block's products (scale-d
//    0 at the block's first k16), waits for them and folds (p - 8 bs) s
//    into the accumulators; both take the block sums bs of x from shared
//    memory, summed once a step by all consumer threads (then one named
//    barrier a step).  (q40_matmul.cu's top: the variants.)
// Both layouts take the same plan on the logical d and add the same
// products in the same order, so kernel 3 equals kernels 1-2 bit for bit;
// products of bf16 values are exact in f32, so the result differs from the
// decode body's only in the order of the f32 sums.

constexpr int kWgBN = 128;                     // output columns a block: ops/q40.py MMA_BN
constexpr int kWgBK = 64;                      // rows of n a step: ops/q40.py MMA_BK
constexpr int kWgConsumers = 256;              // two consumer warpgroups
constexpr int kWgThreads = kWgConsumers + 32;  // and the producer warp
constexpr int kWgVals = kWgBK / 2 * kWgBN;     // packed bytes a step: 32 rows x 128
constexpr int kWgScales = 2 * kWgBN * 2;       // two f16 scale rows

// The block's shared memory (from a 1024-byte-aligned base): the ring's x
// tiles, packed tiles and scale rows, three buffers of a step's block sums
// (folded, exact), then the full and empty barriers; kStages ring stages
// (a stage's copies take about a microsecond to land, so the ring runs
// several steps ahead), kAcc accumulators a thread.
template <int BM>
struct WgShape {
  static constexpr int kStages = 8;  // ops/q40.py MMA_STAGES
  static constexpr int kAcc = BM / 2;
  static constexpr int kX = BM * kWgBK * 2;
  static constexpr int kVOff = kStages * kX;
  static constexpr int kSOff = kVOff + kStages * kWgVals;
  static constexpr int kBsOff = kSOff + kStages * kWgScales;
  static constexpr int kBarOff = kBsOff + 3 * 2 * BM * 4;
  static constexpr int kSmem = kBarOff + 16 * kStages + 1024;
  static_assert(kSmem <= kMaxSmem, "the tensor-core body exceeds the opt-in shared memory");
};

// Byte of packed row r, column c in a step's swizzled packed tile (TMA's
// 128-byte swizzle: the 16-byte chunk XORed with the row's low three bits;
// a block's 16 rows start 2048 bytes apart, on 1024)
__device__ __forceinline__ int vsw(int r, int c) {
  return r * kWgBN + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// The A registers of a block's two k16 slices: `v` the raw bytes of packed
// rows 2q and 2q+1 (bytes 0, 1: columns c, c+1 of row 2q; bytes 2, 3: of
// row 2q+1), `w` those of rows 2q+8, 2q+9; s0, s1 the two columns' scales.
// A register holds (k, k+1) of one column: reg 0 column c at k = 2q, 2q+1;
// reg 1 column c+1 there; regs 2, 3 the same at k = 2q+8, 2q+9; lo the
// slice of the low nibbles (the block's first 16 rows), hi the high.
// classic: each weight is one LOP3 and one FFMA before its bf16 round (the
// decode body's exact trick, gemv_common.cuh field_f32: the nibble ORed
// at mantissa bit p into the exponent of 2^(23-p) is 2^(23-p) + nib, and
// fma(2^(23-p) + nib, s, -(2^(23-p) + 8) s) = (nib - 8) s exactly for p in
// 8, 12, 16); folded, exact: two weights a bf16x2 FMA (NibScale).
template <int V>
__device__ __forceinline__ void a_frags(uint32_t (&lo)[4], uint32_t (&hi)[4], uint32_t v,
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

// The producer warp's copies of a step's weights where TMA cannot take
// them: 32 packed rows of 128 bytes in pieces of N (16, 8, 4; 1 = plain
// byte loads) into their swizzled places in `vals`, and two scale rows in
// pieces of SN bytes (16, 8, 4; 2 = plain loads) into `scs`; row r of the
// step lives at qp + v[r >> 4] + (r & 15) * stride (scales: sc + s[r]),
// column c of the tile at lay.vcol / lay.scol(col0 + c).  Columns at or
// past vc (the plane's stored width) and blocks at or past n_blk are zero.
template <int N, class Layout>
__device__ __forceinline__ void copy_vals(unsigned char* vals, const uint8_t* qp,
                                          const size_t* v, const Layout& lay, int col0, int vc,
                                          int n_blk, int lane) {
  constexpr int kPer = kWgBN / N;
  for (int e = lane; e < 32 * kPer; e += 32) {
    const int r = e / kPer, c = (e % kPer) * N;
    const bool ok = c + N <= vc && (r >> 4) < n_blk;
    const uint8_t* src =
        ok ? qp + v[r >> 4] + lay.vcol(col0 + c) + (size_t)(r & 15) * lay.stride() : qp;
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

// The TMA coordinates of a step's two quantization blocks: the stored row
// (of the plane's rows of `stride`) of each block's first packed row and
// of its scale row in column tile `ct` (kernel 3's c / td; 0 row-major),
// moving the cursor on as step_rows does; no division.
__device__ __forceinline__ void tma_rows(const RowMajor&, RowMajor::Cursor& c, int, int* v,
                                         int* s) {
  v[0] = (int)c.b * 16;
  v[1] = v[0] + 16;
  s[0] = (int)c.b;
  s[1] = s[0] + 1;
  c.b += 2;
}

__device__ __forceinline__ void tma_rows(const Blocked& l, Blocked::Cursor& c, int ct, int* v,
                                         int* s) {
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
  if constexpr (BM == 32)
    wgmma_rs_kmaj_n32(d, a, b, acc);
  else
    wgmma_rs_kmaj_n128(d, a, b, acc);
}

template <int BM, class Layout, int V>
__global__ void __launch_bounds__(kWgThreads, 1)
q40_matmul_wgmma(const __grid_constant__ CUtensorMap map_x,  // x (t, n) bf16, boxes 64 x BM
                 const __grid_constant__ CUtensorMap map_v,  // values as rows of stride bytes
                 const __grid_constant__ CUtensorMap map_s,  // scales as rows of stride f16
                 const uint8_t* __restrict__ qpacked, const __half* __restrict__ scales,
                 const int* __restrict__ plane_p, float* __restrict__ part, int t, int n,
                 int np, int d, int n_planes, int steps_per, int tma, int w_al, int s_al,
                 Layout lay) {
  using S = WgShape<BM>;
  constexpr bool kSums = V == kFolded || V == kExact;
  static_assert(V == kClassic || kSums, "fma runs the classic body");
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
    const int per_row = lay.cols() / stride;  // stored rows a packed row: nJ blocked, 1
    const uint8_t* qp = qpacked + (size_t)plane * (size_t)(np / 2) * (size_t)lay.cols();
    const __half* sc = scales + (size_t)plane * (size_t)(np / 32) * (size_t)lay.cols();
    const int vrow0 = plane * (np / 2) * per_row, srow0 = plane * (np / 32) * per_row;
    const int vc = min(kWgBN, lay.cols() - col0);  // stored columns of the tile
    const int ctile = col0 / stride, ccol = col0 - ctile * stride;  // the box's column
    auto cur = lay.cursor((unsigned)s_begin * 2);
    const int tx = S::kX + (tma ? kWgVals + kWgScales : 0);
    for (int i = 0; i < n_mine; ++i) {
      const int s = i % S::kStages;
      const uint32_t full = full0 + 8 * s;
      const int k0 = (s_begin + i) * kWgBK;
      size_t v[2], sr[2];
      int vr[2], srr[2];
      if (tma)
        tma_rows(lay, cur, ctile, vr, srr);
      else
        lay.step_rows(cur, v, sr);
      if (i >= S::kStages) bar_wait(empty0 + 8 * s, (i / S::kStages - 1) & 1);
      unsigned char* vals = base + S::kVOff + s * kWgVals;
      unsigned char* scs = base + S::kSOff + s * kWgScales;
      if (!tma) {
        const int n_blk = nb - k0 / 32;
        switch (w_al) {
          case 16: copy_vals<16>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          case 8: copy_vals<8>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          case 4: copy_vals<4>(vals, qp, v, lay, col0, vc, n_blk, lane); break;
          default: copy_vals<1>(vals, qp, v, lay, col0, vc, n_blk, lane);
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
          // a block's 16 packed rows and its scale row
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            tma_2d(smem_u32(vals + b * 16 * kWgBN), &map_v, ccol, vrow0 + vr[b], full);
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

  // step i's A registers (a[kk], kk the k16 slice: block kk / 2, the low
  // nibbles at even kk) from its stage
  auto dequant = [&](int i, uint32_t (&a)[4][4]) {
    const int s = i % S::kStages;
    const unsigned char* vals = base + S::kVOff + s * kWgVals;
    const unsigned char* scs = base + S::kSOff + s * kWgScales;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if ((s_begin + i) * 2 + b >= nb) {  // a block past n holds no weights
#pragma unroll
        for (int e = 0; e < 4; ++e) a[2 * b][e] = a[2 * b + 1][e] = 0u;
        continue;
      }
      const unsigned char* vb = vals + b * 16 * kWgBN;
      const uint32_t r0 = *reinterpret_cast<const uint16_t*>(vb + vsw(2 * q, c));
      const uint32_t r1 = *reinterpret_cast<const uint16_t*>(vb + vsw(2 * q + 1, c));
      const uint32_t r8 = *reinterpret_cast<const uint16_t*>(vb + vsw(2 * q + 8, c));
      const uint32_t r9 = *reinterpret_cast<const uint16_t*>(vb + vsw(2 * q + 9, c));
      const uint32_t v = r0 | r1 << 16, w = r8 | r9 << 16;
      const uint32_t sr = *reinterpret_cast<const uint32_t*>(scs + b * 2 * kWgBN + c * 2);
      a_frags<V>(a[2 * b], a[2 * b + 1], v, w, f16_bits(sr & 0xFFFFu), f16_bits(sr >> 16));
    }
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
template <int BM, class Layout, int V>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
                         const int* idx, float* part, int t, int n, int np, int d, int n_planes,
                         int splits, int steps_per, int tma, int w_al, int s_al, Layout lay,
                         int stride, int per_row, cudaStream_t stream) {
  using S = WgShape<BM>;
  CUtensorMap mx, mv, ms;
  cudaError_t e = encode_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, n, t, 2ull * n, kWgBK, BM,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  memset(&mv, 0, sizeof(mv));
  memset(&ms, 0, sizeof(ms));
  if (tma) {
    const unsigned long long rows = (unsigned long long)n_planes * (np / 2) * per_row;
    e = cached_map_2d(&mv, CU_TENSOR_MAP_DATA_TYPE_UINT8, qp, stride, rows, stride, kWgBN, 16,
                      CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == cudaSuccess)
      e = cached_map_2d(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, sc, stride,
                        (unsigned long long)n_planes * (np / 32) * per_row, 2ull * stride, kWgBN,
                        1, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e != cudaSuccess) return e;
  }
  auto kern = q40_matmul_wgmma<BM, Layout, V>;
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

// Both tensor-core entry points: the tile height by bm, then the
// fixed-order reduce of the splits.  `stride` is the bytes between two
// stored rows (d, or kernel 3's td), `per_row` the stored rows of a packed
// row (1, or kernel 3's nJ column tiles).
template <class Layout, int V>
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
    case 32:
      e = launch_wgmma<32, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits,
                                      steps_per, tma, w_al, s_al, lay, stride, per_row, s);
      break;
    case 128:
      e = launch_wgmma<128, Layout, V>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits,
                                       steps_per, tma, w_al, s_al, lay, stride, per_row, s);
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

template <int BM>
void wg_layout(int* out) {
  out[0] = kWgThreads;
  out[1] = WgShape<BM>::kSmem;
  out[2] = WgShape<BM>::kStages;
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
// aligned); qpacked, scales, idx and out as q40_matmul; bm 32 or 128; the
// reduction over n cut into `splits` ranges of
// `steps_per` 64-row steps (ops/q40.py mma_plan), scratch (splits, t, d)
// f32 when splits > 1; tma 1 when the planes' rows and pointers are
// 16-byte aligned (the weights by TMA), else 0 and w_al / s_al the widest
// copy (16, 8, 4, or 0 for plain loads) that the value / scale rows
// allow; variant as q40_matmul's.
extern "C" int q40_matmul_mma(const void* x, const void* qpacked, const void* scales,
                              void* out, void* scratch, const void* idx, int t, int n,
                              int np, int d, int n_planes, int bm, int splits, int steps_per,
                              int tma, int w_al, int s_al, int variant, void* stream) {
  const RowMajor lay{d};
  switch (variant) {
    case kClassic:
    case kFma:
      return run_wgmma<RowMajor, kClassic>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                           n_planes, bm, splits, steps_per, tma, w_al, s_al,
                                           lay, d, 1, stream);
    case kFolded:
      return run_wgmma<RowMajor, kFolded>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                          n_planes, bm, splits, steps_per, tma, w_al, s_al,
                                          lay, d, 1, stream);
    case kExact:
      return run_wgmma<RowMajor, kExact>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                         n_planes, bm, splits, steps_per, tma, w_al, s_al, lay,
                                         d, 1, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core body of kernel 3: operands as q40_matmul_blocked, the
// plan as q40_matmul_mma's on the logical d; tma 1 when td, its pointers
// and the 128-column tile allow TMA boxes (td % 128 == 0), else the copy
// widths w_al / s_al that divide td / 2*td (never 0: td % 4 == 0).
extern "C" int q40_matmul_blocked_mma(const void* x, const void* qpacked, const void* scales,
                                      void* out, void* scratch, const void* idx, int t, int n,
                                      int np, int d, int n_planes, int bm, int splits,
                                      int steps_per, int tma, int w_al, int s_al, int bn, int td,
                                      int nJ, void* stream) {
  return run_wgmma<Blocked, kClassic>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                      n_planes, bm, splits, steps_per, tma, w_al, s_al,
                                      Blocked{bn, td, nJ}, td, nJ, stream);
}

// The tensor-core body's block at tile height bm (ops/q40.py MMA_SMEM,
// MMA_STAGES hold the same numbers): out[0] threads, out[1] dynamic shared
// memory in bytes, out[2] ring stages.  Launches nothing.
extern "C" int q40_mma_layout(int bm, int* out) {
  switch (bm) {
    case 32: wg_layout<32>(out); return 0;
    case 128: wg_layout<128>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* q40_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
