// Q40 dequant-matmul for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces: the Pallas kernels of dllama_tpu/ops/q40.py — _q40_kernel
// (entered through _pallas_matmul, the 2-D wcls head), _stacked_q40_kernel
// (entered through _pallas_matmul_stacked, the layer-stacked
// wqkv/wo/w13/w2) and, through the q40_matmul_blocked entry (kernel 3),
// _stacked_q40_kernel over tile-contiguous planes (entered through
// _pallas_matmul_blocked, DLLAMA_Q40_LAYOUT=blocked); "classic" variant:
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,   W[k, j] = bf16(f32(nib(k, j) - 8) * f32(s[k/32, j]))
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
// 16 packed rows never straddle a tile (bn % 16 == 0) and a thread's 4
// columns never do (td % 4 == 0), so the two layouts differ only in where
// a block's rows start and in their stride (d or td): the kernel body is
// one template over a Layout, and with the same split plan both layouts
// add the same products in the same order, bit for bit.  On the TPU the
// tiles lengthened the HBM DMA bursts; here a warp already reads 128
// contiguous bytes a row in the row-major layout, so kernel 3 is expected
// to time like kernels 1-2.
//
// What bounds it on this card: at decode (t = 1) each weight is read once
// and used once, so the kernel is bound by the bytes of the packed planes,
// 0.5625 B/weight (0.5 nibble + 0.0625 scale), against 3.35 TB/s of HBM on
// an H100 SXM: 3.74 GB per Llama-2-7B token, a floor of about 1.1 ms.
//
// Two bodies share the storage and the entry points' operands: the GEMV
// body below for calls of t < T_MMA rows (decode), and the tensor-core body
// after it for t >= T_MMA (prefill chunks, mixed steps, lockstep batches;
// ops/q40.py route).  What the GEMV body does about the byte bound:
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
// wgmma and TMA are left to later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

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

// Where a quantization block's packed rows and scales live.  val(b, c) is
// the offset of packed row 16b at column c within a plane, scale(b, c) that
// of block b's scale; consecutive packed rows of a block are stride() bytes
// apart; cols() is a plane's stored width (d, or dp when blocked).
struct RowMajor {
  int d;
  __device__ size_t val(size_t b, int c) const { return b * 16 * d + c; }
  __device__ size_t scale(size_t b, int c) const { return b * d + c; }
  __device__ int stride() const { return d; }
  __device__ int cols() const { return d; }
  // the vector loads need 4 columns inside the row
  __device__ bool vec(int col0) const { return (d % kCols == 0) && (col0 + kCols <= d); }
  // the tensor-core body's addressing: val and scale as a part of the step
  // (blocks b and b + 1: v, s) plus a part of the column (vcol, scol).  The
  // body walks its steps in order; a Cursor holds the step's first block,
  // and step_rows moves it on to the next step's
  struct Cursor {
    unsigned b;
  };
  __device__ Cursor cursor(unsigned b0) const { return {b0}; }
  __device__ void step_rows(Cursor& c, size_t* v, size_t* s) const {
    v[0] = (size_t)c.b * 16 * d;
    v[1] = v[0] + (size_t)16 * d;
    s[0] = (size_t)c.b * d;
    s[1] = s[0] + d;
    c.b += 2;
  }
  __device__ size_t vcol(int c) const { return c; }
  __device__ size_t scol(int c) const { return c; }
};

struct Blocked {
  int bn, td, nJ;  // packed rows a tile (a multiple of 16), columns a tile, column tiles
  __device__ size_t val(size_t b, int c) const {
    const size_t r = b * 16;
    return ((r / bn) * nJ + c / td) * (size_t)bn * td + (r % bn) * td + c % td;
  }
  __device__ size_t scale(size_t b, int c) const {
    const size_t bb = bn / 16;  // quantization blocks a tile
    return ((b / bb) * nJ + c / td) * bb * td + (b % bb) * td + c % td;
  }
  __device__ int stride() const { return td; }
  __device__ int cols() const { return nJ * td; }
  // td % 4 == 0 and the pad columns exist: 4 columns from col0 < d always lie
  // in one tile
  __device__ bool vec(int) const { return true; }
  // the tensor-core body's addressing, as RowMajor's, with no division
  // after the first step: the Cursor holds the row tile q and the packed row
  // rem within it of the step's first block, and a block either follows
  // the one before in its row tile or opens the next (bn % 16 == 0)
  struct Cursor {
    unsigned q, rem;
  };
  __device__ Cursor cursor(unsigned b0) const {
    return {b0 * 16 / bn, b0 * 16 % bn};
  }
  __device__ void next_block(unsigned& q, unsigned& rem) const {
    rem += 16;
    if (rem == (unsigned)bn) {
      rem = 0;
      ++q;
    }
  }
  __device__ void step_rows(Cursor& c, size_t* v, size_t* s) const {
    unsigned q1 = c.q, rem1 = c.rem;
    next_block(q1, rem1);
    v[0] = ((size_t)c.q * nJ * bn + c.rem) * td;
    v[1] = ((size_t)q1 * nJ * bn + rem1) * td;
    s[0] = ((size_t)c.q * nJ * (bn / 16) + c.rem / 16) * td;
    s[1] = ((size_t)q1 * nJ * (bn / 16) + rem1 / 16) * td;
    next_block(q1, rem1);
    c = {q1, rem1};
  }
  __device__ size_t vcol(int c) const { return (size_t)(c / td) * bn * td + c % td; }
  __device__ size_t scol(int c) const { return (size_t)(c / td) * (bn / 16) * td + c % td; }
};

template <int TG, class Layout>
__global__ void __launch_bounds__(kThreads)
q40_matmul_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n)
                  const uint8_t* __restrict__ qpacked,    // n_planes planes
                  const __half* __restrict__ scales,      // n_planes planes
                  const int* __restrict__ plane_p,        // the plane to read
                  float* __restrict__ part,               // (splits, t, d)
                  int t, int n, int np, int d, int n_planes, int kb_per,
                  Layout lay) {
  __shared__ float xs[TG][kChunk * 32];
  // the plane index lives in device memory (a layer, or layer*E + expert
  // chosen on the device); clamping keeps a bad value inside the planes
  const size_t plane = (size_t)min(max(*plane_p, 0), n_planes - 1);
  const uint8_t* qp = qpacked + plane * (size_t)(np / 2) * (size_t)lay.cols();
  const __half* sc = scales + plane * (size_t)(np / 32) * (size_t)lay.cols();
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int nb = n / 32;
  const int kb_begin = blockIdx.y * kb_per;
  const int kb_end = min(nb, kb_begin + kb_per);
  const bool vec = lay.vec(col0);
  const int stride = lay.stride();
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
          const uint2 raw = __ldg(reinterpret_cast<const uint2*>(sc + lay.scale(b, col0)));
          s[0] = __half2float(__ushort_as_half((unsigned short)(raw.x & 0xFFFFu)));
          s[1] = __half2float(__ushort_as_half((unsigned short)(raw.x >> 16)));
          s[2] = __half2float(__ushort_as_half((unsigned short)(raw.y & 0xFFFFu)));
          s[3] = __half2float(__ushort_as_half((unsigned short)(raw.y >> 16)));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            s[c] = col0 + c < d ? __half2float(sc[lay.scale(b, col0) + c]) : 0.f;
        }
        // all 16 packed rows of the block are loaded before any is used,
        // so each thread keeps 16 independent loads in flight
        const uint8_t* rowp = qp + lay.val(b, col0);
        uint32_t w4[16];
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          if (vec) {
            w4[r] = __ldg(reinterpret_cast<const unsigned int*>(rowp + (size_t)r * stride));
          } else {
            w4[r] = 0x88888888u;  // nibbles of 8: weight 0 in the masked columns
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              if (col0 + c < d)
                w4[r] = (w4[r] & ~(0xFFu << (8 * c))) |
                        ((uint32_t)rowp[(size_t)r * stride + c] << (8 * c));
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

template <int TG, class Layout>
void launch(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
            const int* idx, float* part, int t, int n, int np, int d,
            int n_planes, int splits, int kb_per, Layout lay, cudaStream_t stream) {
  const dim3 grid((d + kBlockCols - 1) / kBlockCols, splits);
  q40_matmul_kernel<TG, Layout><<<grid, kThreads, 0, stream>>>(
      x, qp, sc, idx, part, t, n, np, d, n_planes, kb_per, lay);
}

// Both entry points: the row-group template by t, then the fixed-order
// reduce of the splits.  Returns cudaGetLastError() after the launches.
template <class Layout>
int run(const void* x, const void* qpacked, const void* scales, void* out,
        void* scratch, const void* idx, int t, int n, int np, int d,
        int n_planes, int splits, int kb_per, Layout lay, void* stream) {
  const uint8_t* qp = static_cast<const uint8_t*>(qpacked);
  const __half* sc = static_cast<const __half*>(scales);
  const int* ip = static_cast<const int*>(idx);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* part = static_cast<float*>(splits > 1 ? scratch : out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t == 1)
    launch<1>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, lay, s);
  else if (t == 2)
    launch<2>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, lay, s);
  else if (t <= 4)
    launch<4>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, lay, s);
  else
    launch<8>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, kb_per, lay, s);
  if (splits > 1) {
    const size_t total = (size_t)t * (size_t)d;
    q40_reduce_splits<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        part, static_cast<float*>(out), splits, total);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core body, for t >= T_MMA rows (python: ops/q40.py T_MMA,
// route), in both layouts: the Q80 kernel's tensor-core body (q8_matmul.cu
// q8_matmul_mma_kernel, its machinery in mma_common.cuh) with a Q40 weight
// tile.  The GEMV body above dequantizes every weight once a group of up to
// 8 rows of x, on the FP32 FMAs; this body dequantizes it once per BM rows
// and multiplies on the tensor cores:
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

template <int BM, class Layout>
__global__ void __launch_bounds__(MmaShape<BM>::Threads, MmaShape<BM>::MinBlocks)
q40_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,   // (t, n)
                      const uint8_t* __restrict__ qpacked,    // n_planes planes
                      const __half* __restrict__ scales,      // n_planes planes
                      const int* __restrict__ plane_p,        // the plane to read
                      float* __restrict__ part,               // (splits, t, d)
                      int t, int n, int np, int d, int n_planes, int steps_per, int w_al,
                      int s_al, Layout lay) {
  using S = MmaShape<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = q4_stage_bytes<BM>();
  // packed rows a thread unpacks a step: 4 (256 threads) or 2, in one block
  constexpr int kPk = kMmaBK / 2 * 32 / S::Threads;
  __nv_bfloat16* wbs = reinterpret_cast<__nv_bfloat16*>(smem + kQ4Stages * kStage);

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
#pragma unroll
    for (int r = 0; r < kPk; ++r) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(st + (r0 + r) * kMmaBN + cg * 4);
      const int lo = 32 * blk + ((r0 + r) & 15);  // logical row of the low nibbles
      store_w4(wb + lo * kWS + cg * 4, u & 0x0F0F0F0Fu, s0, s1, s2, s3);
      store_w4(wb + (lo + 16) * kWS + cg * 4, (u >> 4) & 0x0F0F0F0Fu, s0, s1, s2, s3);
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

    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
        smem + (it % kQ4Stages) * kStage + kQ4Tile + kQ4Scales);
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

template <int BM, class Layout>
cudaError_t launch_mma(const __nv_bfloat16* x, const uint8_t* qp, const __half* sc,
                       const int* idx, float* part, int t, int n, int np, int d,
                       int n_planes, int splits, int steps_per, int w_al, int s_al, Layout lay,
                       cudaStream_t stream) {
  auto kern = q40_matmul_mma_kernel<BM, Layout>;
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
  kern<<<grid, MmaShape<BM>::Threads, q4_smem_bytes<BM>(), stream>>>(
      x, qp, sc, idx, part, t, n, np, d, n_planes, steps_per, w_al, s_al, lay);
  return cudaGetLastError();
}

// Both tensor-core entry points: the tile height by bm, then the
// fixed-order reduce of the splits.
template <class Layout>
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
      e = launch_mma<16>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 32:
      e = launch_mma<32>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 64:
      e = launch_mma<64>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
                         s_al, lay, s);
      break;
    case 128:
      e = launch_mma<128>(xb, qp, sc, ip, part, t, n, np, d, n_planes, splits, steps_per, w_al,
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

// x (t, n) bf16; qpacked (n_planes, np/2, d) u8 (any leading dims,
// flattened); scales (n_planes, np/32, d) f16; idx one int32 in device
// memory, the plane to read (clamped to 0..n_planes-1); out (t, d) f32;
// scratch (splits, t, d) f32 when splits > 1.  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int q40_matmul(const void* x, const void* qpacked,
                          const void* scales, void* out, void* scratch,
                          const void* idx, int t, int n, int np, int d,
                          int n_planes, int splits, int kb_per, void* stream) {
  return run(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes,
             splits, kb_per, RowMajor{d}, stream);
}

// Kernel 3: the same product over blocked planes, qpacked (n_planes, np/2/bn,
// nJ, bn, td) u8 and scales (n_planes, np/2/bn, nJ, bn/16, td) f16, with
// bn % 16 == 0 and td % 4 == 0; writes the (t, d) logical columns only.
extern "C" int q40_matmul_blocked(const void* x, const void* qpacked,
                                  const void* scales, void* out, void* scratch,
                                  const void* idx, int t, int n, int np, int d,
                                  int n_planes, int splits, int kb_per, int bn,
                                  int td, int nJ, void* stream) {
  return run(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes,
             splits, kb_per, Blocked{bn, td, nJ}, stream);
}

// The tensor-core body (t >= T_MMA) of kernels 1-2: x (t, n) bf16 (16-byte
// aligned); qpacked, scales, idx and out as q40_matmul; bm in 16, 32, 64,
// 128; the reduction over n cut into `splits` ranges of `steps_per` 64-row
// steps (ops/q40.py mma_plan), scratch (splits, t, d) f32 when splits > 1;
// w_al / s_al the widest copy (16, 8, 4, or 0 for plain loads) that the
// value / scale rows allow.
extern "C" int q40_matmul_mma(const void* x, const void* qpacked, const void* scales,
                              void* out, void* scratch, const void* idx, int t, int n,
                              int np, int d, int n_planes, int bm, int splits, int steps_per,
                              int w_al, int s_al, void* stream) {
  return run_mma(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes, bm, splits,
                 steps_per, w_al, s_al, RowMajor{d}, stream);
}

// The tensor-core body of kernel 3: operands as q40_matmul_blocked, the
// plan as q40_matmul_mma's on the logical d; w_al / s_al copy widths that
// divide td / 2*td (never 0: td % 4 == 0).
extern "C" int q40_matmul_blocked_mma(const void* x, const void* qpacked, const void* scales,
                                      void* out, void* scratch, const void* idx, int t, int n,
                                      int np, int d, int n_planes, int bm, int splits,
                                      int steps_per, int w_al, int s_al, int bn, int td,
                                      int nJ, void* stream) {
  return run_mma(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes, bm, splits,
                 steps_per, w_al, s_al, Blocked{bn, td, nJ}, stream);
}

extern "C" const char* q40_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
