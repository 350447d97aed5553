// The prefill attention kernel (kernel 8) for Hopper: its design, device
// code and launch helpers, included by the translation units that
// instantiate the pools' bodies (paged_prefill_attention.cu: the entry
// points and bf16; paged_prefill_f32.cu, _f16.cu, _int8.cu).
//
// Causal GQA over the paged KV pool for t > 1 query rows (the mixed
// prefill slot step), for Hopper (sm_90a).
//
// The port's own kernel: it has no Pallas counterpart.  It computes what
// the JAX package leaves to XLA at dllama_tpu/ops/attention.py:106
// _rows_ceiling_attention over the view that paged_gather_layer (:218)
// gathers, but reads the pages in place.  q (B, Hq, T, Dh) against a paged
// pool (L, P, Hkv, ps, Dh) through a page table (B, maxp) int32, at per-row
// positions (B,) int32 and a layer index, all three read from device
// memory (the launch needs no host value, so a captured CUDA graph can
// replay it).  The pool is bf16, f16, int8 with a per-position f32 scale
// plane (L, P, Hkv, ps, 1), or f32; Dh is any multiple of 16 up to 256 (the
// f32 body: of 4).  Query token i of row b sees keys at positions <=
// pos_rows[b] + i.
//
// Numerics follow the plain version: q and the keys are operands of the
// pool's type (int8 values dequantize as bf16(f32(v) * scale), kernel 7's
// rule), the scores accumulate in f32, masked keys take the score -1e30,
// the softmax is f32, the probabilities round to the operand type before
// the PV product, whose sums are f32, and the output is acc / max(l,
// 1e-38) in the output's type (q's: f32, bf16 or f16).  Two differences:
// the softmax is online, so a bf16, f16 or int8 pool's probabilities round
// at exp(s - m) for a running max m, not the global one (the plain version
// rounds the normalized ones); and the scores are scaled once by log2(e) / sqrt(Dh) and
// exponentiated in base 2 (exp2f), where the plain version divides by
// sqrt(Dh) and calls exp: a few f32 ulps of each probability.  An f32
// pool differs only by those ulps and the order of its f32 sums.  Keys a
// row's table maps to scratch page 0 are read as the plain version reads
// them.
//
// Bound: bytes at the serving path's shapes.  A block reads each live K/V
// byte of its (row, kv head) once and does 4·G·T flops on each element:
// even with the query rows padded to 64 (a warpgroup's tile) that is 128
// flops a bf16 byte, under the card's ~295.  The design:
//  * Grid (Hkv, B, groups · splits).  A block takes up to 128 of its
//    (row, kv head)'s G·T query rows, 64 above a padded Dh of 128 (a row
//    group, rows_a_group; wider steps have more
//    groups, each walking keys only up to its own last visible position)
//    and split s of the row's pages (ops/attention.py prefill_plan: from
//    the table length and G·T, so that the f32 partials of full tables stay
//    near a tenth of their K/V bytes).  A split past the group's live pages
//    returns at once; a group with one live split writes the output itself.
//    The groups run as a grid dimension, not a loop, so that they run side
//    by side and a second group's read of a page mostly hits L2.
//  * Keys arrive in tiles of 64 positions: 64/br segments of br rows (br
//    the power of two from 8 to 64 that covers a page, so a tile is several
//    whole pages or a 64-row slice of one), each one TMA box a 64-wide slab
//    of Dh, of a tensor map over the pool seen as rows of Dh (built once per
//    pool pointer on the host, passed __grid_constant__; 128-byte
//    swizzle).  Rows a box reads past its page (the rest of a short page's
//    segment, the tail of a walk) are masked; past the pool's end TMA reads
//    zeros.  A whole tile is always read, so every stage expects the same
//    bytes.
//  * Head dims: the tensor-core body works at DHP, Dh rounded up to whole
//    64-column slabs (64, 128, 192, 256; a template parameter, Dh a runtime
//    one).  The last slab's box runs past Dh, where the tensor map ends and
//    TMA writes zeros (int8: the loader zeroes those columns of its
//    dequantized ring once); the query tile's padded columns are written as
//    zeros.  So QK^T runs its DHP/16 k-steps over zeros past Dh and PV
//    runs m64n{DHP}k16, whose columns past Dh are dropped at the store.  The
//    padding costs tensor-core work (PV at Dh = 80: 128 columns) that the
//    byte bound does not see, and keeps every operand in the canonical
//    128-byte-swizzled layout the Dh = 64 and 128 bodies use.  Above a
//    padded 128 a block takes one consumer warpgroup (64 query rows): its
//    PV accumulators alone are 96 or 128 registers a thread, which two
//    warpgroups under three warps a sub-partition (168 registers) would
//    spill; the shared memory then holds 3 stages of the TMA ring at DHP =
//    256 (int8: 2 raw stages), 4 below.
//  * bf16 and f16: one producer warp reads the page table on the device, a tile
//    ahead, and keeps a ring of Body::kStg stages full (a K and a V tile
//    each), with full and empty mbarriers: no __syncthreads in the walk.  int8: a loader
//    warpgroup keeps a ring of raw stages full (int8 values by TMA,
//    their f32 scales by 4-byte cp.async tracked by the same barrier) and
//    dequantizes each landed stage into a two-stage ring of swizzled bf16
//    tiles, bf16(f32(v) * scale), while the consumers run on the previous
//    one: the dequant is off the products' path (design (i)), and the tiles
//    equal the plain version's operands.
//  * Consumer warpgroups (one up to 64 query rows, two up to 128) each own
//    64 rows.  QK^T is wgmma.mma_async m64n64k16 (bf16 or f16 operands, f32
//    accumulators) with Q (staged once, swizzled) and the K tile from
//    shared memory; the online softmax runs on the score registers (each
//    thread two rows, four lanes a row); PV is m64n{DHP}k16 with P from
//    those registers as the A operand (the pool's operand type) and V as a
//    transposed (MN-major) B operand.  No warps share a tile, so no merge
//    at a split's end.
//  * f32 pool: a plain CUDA-core body (FFMA in f32, one thread a query row,
//    two above a padded Dh of 128, 16-key tiles through shared memory) with
//    the same grid and records: its time is only recorded.
//  * Pass 2, with two or more splits: a warp a query row of a group with
//    several live splits combines them in a fixed order, m = max m_s, l =
//    sum 2^(m_s - m) l_s, acc = sum 2^(m_s - m) acc_s: no atomics, so
//    results repeat bit for bit.  Split 0 holds position 0, which every
//    query row sees, so the combined max is a real score.
//  * Registers (ptxas -v, printed by chip_smoke.py phase 6c).  A block of
//    two consumer warpgroups has 384 threads (bf16, f16: the producer warp's
//    warpgroup is padded with three idle warps), so each thread starts at
//    168 registers, the cap of three warps a sub-partition.  For bf16 and f16,
//    setmaxnreg moves registers from the producer warpgroup (40: it only
//    computes addresses) to the consumers (232), which removes their spill.
//    int8 keeps 168 throughout: its loader holds a stage's converted words
//    and spills below 152 registers, its consumers spill 4 bytes at 176 or
//    less, and three warps a sub-partition hold 504 (120 / 192 spilled 228
//    bytes and ran 21 % slower, 136 / 184 spilled 56, 152 / 176 the same 4
//    as none).  A one-warpgroup block has at most two warps a
//    sub-partition: its 255 registers need no transfer.
//
// The block's layout (threads, shared memory, ring stages, registers) is
// decided here alone; paged_prefill_layout reports it to the host.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "gemv_common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

// One launch's arguments.  The pools' bodies are instantiated in separate
// translation units (bf16 in paged_prefill_attention.cu, f32, f16 and
// int8 in paged_prefill_{f32,f16,int8}.cu), so that their nvcc runs go in
// parallel; these are the names they share.
namespace dllama_prefill {
struct Args {
  const void *q, *pool_k, *pool_v, *scale_k, *scale_v, *layer, *page_table, *pos_rows;
  void *out, *part;
  int out_kind, b, hq, hkv, t_q, ps, dh, maxp, n_pages, n_layers, n_splits, pps;
  float sqrt_dh;
  cudaStream_t stream;
};
// pass 1 of an f32 / f16 / int8 pool at padded head dim dhp
cudaError_t pass1_f32(int dhp, const Args& a);
cudaError_t pass1_f16(int dhp, const Args& a);
cudaError_t pass1_int8(int dhp, const Args& a);
}  // namespace dllama_prefill

namespace {

using dllama_prefill::Args;

// kKeys and kRows are the two numbers the host's split plan needs
// (ops/attention.py PREFILL_KEYS, PREFILL_MAX_ROWS)
constexpr int kKeys = 64;       // keys a tile
constexpr int kRows = 128;      // query rows a block (a row group)
constexpr int kWgRows = 64;     // query rows a consumer warpgroup (wgmma's M)
constexpr int kCvStages = 2;    // int8's dequantized ring
constexpr int kF32Keys = 16;    // the f32 body's tile
constexpr int kSlab = kKeys * 128;  // one 64-row slab of 128 bytes (64 bf16 of Dh)
static_assert(kSlab == kSw128Slab, "a K/V tile is sm90_common.cuh's swizzled slab");
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDh = 256;

// Dh rounded up to whole 64-column slabs: the width the tensor-core body
// computes at (columns past Dh are zero)
__host__ __device__ constexpr int padded_dh(int dh) { return (dh + 63) / 64 * 64; }

// Query rows a block takes: 128 (two consumer warpgroups) up to a padded Dh
// of 128, 64 (one) above it.  The f32 body takes the same groups.
__host__ __device__ constexpr int rows_a_group(int dh) {
  return padded_dh(dh) > 128 ? kWgRows : kRows;
}

// How a page's positions map onto tile rows:
// `br` rows a segment (the power of two, 8 to 64, that covers a page),
// `spp` segments a page, `spt` segments a tile, `lbr` = log2(br).
struct Seg {
  int br, lbr, spp, spt;
  __host__ __device__ explicit Seg(int ps) {
    br = 8;
    lbr = 3;
    while (br < ps && br < kKeys) {
      br *= 2;
      ++lbr;
    }
    spp = (ps + br - 1) / br;
    spt = kKeys / br;
  }
};

// The last token a row group [r0, r_end) of G·T rows (row m = g·T + i)
// holds: T - 1 when it holds the end of a head's tokens.
__host__ __device__ __forceinline__ int group_last_token(int r0, int r_end, int t_q) {
  return (r_end - 1) / t_q != r0 / t_q ? t_q - 1 : (r_end - 1) % t_q;
}

// The pages of a row at position `pos` that hold a position its row group
// [r0, r_end) sees.
__device__ __forceinline__ int live_pages(int pos, int r0, int r_end, int t_q, int ps,
                                          int maxp) {
  return min(pos + group_last_token(r0, r_end, t_q), maxp * ps - 1) / ps + 1;
}

// What one block walks: split `split` (pps pages) of the live pages of its
// (row, row group), as segments [seg_begin, seg_end) in n_tiles tiles;
// n_split is the group's live splits (one: the block writes the output).
struct Walk {
  int h, b, grp, split, n_split, r0, r_end, layer, pos, seg_begin, seg_end, n_tiles;
  long q_row0;  // q's row of the block's first query row
};

// Split blockIdx.z % n_splits of row group blockIdx.z / n_splits (of
// `rows` query rows) of row blockIdx.y for kv head blockIdx.x.  The layer
// was validated on the host; clamping keeps a bad device value from reading
// outside the pool.
__device__ __forceinline__ Walk walk_of(const int* layer_p, const int* pos_rows, int hq,
                                        int hkv, int t_q, int ps, int maxp, int n_layers,
                                        int n_splits, int pps, int rows, const Seg& sg) {
  Walk w;
  w.h = blockIdx.x;
  w.b = blockIdx.y;
  w.grp = blockIdx.z / n_splits;
  w.split = blockIdx.z % n_splits;
  const int g_n = hq / hkv;
  w.r0 = w.grp * rows;
  w.r_end = min(g_n * t_q, w.r0 + rows);
  w.layer = min(max(*layer_p, 0), n_layers - 1);
  w.pos = min(max(pos_rows[w.b], 0), maxp * ps - 1);
  const int n_live = live_pages(w.pos, w.r0, w.r_end, t_q, ps, maxp);
  w.n_split = min((n_live + pps - 1) / pps, n_splits);
  const int p0 = w.split * pps, p1 = min(n_live, p0 + pps);
  w.seg_begin = p0 * sg.spp;
  w.seg_end = p1 * sg.spp;
  w.n_tiles = p0 < p1 ? (w.seg_end - w.seg_begin + sg.spt - 1) / sg.spt : 0;
  w.q_row0 = (static_cast<long>(w.b) * hq + static_cast<long>(w.h) * g_n) * t_q;
  return w;
}

// The pool row (of Dh elements) of segment `sg_i` of the walk: its page's
// physical id through the table (a slot past the table re-reads the last
// one; the keys are masked), then the segment's offset in the page.
__device__ __forceinline__ int segment_row(const Walk& w, const Seg& sg, int sg_i,
                                           const int* page_table, int maxp, int n_pages,
                                           int hkv, int ps) {
  const int at = w.seg_begin + sg_i;
  const int page = min(at / sg.spp, maxp - 1);
  const int pid = min(max(page_table[static_cast<long>(w.b) * maxp + page], 0), n_pages - 1);
  const long head = (static_cast<long>(w.layer) * n_pages + pid) * hkv + w.h;
  return static_cast<int>(head * ps + (at % sg.spp) * sg.br);
}

// The position of tile row r of tile t, or INT_MAX where the row holds no
// key of this walk (past its page, or past the split's segments).  A page
// of at most 64 positions is one segment (spp == 1): no division.
__device__ __forceinline__ int key_position(const Walk& w, const Seg& sg, int ps, int t, int r) {
  const int at = w.seg_begin + t * sg.spt + (r >> sg.lbr);
  const int off0 = r & (sg.br - 1);
  if (sg.spp == 1) return off0 < ps && at < w.seg_end ? at * ps + off0 : INT_MAX;
  const int off = (at % sg.spp) * sg.br + off0;
  return off < ps && at < w.seg_end ? at / sg.spp * ps + off : INT_MAX;
}

// -- wgmma (the helpers are csrc/sm90_common.cuh's) --------------------------

// PV: m64n{DHP}k16, P from registers, operands of type Op
template <int DHP, typename Op>
__device__ __forceinline__ void wgmma_pv(float (&o)[DHP / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DHP == 64) {
    wgmma_rs_n64<Op>(o, a, b);
  } else if constexpr (DHP == 128) {
    wgmma_rs_n128<Op>(o, a, b);
  } else if constexpr (DHP == 192) {
    wgmma_rs_n192<Op>(o, a, b);
  } else {
    static_assert(DHP == 256, "a padded head dim is 64, 128, 192 or 256");
    wgmma_rs_n256<Op>(o, a, b);
  }
}

// two floats as a pair of the operand type (lo in the low half)
template <typename Op>
__device__ __forceinline__ uint32_t pair_bits(float lo, float hi) {
  if constexpr (std::is_same<Op, __half>::value) {
    const __half2 w = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&w);
  } else {
    return bf16x2_bits(lo, hi);
  }
}

// Two output elements of an output of kind `kind` (0 f32, 1 bf16, 2 f16)
__device__ __forceinline__ void store_pair(void* out, long at, int kind, float v0, float v1) {
  if (kind == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
  } else if (kind == 1) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
        __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + at) = __floats2half2_rn(v0, v1);
  }
}

__device__ __forceinline__ void store_one(void* out, long at, int kind, float v) {
  if (kind == 0) {
    static_cast<float*>(out)[at] = v;
  } else if (kind == 1) {
    static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[at] = __float2half_rn(v);
  }
}

// The shared-memory carve-up of the tensor-core body at padded head dim
// DHP: the consumers' query tiles, the ring they read (K and V tiles of the
// operand type Op: the TMA ring for a bf16 or f16 pool, the dequantized
// bf16 ring for int8), int8's raw TMA ring (values, then the K and V scale
// slots), the mbarriers; 1024 bytes of slack align the base for the
// swizzle.  kStg: stages of the TMA ring (int8: the raw ring), as many as
// the shared memory holds up to 4.
template <int DHP, typename KV, int NWG>
struct Body {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  using Op = typename std::conditional<std::is_same<KV, __half>::value, __half,
                                       __nv_bfloat16>::type;
  static_assert(DHP % 64 == 0 && DHP <= kMaxDh, "DHP is whole 64-column slabs");
  static_assert(NWG == 1 || DHP <= 128, "two consumer warpgroups up to a padded Dh of 128");
  // bf16 and f16 with two consumer warpgroups: a whole producer warpgroup,
  // and setmaxnreg moves its registers to the consumers (kProducerRegs,
  // kConsumerRegs a thread)
  static constexpr bool kRebalance = !kInt8 && NWG == 2;
  static constexpr int kThreads = NWG * 128 + (kInt8 || kRebalance ? 128 : 32);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg hands out no more than the block holds at launch");
  static constexpr int kStg = DHP > 192 ? (kInt8 ? 2 : 3) : 4;
  static constexpr int kTile = kKeys * DHP * 2;
  static constexpr int kRing = kInt8 ? kCvStages : kStg;
  static constexpr int kQ = NWG * kWgRows * DHP * 2;
  static constexpr int kRawStage = 2 * kKeys * DHP + 2 * kKeys * 4;  // values, then scales
  static constexpr int kRaw = kQ + kRing * 2 * kTile;
  static constexpr int kBars = kRaw + (kInt8 ? kStg * kRawStage : 0);
  static constexpr int kNBars = kInt8 ? 2 * kStg + 2 * kCvStages : 2 * kStg;
  static constexpr int kSmem = kBars + 8 * kNBars + 1024;
  static_assert(kSmem <= kMaxSmem, "a pass-1 block exceeds the opt-in shared memory");
};

// The f32 body's shared memory: a row group's query rows of Dh + 1
// floats, one 16-key K and V tile.
__host__ __device__ constexpr int f32_smem(int dh) {
  return (rows_a_group(dh) * (dh + 1) + 2 * kF32Keys * dh) * 4;
}

// Consumer warpgroup threadIdx.x / 128: its 64 query rows against every
// tile of the walk; `full0`/`empty0` are the first barriers of the ring it
// reads.
template <int DHP, typename KV, int NWG>
__device__ __forceinline__ void consume(const Walk& w, const Seg& sg, unsigned char* base,
                                        uint32_t full0, uint32_t empty0,
                                        const uint16_t* __restrict__ q, void* __restrict__ out,
                                        float* __restrict__ part, int out_kind, int t_q, int ps,
                                        int dh, int n_splits, float sqrt_dh) {
  using B = Body<DHP, KV, NWG>;
  using Op = typename B::Op;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ct = tid & 127;
  const int lane = tid & 31;
  unsigned char* q_s = base + wg * kWgRows * DHP * 2;
  const int m0 = w.r0 + wg * kWgRows;  // the warpgroup's first query row
  // the query tile (q rows of Dh elements of the operand type), swizzled as
  // the K tiles; rows past the group and columns past Dh are zero
  for (int e = ct; e < kWgRows * (DHP / 8); e += 128) {
    const int r = e / (DHP / 8);
    const int ch = e % (DHP / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < w.r_end && ch * 8 < dh) {
      v = *reinterpret_cast<const uint4*>(q + (w.q_row0 + m0 + r) * dh + ch * 8);
    }
    *reinterpret_cast<uint4*>(q_s + sw_chunk(r, ch)) = v;
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const uint32_t q_a = smem_u32(q_s);
  // this thread's two rows (wgmma's accumulator layout) and their ceilings
  const int ra = m0 + (ct >> 5) * 16 + (lane >> 2);
  const int rb = ra + 8;
  const int ceil_a = ra < w.r_end ? w.pos + ra % t_q : -1;
  const int ceil_b = rb < w.r_end ? w.pos + rb % t_q : -1;
  float o[DHP / 2];
  float sc[32];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;
  // scores in log2 units (exp2 of them is exp of the plain version's)
  const float c2 = kLog2e / sqrt_dh;
  // a warp whose 16 rows are all padding skips the softmax (its P is zero)
  const bool live = m0 + (ct >> 5) * 16 < w.r_end;

  for (int t = 0; t < w.n_tiles; ++t) {
    const int s = t % B::kRing;
    bar_wait(full0 + 8 * s, (t / B::kRing) & 1);
    const uint32_t kt = smem_u32(base + B::kQ + s * 2 * B::kTile);
    const uint32_t vt = kt + B::kTile;
    // S = Q K^T: both operands K-major, 16 of DHP a step (zeros past Dh)
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n64<Op>(sc, sw128_desc(q_a + off, 16, 1024), sw128_desc(kt + off, 16, 1024),
                       kk > 0);
    }
    wg_commit();
    wg_wait();
    reg_fence(sc);
    // mask and scale: column 8j + 2(lane & 3) + e of rows ra (sc[4j + e])
    // and rb (sc[4j + 2 + e])
    uint32_t pa[kKeys / 16][4];
    if (live) {
      float mx_a = kNeg, mx_b = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = key_position(w, sg, ps, t, 8 * j + 2 * (lane & 3) + e);
          sc[4 * j + e] = kp <= ceil_a ? sc[4 * j + e] * c2 : kNeg;
          sc[4 * j + 2 + e] = kp <= ceil_b ? sc[4 * j + 2 + e] * c2 : kNeg;
          mx_a = fmaxf(mx_a, sc[4 * j + e]);
          mx_b = fmaxf(mx_b, sc[4 * j + 2 + e]);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xFFFFFFFFu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xFFFFFFFFu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = exp2f(m_a - mn_a), al_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= al_a;
      l_b *= al_b;
      // P into the A operand of PV: keys 16kk..16kk+15 are n8 blocks 2kk, 2kk+1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - m_a), p1 = exp2f(sc[4 * j + 1] - m_a);
        const float p2 = exp2f(sc[4 * j + 2] - m_b), p3 = exp2f(sc[4 * j + 3] - m_b);
        l_a += p0;
        l_a += p1;
        l_b += p2;
        l_b += p3;
        pa[j >> 1][(j & 1) * 2] = pair_bits<Op>(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = pair_bits<Op>(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
    }
    // O += P V: V's tile is the MN-major B operand (Dh contiguous), 16 keys
    // (two 8-row groups, 1024 bytes apart) a step, its 64-wide slabs kSlab apart
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_pv<DHP, Op>(o, pa[kk], sw128_desc(vt + kk * 16 * 128, kSlab, 1024));
    }
    wg_commit();
    wg_wait();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) bar_arrive(empty0 + 8 * s);
  }

  l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 1);
  l_a += __shfl_xor_sync(0xFFFFFFFFu, l_a, 2);
  l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 1);
  l_b += __shfl_xor_sync(0xFFFFFFFFu, l_b, 2);
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= w.r_end) continue;
    const float mr = half ? m_b : m_a;
    const float lr = half ? l_b : l_a;
    const long row = w.q_row0 + r;
    // columns 8j + col0 and + 1 of the row; those past Dh are dropped
    if (w.n_split == 1) {
      const float inv = 1.f / fmaxf(lr, 1e-38f);
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        if (8 * j < dh) {
          store_pair(out, row * dh + 8 * j + col0, out_kind, o[4 * j + 2 * half] * inv,
                     o[4 * j + 2 * half + 1] * inv);
        }
      }
    } else {
      float* rec = part + (row * n_splits + w.split) * (dh + 2);
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        if (8 * j < dh) {
          *reinterpret_cast<float2*>(rec + 8 * j + col0) =
              make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
        }
      }
      if ((lane & 3) == 0) {
        rec[dh] = mr;
        rec[dh + 1] = lr;
      }
    }
  }
}

// The bf16 or f16 pool's producer warp: for each tile, lane j < spt finds
// segment j's pool row through the page table (read a tile ahead, so its
// latency hides behind the wait for a free stage), lane 0 waits for the
// stage to be free and arms its full barrier with the tile's bytes (whole
// boxes: TMA counts the zeros it writes past Dh), and each lane copies its
// segment's K and V rows, one TMA box a 64-wide slab.
template <int DHP, typename KV, int NWG>
__device__ __forceinline__ void load_tma16(const Walk& w, const Seg& sg, unsigned char* base,
                                           uint32_t bars, const CUtensorMap* mk,
                                           const CUtensorMap* mv, const int* page_table,
                                           int maxp, int n_pages, int hkv, int ps) {
  using B = Body<DHP, KV, NWG>;
  constexpr int kS = B::kStg;
  const int lane = threadIdx.x & 31;
  int next = lane < sg.spt ? segment_row(w, sg, lane, page_table, maxp, n_pages, hkv, ps) : 0;
  for (int t = 0; t < w.n_tiles; ++t) {
    const int s = t % kS;
    const int row = next;
    if (lane < sg.spt && t + 1 < w.n_tiles) {
      next = segment_row(w, sg, (t + 1) * sg.spt + lane, page_table, maxp, n_pages, hkv, ps);
    }
    const uint32_t full = bars + 8 * s;
    if (lane == 0) {
      if (t >= kS) bar_wait(bars + 8 * (kS + s), (t / kS - 1) & 1);
      bar_expect(full, 2 * B::kTile);
    }
    __syncwarp();
    if (lane < sg.spt) {
      const uint32_t kt = smem_u32(base + B::kQ + s * 2 * B::kTile) + lane * sg.br * 128;
#pragma unroll
      for (int sl = 0; sl < DHP / 64; ++sl) {
        tma_2d(kt + sl * kSlab, mk, sl * 64, row, full);
        tma_2d(kt + B::kTile + sl * kSlab, mv, sl * 64, row, full);
      }
    }
  }
}

// Loader thread lt's chunk k of a stage (chunk lt + 128k of the K then V
// tiles' 2 · 64 rows of n8 chunks): its tile kv, row r and chunk ch, for k
// = 0, 1, ... in turn.  kFull: n8 = N8, the divisions by a constant; else
// one division at the start and a carry a step (a division a chunk by the
// runtime n8 made the int8 body 4x slower at Dh 96 on the card).
template <bool kFull, int N8>
struct ChunkWalk {
  int lt, n8, row, ch, q128, r128;
  __device__ __forceinline__ ChunkWalk(int lt_, int n8_) : lt(lt_), n8(kFull ? N8 : n8_) {
    if (!kFull) {
      row = lt / n8;
      ch = lt - row * n8;
      q128 = 128 / n8;
      r128 = 128 - q128 * n8;
    }
  }
  __device__ __forceinline__ void at(int k, int& kv, int& r, int& c) {
    if (kFull) {
      const int e = lt + 128 * k;
      kv = e / (kKeys * N8);
      r = (e / N8) % kKeys;
      c = e % N8;
    } else {
      kv = row / kKeys;
      r = row % kKeys;
      c = ch;
      row += q128;
      ch += r128;
      if (ch >= n8) {
        ch -= n8;
        ++row;
      }
    }
  }
};

// The int8 pool's loader warpgroup: warp 0 keeps the raw ring full (each
// lane < spt one segment: its K and V rows, and two rows' scales a lane);
// all four warps dequantize each landed stage into the swizzled bf16 ring,
// then release both.  A raw stage is refilled once its dequant is done, so
// its wait never blocks on the consumers; the page-table reads for that
// refill are made before the dequant, so their latency hides behind it.
// A raw stage holds rows of Dh bytes; kFull: Dh == DHP (the chunk walk's
// divisions are by a constant), else the columns of the dequantized ring
// past Dh are zeroed once, before the first stage is released.  kFull is
// the kernel's template parameter, not a branch: a block holding both
// walks ran the full widths slower on the card.
template <int DHP, int NWG, bool kFull>
__device__ __forceinline__ void load_int8(const Walk& w, const Seg& sg, unsigned char* base,
                                          uint32_t bars, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const float* scale_k,
                                          const float* scale_v, const int* page_table,
                                          int maxp, int n_pages, int n_layers, int hkv, int ps,
                                          int dh_rt) {
  using B = Body<DHP, int8_t, NWG>;
  constexpr int kS = B::kStg;
  const int dh = kFull ? DHP : dh_rt;
  const int n8 = dh / 8;  // 8-element chunks a row
  const int lt = threadIdx.x - NWG * 128;
  const int lw = lt >> 5;
  const int lane = lt & 31;
  unsigned char* raw = base + B::kRaw;
  const uint32_t raw_full = bars, raw_empty = bars + 8 * kS;
  const uint32_t cv_full = bars + 16 * kS, cv_empty = cv_full + 8 * kCvStages;
  if constexpr (!kFull) {
    // the K and V tiles' chunks past Dh, in both dequantized stages
    const int pad = DHP / 8 - n8;
    for (int e = lt; e < kCvStages * 2 * kKeys * pad; e += 128) {
      const int tile = e / (kKeys * pad);
      const int r = e / pad % kKeys;
      *reinterpret_cast<uint4*>(base + B::kQ + tile * B::kTile + sw_chunk(r, n8 + e % pad)) =
          make_uint4(0, 0, 0, 0);
    }
  }
  const long n_rows = static_cast<long>(n_layers) * n_pages * hkv * ps;
  auto row_of = [&](int t) {
    return lane < sg.spt ? segment_row(w, sg, t * sg.spt + lane, page_table, maxp, n_pages, hkv,
                                       ps)
                         : 0;
  };
  // the scales (4 bytes a position) by cp.async, tracked by the stage's
  // barrier (a TMA box a page of them would double the boxes a tile); then
  // the values, one TMA box a segment
  auto issue = [&](int t, int row) {
    const int s = t % kS;
    const uint32_t full = raw_full + 8 * s;
    unsigned char* st = raw + s * B::kRawStage;
    float* sks = reinterpret_cast<float*>(st + 2 * kKeys * DHP);
#pragma unroll
    for (int i = 0; i < kKeys / 32; ++i) {
      const int r = lane + 32 * i;
      const long at = static_cast<long>(__shfl_sync(0xFFFFFFFFu, row, r >> sg.lbr)) +
                      (r & (sg.br - 1));
      const bool ok = at < n_rows;
      cp_async_zfill<4>(sks + r, scale_k + (ok ? at : 0), ok);
      cp_async_zfill<4>(sks + kKeys + r, scale_v + (ok ? at : 0), ok);
    }
    bar_track_cp_async(full);
    __syncwarp();
    if (lane == 0) bar_expect(full, 2 * kKeys * dh);
    __syncwarp();
    if (lane < sg.spt) {
      const uint32_t sa = smem_u32(st);
      tma_2d(sa + lane * sg.br * dh, mk, 0, row, full);
      tma_2d(sa + kKeys * dh + lane * sg.br * dh, mv, 0, row, full);
    }
  };
  if (lw == 0) {
    int rows[kS];
#pragma unroll
    for (int t = 0; t < kS; ++t) rows[t] = t < w.n_tiles ? row_of(t) : 0;
#pragma unroll
    for (int t = 0; t < kS; ++t) {
      if (t < w.n_tiles) issue(t, rows[t]);
    }
  }
  for (int t = 0; t < w.n_tiles; ++t) {
    const int s = t % kS;
    const int c = t % kCvStages;
    const bool refill = lw == 0 && t + kS < w.n_tiles;
    const int next = refill ? row_of(t + kS) : 0;
    bar_wait(raw_full + 8 * s, (t / kS) & 1);
    const unsigned char* st = raw + s * B::kRawStage;
    unsigned char* cv = base + B::kQ + c * 2 * B::kTile;
    // the thread's chunks of 8 elements of the stage (2 · 64 rows of n8:
    // chunk lt + 128k for k < n8), converted in registers before the wait
    // for the dequantized stage to be free
    constexpr int kChunks = DHP / 8;
    uint4 words[kChunks];
    ChunkWalk<kFull, DHP / 8> cw(lt, n8);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k >= n8) continue;
      int kv, r, ch;
      cw.at(k, kv, r, ch);
      const uint2 u = *reinterpret_cast<const uint2*>(st + kv * kKeys * dh + r * dh + ch * 8);
      const float sv = reinterpret_cast<const float*>(st + 2 * kKeys * DHP)[kv * kKeys + r];
      // v + 128 under the exponent of 2^23 (the sign bit flipped), so
      // float(v) = that float - (2^23 + 128), exactly; then bf16(f32(v) * s)
      uint32_t wd[4];
      const uint32_t x = u.x ^ 0x80808080u, y = u.y ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t word = i < 2 ? x : y;
        const uint32_t b0 = (i & 1) * 2;
        const float v0 = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + b0)) - 8388736.f;
        const float v1 =
            __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + b0 + 1)) - 8388736.f;
        wd[i] = bf16x2_bits(v0 * sv, v1 * sv);
      }
      words[k] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
    if (t >= kCvStages) bar_wait(cv_empty + 8 * c, (t / kCvStages - 1) & 1);
    ChunkWalk<kFull, DHP / 8> cw2(lt, n8);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      if (k >= n8) continue;
      int kv, r, ch;
      cw2.at(k, kv, r, ch);
      *reinterpret_cast<uint4*>(cv + kv * B::kTile + sw_chunk(r, ch)) = words[k];
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      bar_arrive(cv_full + 8 * c);
      bar_arrive(raw_empty + 8 * s);
    }
    if (refill) {
      if (lane == 0) bar_wait(raw_empty + 8 * s, (t / kS) & 1);
      __syncwarp();
      issue(t + kS, next);
    }
  }
}

// Pass 1 of the bf16, f16 and int8 pools: one split of a (row, row group)
// for a kv head (walk_of), at padded head dim DHP; kFull: Dh == DHP (int8's
// loader, load_int8).
template <int DHP, typename KV, int NWG, bool kFull>
__global__ void __launch_bounds__(Body<DHP, KV, NWG>::kThreads, 1)
prefill_tc(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
           const float* __restrict__ scale_k, const float* __restrict__ scale_v,
           const uint16_t* __restrict__ q, const int* __restrict__ layer_p,
           const int* __restrict__ page_table, const int* __restrict__ pos_rows,
           void* __restrict__ out, float* __restrict__ part, int out_kind, int hq, int hkv,
           int t_q, int ps, int dh, int maxp, int n_pages, int n_layers, int n_splits, int pps,
           float sqrt_dh) {
  using B = Body<DHP, KV, NWG>;
  constexpr int kS = B::kStg;
  const Seg sg(ps);
  const Walk w = walk_of(layer_p, pos_rows, hq, hkv, t_q, ps, maxp, n_layers, n_splits, pps,
                         rows_a_group(DHP), sg);
  if (w.n_tiles == 0) return;  // a dead split: pass 2 stops before it
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(base + B::kBars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < B::kNBars; ++i) {
      // bf16, f16: full (the producer's arrival), empty (each consumer
      // warp); int8: raw full, raw empty (each loader warp), dequantized
      // full (each loader warp), dequantized empty (each consumer warp)
      int count;
      if (B::kInt8) {
        count = i < kS ? 1 : (i < 2 * kS + kCvStages ? 4 : 4 * NWG);
      } else {
        count = i < kS ? 1 : 4 * NWG;
      }
      bar_init(bars + 8 * i, count);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are ready: no block-wide sync after this
  if (threadIdx.x < NWG * 128) {
    if constexpr (B::kRebalance) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(B::kConsumerRegs));
    }
    const uint32_t full0 = B::kInt8 ? bars + 16 * kS : bars;
    const uint32_t empty0 = B::kInt8 ? full0 + 8 * kCvStages : bars + 8 * kS;
    consume<DHP, KV, NWG>(w, sg, base, full0, empty0, q, out, part, out_kind, t_q, ps, dh,
                          n_splits, sqrt_dh);
  } else {
    if constexpr (B::kRebalance) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(B::kProducerRegs));
    }
    if constexpr (B::kInt8) {
      load_int8<DHP, NWG, kFull>(w, sg, base, bars, &map_k, &map_v, scale_k, scale_v, page_table,
                                 maxp, n_pages, n_layers, hkv, ps, dh);
    } else if (threadIdx.x < NWG * 128 + 32) {
      load_tma16<DHP, KV, NWG>(w, sg, base, bars, &map_k, &map_v, page_table, maxp, n_pages, hkv,
                               ps);
    }
  }
}

// Pass 1 of the f32 pool: the same grid and records on CUDA cores, in f32
// throughout (FFMA).  A block takes its row group (rows_a_group: 128 query
// rows, 64 above a padded Dh of 128) on 128 threads, kTpr a query row: the
// thread owns kDpt of the row's padded DHP columns (those past Dh are
// skipped) and a pair adds its dots by a shuffle.  The keys come 16
// positions at a time through shared memory (the query rows padded to
// Dh + 1 floats, so the threads' reads of their own rows meet few bank
// conflicts).  Dh is any multiple of 4 up to DHP; kFull: Dh == DHP, every
// loop bound and stride a constant (at a runtime Dh the body ran 3x slower
// on the card).
template <int DHP, bool kFull>
__global__ void __launch_bounds__(kRows)
prefill_f32(const float* __restrict__ q, const float* __restrict__ pool_k,
            const float* __restrict__ pool_v, const int* __restrict__ layer_p,
            const int* __restrict__ page_table, const int* __restrict__ pos_rows,
            void* __restrict__ out, float* __restrict__ part, int out_kind, int hq, int hkv,
            int t_q, int ps, int dh_rt, int maxp, int n_pages, int n_layers, int n_splits,
            int pps, float sqrt_dh) {
  const int dh = kFull ? DHP : dh_rt;
  // the padded widths (no serving path) roll the key loops: a full unroll
  // of every guarded column cost the build more than all other bodies
  constexpr int kKeysUnroll = kFull ? kF32Keys : 1;
  constexpr int kR = rows_a_group(DHP);  // query rows a block
  constexpr int kTpr = kRows / kR;       // threads a query row: 1 or 2
  constexpr int kDpt = DHP / kTpr;       // padded columns a thread owns
  const Seg sg(ps);
  const Walk w = walk_of(layer_p, pos_rows, hq, hkv, t_q, ps, maxp, n_layers, n_splits, pps,
                         kR, sg);
  if (w.n_tiles == 0) return;
  extern __shared__ float fsm[];
  const int qs = dh + 1;
  float* q_s = fsm;
  float* k_s = q_s + kR * qs;
  float* v_s = k_s + kF32Keys * dh;
  const int tid = threadIdx.x;
  for (int e = tid; e < kR * dh; e += kRows) {
    const int r = e / dh;
    const int d = e % dh;
    q_s[r * qs + d] = w.r0 + r < w.r_end ? q[(w.q_row0 + w.r0 + r) * dh + d] : 0.f;
  }
  const int m = w.r0 + tid / kTpr;
  const int d0 = tid % kTpr * kDpt;  // the thread's first column
  const int ceil_m = m < w.r_end ? w.pos + m % t_q : -1;
  const float* qr = q_s + tid / kTpr * qs + d0;
  float acc[kDpt];
#pragma unroll
  for (int d = 0; d < kDpt; ++d) acc[d] = 0.f;
  float mrun = kNeg, l = 0.f;
  const float c2 = kLog2e / sqrt_dh;  // scores in log2 units, as the tensor-core body's
  // the split's positions: its segments' (contiguous: a page's segments in
  // order, then the next page's)
  const int k_begin = w.seg_begin / sg.spp * ps + w.seg_begin % sg.spp * sg.br;
  const int k_end = min(w.seg_end / sg.spp * ps + w.seg_end % sg.spp * sg.br, maxp * ps);
  const int* row_table = page_table + static_cast<long>(w.b) * maxp;
  for (int k0 = k_begin; k0 < k_end; k0 += kF32Keys) {
    __syncthreads();  // the query tile is written, the previous keys read
    for (int e = tid; e < kF32Keys * (dh / 4); e += kRows) {
      const int kk = e / (dh / 4);
      const int c4 = e % (dh / 4);
      const int p = k0 + kk;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (p < k_end) {
        const int pid = min(max(row_table[p / ps], 0), n_pages - 1);
        const long at = ((static_cast<long>(w.layer) * n_pages + pid) * hkv + w.h) * ps * dh +
                        static_cast<long>(p % ps) * dh + c4 * 4;
        kv = *reinterpret_cast<const float4*>(pool_k + at);
        vv = *reinterpret_cast<const float4*>(pool_v + at);
      }
      *reinterpret_cast<float4*>(k_s + kk * dh + c4 * 4) = kv;
      *reinterpret_cast<float4*>(v_s + kk * dh + c4 * 4) = vv;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = kNeg;
#pragma unroll (kKeysUnroll)
    for (int kk = 0; kk < kF32Keys; ++kk) {
      float a = 0.f;
      const float* kr = k_s + kk * dh + d0;
#pragma unroll 16
      for (int d = 0; d < kDpt; ++d) {
        if (d0 + d < dh) a = fmaf(qr[d], kr[d], a);
      }
      if (kTpr == 2) a += __shfl_xor_sync(0xFFFFFFFFu, a, 1);
      const int p = k0 + kk;
      s[kk] = p < k_end && p <= ceil_m ? a * c2 : kNeg;
      mx = fmaxf(mx, s[kk]);
    }
    const float mn = fmaxf(mrun, mx);
    const float al = exp2f(mrun - mn);
    mrun = mn;
    l *= al;
#pragma unroll
    for (int d = 0; d < kDpt; ++d) acc[d] *= al;
#pragma unroll (kKeysUnroll)
    for (int kk = 0; kk < kF32Keys; ++kk) {
      const float p = exp2f(s[kk] - mn);
      l += p;
      const float* vr = v_s + kk * dh + d0;
#pragma unroll
      for (int d = 0; d < kDpt; ++d) {
        if (d0 + d < dh) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
  }
  if (m >= w.r_end) return;
  const long row = w.q_row0 + m;
  if (w.n_split == 1) {
    const float inv = 1.f / fmaxf(l, 1e-38f);
#pragma unroll
    for (int d = 0; d < kDpt; ++d) {
      if (d0 + d < dh) store_one(out, row * dh + d0 + d, out_kind, acc[d] * inv);
    }
  } else {
    float* rec = part + (row * n_splits + w.split) * (dh + 2);
#pragma unroll
    for (int d = 0; d < kDpt; ++d) {
      if (d0 + d < dh) rec[d0 + d] = acc[d];
    }
    if (d0 == 0) {
      rec[dh] = mrun;
      rec[dh + 1] = l;
    }
  }
}

// -- host --------------------------------------------------------------------

// the dynamic shared-memory opt-in, once per instantiation and device
template <typename K>
cudaError_t opt_in(K kern, unsigned* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (*done >> dev & 1u)) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess && dev < 32) *done |= 1u << dev;
  return e;
}

// Tensor maps: a bf16 or f16 pool as rows of Dh (boxes of 64 x br, the
// 128-byte swizzle; a box past Dh reads zeros), an int8 pool as rows of Dh
// bytes (boxes of Dh x br).  Pools are static, so each map is encoded once
// and kept (cached_map_2d).
template <typename KV>
cudaError_t tensor_map(const void* ptr, unsigned long long rows, int dh, int br,
                       CUtensorMap* out) {
  if (std::is_same<KV, int8_t>::value) {
    return cached_map_2d(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, dh, rows,
                         static_cast<unsigned long long>(dh), dh, br, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  return cached_map_2d(out,
                       std::is_same<KV, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       ptr, dh, rows, static_cast<unsigned long long>(dh) * 2, 64, br,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// grid (Hkv, B, row groups x splits)
dim3 grid_of(const Args& a) {
  const int rows = rows_a_group(a.dh);
  return dim3(a.hkv, a.b, (a.hq / a.hkv * a.t_q + rows - 1) / rows * a.n_splits);
}


template <int DHP, typename KV, int NWG, bool kFull>
cudaError_t launch_tc(const Args& a) {
  using B = Body<DHP, KV, NWG>;
  const Seg sg(a.ps);
  const unsigned long long rows =
      static_cast<unsigned long long>(a.n_layers) * a.n_pages * a.hkv * a.ps;
  CUtensorMap mk, mv;
  cudaError_t e = tensor_map<KV>(a.pool_k, rows, a.dh, sg.br, &mk);
  if (e == cudaSuccess) e = tensor_map<KV>(a.pool_v, rows, a.dh, sg.br, &mv);
  if (e != cudaSuccess) return e;
  auto kern = prefill_tc<DHP, KV, NWG, kFull>;
  static unsigned done = 0;
  e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(a), B::kThreads, B::kSmem, a.stream>>>(
      mk, mv, static_cast<const float*>(a.scale_k), static_cast<const float*>(a.scale_v),
      static_cast<const uint16_t*>(a.q), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.pos_rows), a.out,
      static_cast<float*>(a.part), a.out_kind, a.hq, a.hkv, a.t_q, a.ps, a.dh, a.maxp,
      a.n_pages, a.n_layers, a.n_splits, a.pps, a.sqrt_dh);
  return cudaGetLastError();
}

template <int DHP, bool kFull>
cudaError_t launch_f32(const Args& a) {
  auto kern = prefill_f32<DHP, kFull>;
  static unsigned done = 0;
  cudaError_t e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<grid_of(a), kRows, f32_smem(a.dh), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.pool_k),
      static_cast<const float*>(a.pool_v), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.pos_rows), a.out,
      static_cast<float*>(a.part), a.out_kind, a.hq, a.hkv, a.t_q, a.ps, a.dh, a.maxp,
      a.n_pages, a.n_layers, a.n_splits, a.pps, a.sqrt_dh);
  return cudaGetLastError();
}

// consumer warpgroups a block for G·T = rows query rows a kv head at head
// dim dh: one up to 64 rows, or at a padded Dh above 128; two above (a
// block takes at most rows_a_group(dh) of them)
int warpgroups(int rows, int dh) {
  return (rows < rows_a_group(dh) ? rows : rows_a_group(dh)) > kWgRows ? 2 : 1;
}

template <int DHP, typename KV, bool kFull>
cudaError_t launch_nwg(const Args& a) {
  if constexpr (DHP > 128) {
    return launch_tc<DHP, KV, 1, kFull>(a);
  } else {
    return warpgroups(a.hq / a.hkv * a.t_q, a.dh) == 2 ? launch_tc<DHP, KV, 2, kFull>(a)
                                                       : launch_tc<DHP, KV, 1, kFull>(a);
  }
}

// the int8 body's loader walks a raw stage of Dh-byte rows: one kernel
// for Dh == DHP and one for the padded widths; the 16-bit bodies read
// whole boxes either way
template <int DHP, typename KV>
cudaError_t launch_wg(const Args& a) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    if (a.dh != DHP) return launch_nwg<DHP, KV, false>(a);
  }
  return launch_nwg<DHP, KV, true>(a);
}

// pass 1 of the bf16, f16 or int8 pool (KV) at padded head dim dhp
template <typename KV>
cudaError_t pass1_tc(int dhp, const Args& a) {
  switch (dhp) {
    case 64:
      return launch_wg<64, KV>(a);
    case 128:
      return launch_wg<128, KV>(a);
    case 192:
      return launch_wg<192, KV>(a);
    case 256:
      return launch_wg<256, KV>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
