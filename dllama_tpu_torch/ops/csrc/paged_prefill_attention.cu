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
// replay it).  The pool is bf16, int8 with a per-position f32 scale plane
// (L, P, Hkv, ps, 1), or f32.  Query token i of row b sees keys at
// positions <= pos_rows[b] + i.
//
// Numerics follow the plain version: q and the keys are operands of the
// pool's type (int8 values dequantize as bf16(f32(v) * scale), kernel 7's
// rule), the scores accumulate in f32, masked keys take the score -1e30,
// the softmax is f32, the probabilities round to the operand type before
// the PV product, whose sums are f32, and the output is acc / max(l,
// 1e-38) in the output's type.  Two differences: the softmax is online, so
// a bf16 or int8 pool's probabilities round at exp(s - m) for a running
// max m, not the global one (the plain version rounds the normalized
// ones); and the scores are scaled once by log2(e) / sqrt(Dh) and
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
//    (row, kv head)'s G·T query rows (a row group; wider steps have more
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
//  * bf16: one producer warp reads the page table on the device, a tile
//    ahead, and keeps a ring of kStages stages full (a K and a V tile
//    each), with full and empty mbarriers: no __syncthreads in the walk.  int8: a loader
//    warpgroup keeps a kStages ring of raw stages full (int8 values by TMA,
//    their f32 scales by 4-byte cp.async tracked by the same barrier) and
//    dequantizes each landed stage into a two-stage ring of swizzled bf16
//    tiles, bf16(f32(v) * scale), while the consumers run on the previous
//    one: the dequant is off the products' path (design (i)), and the tiles
//    equal the plain version's operands.
//  * Consumer warpgroups (one up to 64 query rows, two up to 128) each own
//    64 rows.  QK^T is wgmma.mma_async m64n64k16 (bf16, f32 accumulators)
//    with Q (staged once, swizzled) and the K tile from shared memory; the
//    online softmax runs on the score registers (each thread two rows,
//    four lanes a row); PV is m64n{Dh}k16 with P from those registers as
//    the bf16 A operand and V as a transposed (MN-major) B operand.  No
//    warps share a tile, so no merge at a split's end.
//  * f32 pool: a plain CUDA-core body (FFMA in f32, one thread a query row,
//    16-key tiles through shared memory) with the same grid and records:
//    its time is only recorded.
//  * Pass 2, with two or more splits: a warp a query row of a group with
//    several live splits combines them in a fixed order, m = max m_s, l =
//    sum 2^(m_s - m) l_s, acc = sum 2^(m_s - m) acc_s: no atomics, so
//    results repeat bit for bit.  Split 0 holds position 0, which every
//    query row sees, so the combined max is a real score.
//  * Registers (ptxas -v, printed by chip_smoke.py phase 6c).  A block of
//    two consumer warpgroups has 384 threads (bf16: the producer warp's
//    warpgroup is padded with three idle warps), so each thread starts at
//    168 registers, the cap of three warps a sub-partition.  For bf16,
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "gemv_common.cuh"
#include "mma_common.cuh"
#include "sm90_common.cuh"

namespace {

// kKeys and kRows are the two numbers the host's split plan needs
// (ops/attention.py PREFILL_KEYS, PREFILL_MAX_ROWS)
constexpr int kKeys = 64;       // keys a tile
constexpr int kRows = 128;      // query rows a block (a row group)
constexpr int kWgRows = 64;     // query rows a consumer warpgroup (wgmma's M)
constexpr int kStages = 4;      // the TMA ring
constexpr int kCvStages = 2;    // int8's dequantized ring
constexpr int kF32Keys = 16;    // the f32 body's tile
constexpr int kSlab = kKeys * 128;  // one 64-row slab of 128 bytes (64 bf16 of Dh)
static_assert(kSlab == kSw128Slab, "a K/V tile is sm90_common.cuh's swizzled slab");
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// Split blockIdx.z % n_splits of row group blockIdx.z / n_splits of row
// blockIdx.y for kv head blockIdx.x.  The layer was validated on the host;
// clamping keeps a bad device value from reading outside the pool.
__device__ __forceinline__ Walk walk_of(const int* layer_p, const int* pos_rows, int hq,
                                        int hkv, int t_q, int ps, int maxp, int n_layers,
                                        int n_splits, int pps, const Seg& sg) {
  Walk w;
  w.h = blockIdx.x;
  w.b = blockIdx.y;
  w.grp = blockIdx.z / n_splits;
  w.split = blockIdx.z % n_splits;
  const int g_n = hq / hkv;
  w.r0 = w.grp * kRows;
  w.r_end = min(g_n * t_q, w.r0 + kRows);
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

// PV: m64n{Dh}k16, P from registers
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(o, a, b);
}

// The shared-memory carve-up of the tensor-core body: the consumers' query
// tiles, the ring they read (bf16 K and V tiles: the TMA ring for a bf16
// pool, the dequantized ring for int8), int8's raw TMA ring (values, then
// the K and V scale slots), the mbarriers; 1024 bytes of slack align the
// base for the swizzle.
template <int DH, typename KV, int NWG>
struct Body {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  // bf16 with two consumer warpgroups: a whole producer warpgroup, and
  // setmaxnreg moves its registers to the consumers (kProducerRegs,
  // kConsumerRegs a thread)
  static constexpr bool kRebalance = !kInt8 && NWG == 2;
  static constexpr int kThreads = NWG * 128 + (kInt8 || kRebalance ? 128 : 32);
  static constexpr int kProducerRegs = 40;
  static constexpr int kConsumerRegs = 232;
  static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg hands out no more than the block holds at launch");
  static constexpr int kTile = kKeys * DH * 2;
  static constexpr int kRing = kInt8 ? kCvStages : kStages;
  static constexpr int kQ = NWG * kWgRows * DH * 2;
  static constexpr int kRawStage = 2 * kKeys * DH + 2 * kKeys * 4;  // values, then scales
  static constexpr int kRaw = kQ + kRing * 2 * kTile;
  static constexpr int kBars = kRaw + (kInt8 ? kStages * kRawStage : 0);
  static constexpr int kNBars = kInt8 ? 2 * kStages + 2 * kCvStages : 2 * kStages;
  static constexpr int kSmem = kBars + 8 * kNBars + 1024;
  static_assert(kSmem <= kMaxSmem, "a pass-1 block exceeds the opt-in shared memory");
};

// The f32 body's shared memory: 128 query rows of Dh + 1 floats, one
// 16-key K and V tile.
template <int DH>
constexpr int f32_smem() {
  return (kRows * (DH + 1) + 2 * kF32Keys * DH) * 4;
}

// Consumer warpgroup threadIdx.x / 128: its 64 query rows against every
// tile of the walk; `full0`/`empty0` are the first barriers of the ring it
// reads.
template <int DH, typename KV, int NWG>
__device__ __forceinline__ void consume(const Walk& w, const Seg& sg, unsigned char* base,
                                        uint32_t full0, uint32_t empty0,
                                        const __nv_bfloat16* __restrict__ q, void* __restrict__ out,
                                        float* __restrict__ part, int out_f32, int t_q, int ps,
                                        int n_splits, float sqrt_dh) {
  using B = Body<DH, KV, NWG>;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int ct = tid & 127;
  const int lane = tid & 31;
  unsigned char* q_s = base + wg * kWgRows * DH * 2;
  const int m0 = w.r0 + wg * kWgRows;  // the warpgroup's first query row
  // the query tile, swizzled as the K tiles; rows past the group are zero
  for (int e = ct; e < kWgRows * (DH / 8); e += 128) {
    const int r = e / (DH / 8);
    const int ch = e % (DH / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < w.r_end) {
      v = *reinterpret_cast<const uint4*>(q + (w.q_row0 + m0 + r) * DH + ch * 8);
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
  float o[DH / 2];
  float sc[32];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
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
    // S = Q K^T: both operands K-major, 16 of Dh a step
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kSlab + (kk & 3) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_a + off, 16, 1024), sw128_desc(kt + off, 16, 1024), kk > 0);
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
        pa[j >> 1][(j & 1) * 2] = bf16x2_bits(p0, p1);
        pa[j >> 1][(j & 1) * 2 + 1] = bf16x2_bits(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
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
      wgmma_pv<DH>(o, pa[kk], sw128_desc(vt + kk * 16 * 128, kSlab, 1024));
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
    if (w.n_split == 1) {
      const float inv = 1.f / fmaxf(lr, 1e-38f);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const float v0 = o[4 * j + 2 * half] * inv, v1 = o[4 * j + 2 * half + 1] * inv;
        const long at = row * DH + 8 * j + col0;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    } else {
      float* rec = part + (row * n_splits + w.split) * (DH + 2);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<float2*>(rec + 8 * j + col0) =
            make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
      }
      if ((lane & 3) == 0) {
        rec[DH] = mr;
        rec[DH + 1] = lr;
      }
    }
  }
}

// The bf16 pool's producer warp: for each tile, lane j < spt finds segment
// j's pool row through the page table (read a tile ahead, so its latency
// hides behind the wait for a free stage), lane 0 waits for the stage to be
// free and arms its full barrier with the tile's bytes, and each lane
// copies its segment's K and V rows, one TMA box a 64-wide slab.
template <int DH, int NWG>
__device__ __forceinline__ void load_bf16(const Walk& w, const Seg& sg, unsigned char* base,
                                          uint32_t bars, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const int* page_table,
                                          int maxp, int n_pages, int hkv, int ps) {
  using B = Body<DH, __nv_bfloat16, NWG>;
  const int lane = threadIdx.x & 31;
  int next = lane < sg.spt ? segment_row(w, sg, lane, page_table, maxp, n_pages, hkv, ps) : 0;
  for (int t = 0; t < w.n_tiles; ++t) {
    const int s = t % kStages;
    const int row = next;
    if (lane < sg.spt && t + 1 < w.n_tiles) {
      next = segment_row(w, sg, (t + 1) * sg.spt + lane, page_table, maxp, n_pages, hkv, ps);
    }
    const uint32_t full = bars + 8 * s;
    if (lane == 0) {
      if (t >= kStages) bar_wait(bars + 8 * (kStages + s), (t / kStages - 1) & 1);
      bar_expect(full, 2 * B::kTile);
    }
    __syncwarp();
    if (lane < sg.spt) {
      const uint32_t kt = smem_u32(base + B::kQ + s * 2 * B::kTile) + lane * sg.br * 128;
#pragma unroll
      for (int sl = 0; sl < DH / 64; ++sl) {
        tma_2d(kt + sl * kSlab, mk, sl * 64, row, full);
        tma_2d(kt + B::kTile + sl * kSlab, mv, sl * 64, row, full);
      }
    }
  }
}

// The int8 pool's loader warpgroup: warp 0 keeps the raw ring full (each
// lane < spt one segment: its K and V rows, and two rows' scales a lane);
// all four warps dequantize each landed stage into the swizzled bf16 ring,
// then release both.  A raw stage is refilled once its dequant is done, so
// its wait never blocks on the consumers; the page-table reads for that
// refill are made before the dequant, so their latency hides behind it.
template <int DH, int NWG>
__device__ __forceinline__ void load_int8(const Walk& w, const Seg& sg, unsigned char* base,
                                          uint32_t bars, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const float* scale_k,
                                          const float* scale_v, const int* page_table,
                                          int maxp, int n_pages, int n_layers, int hkv, int ps) {
  using B = Body<DH, int8_t, NWG>;
  const int lt = threadIdx.x - NWG * 128;
  const int lw = lt >> 5;
  const int lane = lt & 31;
  unsigned char* raw = base + B::kRaw;
  const uint32_t raw_full = bars, raw_empty = bars + 8 * kStages;
  const uint32_t cv_full = bars + 16 * kStages, cv_empty = cv_full + 8 * kCvStages;
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
    const int s = t % kStages;
    const uint32_t full = raw_full + 8 * s;
    unsigned char* st = raw + s * B::kRawStage;
    float* sks = reinterpret_cast<float*>(st + 2 * kKeys * DH);
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
    if (lane == 0) bar_expect(full, 2 * kKeys * DH);
    __syncwarp();
    if (lane < sg.spt) {
      const uint32_t sa = smem_u32(st);
      tma_2d(sa + lane * sg.br * DH, mk, 0, row, full);
      tma_2d(sa + kKeys * DH + lane * sg.br * DH, mv, 0, row, full);
    }
  };
  if (lw == 0) {
    int rows[kStages];
#pragma unroll
    for (int t = 0; t < kStages; ++t) rows[t] = t < w.n_tiles ? row_of(t) : 0;
#pragma unroll
    for (int t = 0; t < kStages; ++t) {
      if (t < w.n_tiles) issue(t, rows[t]);
    }
  }
  for (int t = 0; t < w.n_tiles; ++t) {
    const int s = t % kStages;
    const int c = t % kCvStages;
    const bool refill = lw == 0 && t + kStages < w.n_tiles;
    const int next = refill ? row_of(t + kStages) : 0;
    bar_wait(raw_full + 8 * s, (t / kStages) & 1);
    const unsigned char* st = raw + s * B::kRawStage;
    unsigned char* cv = base + B::kQ + c * 2 * B::kTile;
    // the thread's chunks of 8 elements of the stage, converted in
    // registers before the wait for the dequantized stage to be free
    constexpr int kChunks = 2 * kKeys * (DH / 8) / 128;
    uint4 words[kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int e = lt + 128 * k;
      const int kv = e / (kKeys * (DH / 8));
      const int r = (e / (DH / 8)) % kKeys;
      const int ch = e % (DH / 8);
      const uint2 u = *reinterpret_cast<const uint2*>(st + kv * kKeys * DH + r * DH + ch * 8);
      const float sv = reinterpret_cast<const float*>(st + 2 * kKeys * DH)[kv * kKeys + r];
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
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int e = lt + 128 * k;
      const int kv = e / (kKeys * (DH / 8));
      *reinterpret_cast<uint4*>(cv + kv * B::kTile +
                                sw_chunk((e / (DH / 8)) % kKeys, e % (DH / 8))) = words[k];
    }
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      bar_arrive(cv_full + 8 * c);
      bar_arrive(raw_empty + 8 * s);
    }
    if (refill) {
      if (lane == 0) bar_wait(raw_empty + 8 * s, (t / kStages) & 1);
      __syncwarp();
      issue(t + kStages, next);
    }
  }
}

// Pass 1 of the bf16 and int8 pools: one split of a (row, row group) for a
// kv head (walk_of).
template <int DH, typename KV, int NWG>
__global__ void __launch_bounds__(Body<DH, KV, NWG>::kThreads, 1)
prefill_tc(const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
           const float* __restrict__ scale_k, const float* __restrict__ scale_v,
           const __nv_bfloat16* __restrict__ q, const int* __restrict__ layer_p,
           const int* __restrict__ page_table, const int* __restrict__ pos_rows,
           void* __restrict__ out, float* __restrict__ part, int out_f32, int hq, int hkv,
           int t_q, int ps, int maxp, int n_pages, int n_layers, int n_splits, int pps,
           float sqrt_dh) {
  using B = Body<DH, KV, NWG>;
  const Seg sg(ps);
  const Walk w = walk_of(layer_p, pos_rows, hq, hkv, t_q, ps, maxp, n_layers, n_splits, pps, sg);
  if (w.n_tiles == 0) return;  // a dead split: pass 2 stops before it
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(base + B::kBars);
  if (threadIdx.x == 0) {
    for (int i = 0; i < B::kNBars; ++i) {
      // bf16: full (the producer's arrival), empty (each consumer warp);
      // int8: raw full, raw empty (each loader warp), dequantized full
      // (each loader warp), dequantized empty (each consumer warp)
      int count;
      if (B::kInt8) {
        count = i < kStages ? 1 : (i < 2 * kStages + kCvStages ? 4 : 4 * NWG);
      } else {
        count = i < kStages ? 1 : 4 * NWG;
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
    const uint32_t full0 = B::kInt8 ? bars + 16 * kStages : bars;
    const uint32_t empty0 = B::kInt8 ? full0 + 8 * kCvStages : bars + 8 * kStages;
    consume<DH, KV, NWG>(w, sg, base, full0, empty0, q, out, part, out_f32, t_q, ps, n_splits,
                         sqrt_dh);
  } else {
    if constexpr (B::kRebalance) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(B::kProducerRegs));
    }
    if constexpr (B::kInt8) {
      load_int8<DH, NWG>(w, sg, base, bars, &map_k, &map_v, scale_k, scale_v, page_table, maxp,
                         n_pages, n_layers, hkv, ps);
    } else if (threadIdx.x < NWG * 128 + 32) {
      load_bf16<DH, NWG>(w, sg, base, bars, &map_k, &map_v, page_table, maxp, n_pages, hkv, ps);
    }
  }
}

// Pass 1 of the f32 pool: the same grid and records on CUDA cores, in f32
// throughout (FFMA): thread i owns query row r0 + i, the keys come 16
// positions at a time through shared memory (the query rows padded to Dh + 1
// floats, so the threads' reads of their own rows meet no bank conflict).
template <int DH>
__global__ void __launch_bounds__(kRows)
prefill_f32(const float* __restrict__ q, const float* __restrict__ pool_k,
            const float* __restrict__ pool_v, const int* __restrict__ layer_p,
            const int* __restrict__ page_table, const int* __restrict__ pos_rows,
            void* __restrict__ out, float* __restrict__ part, int out_f32, int hq, int hkv,
            int t_q, int ps, int maxp, int n_pages, int n_layers, int n_splits, int pps,
            float sqrt_dh) {
  const Seg sg(ps);
  const Walk w = walk_of(layer_p, pos_rows, hq, hkv, t_q, ps, maxp, n_layers, n_splits, pps, sg);
  if (w.n_tiles == 0) return;
  extern __shared__ float fsm[];
  float* q_s = fsm;
  float* k_s = q_s + kRows * (DH + 1);
  float* v_s = k_s + kF32Keys * DH;
  const int tid = threadIdx.x;
  for (int e = tid; e < kRows * DH; e += kRows) {
    const int r = e / DH;
    const int d = e % DH;
    q_s[r * (DH + 1) + d] = w.r0 + r < w.r_end ? q[(w.q_row0 + w.r0 + r) * DH + d] : 0.f;
  }
  const int m = w.r0 + tid;
  const int ceil_m = m < w.r_end ? w.pos + m % t_q : -1;
  const float* qr = q_s + tid * (DH + 1);
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  float mrun = kNeg, l = 0.f;
  const float c2 = kLog2e / sqrt_dh;  // scores in log2 units, as the tensor-core body's
  // the split's positions: its segments' (contiguous: a page's segments in
  // order, then the next page's)
  const int k_begin = w.seg_begin / sg.spp * ps + w.seg_begin % sg.spp * sg.br;
  const int k_end = min(w.seg_end / sg.spp * ps + w.seg_end % sg.spp * sg.br, maxp * ps);
  const int* row_table = page_table + static_cast<long>(w.b) * maxp;
  for (int k0 = k_begin; k0 < k_end; k0 += kF32Keys) {
    __syncthreads();  // the query tile is written, the previous keys read
    for (int e = tid; e < kF32Keys * (DH / 4); e += kRows) {
      const int kk = e / (DH / 4);
      const int c4 = e % (DH / 4);
      const int p = k0 + kk;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (p < k_end) {
        const int pid = min(max(row_table[p / ps], 0), n_pages - 1);
        const long at = ((static_cast<long>(w.layer) * n_pages + pid) * hkv + w.h) * ps * DH +
                        static_cast<long>(p % ps) * DH + c4 * 4;
        kv = *reinterpret_cast<const float4*>(pool_k + at);
        vv = *reinterpret_cast<const float4*>(pool_v + at);
      }
      *reinterpret_cast<float4*>(k_s + kk * DH + c4 * 4) = kv;
      *reinterpret_cast<float4*>(v_s + kk * DH + c4 * 4) = vv;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = kNeg;
#pragma unroll
    for (int kk = 0; kk < kF32Keys; ++kk) {
      float a = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) a = fmaf(qr[d], k_s[kk * DH + d], a);
      const int p = k0 + kk;
      s[kk] = p < k_end && p <= ceil_m ? a * c2 : kNeg;
      mx = fmaxf(mx, s[kk]);
    }
    const float mn = fmaxf(mrun, mx);
    const float al = exp2f(mrun - mn);
    mrun = mn;
    l *= al;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= al;
#pragma unroll
    for (int kk = 0; kk < kF32Keys; ++kk) {
      const float p = exp2f(s[kk] - mn);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, v_s[kk * DH + d], acc[d]);
    }
  }
  if (m >= w.r_end) return;
  const long row = w.q_row0 + m;
  if (w.n_split == 1) {
    const float inv = 1.f / fmaxf(l, 1e-38f);
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (out_f32) {
        static_cast<float*>(out)[row * DH + d] = acc[d] * inv;
      } else {
        static_cast<__nv_bfloat16*>(out)[row * DH + d] = __float2bfloat16_rn(acc[d] * inv);
      }
    }
  } else {
    float* rec = part + (row * n_splits + w.split) * (DH + 2);
#pragma unroll
    for (int d = 0; d < DH; ++d) rec[d] = acc[d];
    rec[DH] = mrun;
    rec[DH + 1] = l;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Pass 2: a warp a query row (8 a block, rows in (row, head, token)
// order); a row whose group has several live splits (as walk_of counts
// them) combines them: lane s takes split s's max m_s and denominator l_s,
// m = max m_s and l = sum 2^(m_s - m) l_s by a fixed shuffle tree, then each
// lane adds acc = sum_s 2^(m_s - m) acc_s over its elements in split order,
// every split's loads in flight at once.  Fixed orders, no atomics: the
// results repeat bit for bit.
constexpr int kCombineWarps = 8;

template <typename OT>
__global__ void __launch_bounds__(32 * kCombineWarps)
prefill_combine(const float* __restrict__ part, const int* __restrict__ pos_rows,
                OT* __restrict__ out, int b_n, int hq, int hkv, int t_q, int ps, int dh,
                int maxp, int n_splits, int pps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long>(b_n) * hq * t_q) return;
  const int tok = static_cast<int>(row % t_q);
  const int head = static_cast<int>(row / t_q % hq);
  const int b = static_cast<int>(row / t_q / hq);
  const int g_n = hq / hkv;
  const int r0 = ((head % g_n) * t_q + tok) / kRows * kRows;
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int n_live = live_pages(pos, r0, min(g_n * t_q, r0 + kRows), t_q, ps, maxp);
  const int n = min((n_live + pps - 1) / pps, n_splits);
  if (n == 1) return;  // pass 1 wrote this row
  const int rec = dh + 2;
  const float* src = part + row * n_splits * rec;
  float mx = kNeg;
  for (int sp = lane; sp < n; sp += 32) mx = fmaxf(mx, src[sp * rec + dh]);
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
  float l = 0.f;
  for (int sp = lane; sp < n; sp += 32) {
    l += exp2f(src[sp * rec + dh] - mx) * src[sp * rec + dh + 1];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xFFFFFFFFu, l, o);
  const float inv = 1.f / fmaxf(l, 1e-38f);
  for (int d0 = 0; d0 < dh; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int sp = 0; sp < n; ++sp) {
      const float w = exp2f(src[sp * rec + dh] - mx);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int d = d0 + lane + 32 * k;
        if (d < dh) acc[k] += w * src[sp * rec + d];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = d0 + lane + 32 * k;
      if (d < dh) store(out + row * dh + d, acc[k] * inv);
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

// Tensor maps: a bf16 pool as rows of Dh (boxes of 64 x br, the 128-byte
// swizzle), an int8 pool as rows of Dh bytes (boxes of Dh x br).  Pools
// are static, so each map is encoded once and kept (cached_map_2d).
enum MapKind { kMapBf16 = 0, kMapInt8 = 1 };

cudaError_t tensor_map(int kind, const void* ptr, unsigned long long rows, int dh, int br,
                       CUtensorMap* out) {
  const bool b16 = kind == kMapBf16;
  return cached_map_2d(out, b16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                       ptr, dh, rows, static_cast<unsigned long long>(dh) * (b16 ? 2 : 1),
                       b16 ? 64 : dh, br,
                       b16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Args {
  const void *q, *pool_k, *pool_v, *scale_k, *scale_v, *layer, *page_table, *pos_rows;
  void *out, *part;
  int out_f32, b, hq, hkv, t_q, ps, dh, maxp, n_pages, n_layers, n_splits, pps;
  float sqrt_dh;
  cudaStream_t stream;
  // grid (Hkv, B, row groups x splits)
  dim3 grid() const {
    return dim3(hkv, b, (hq / hkv * t_q + kRows - 1) / kRows * n_splits);
  }
};

template <int DH, typename KV, int NWG>
cudaError_t launch_tc(const Args& a) {
  using B = Body<DH, KV, NWG>;
  const Seg sg(a.ps);
  const unsigned long long rows =
      static_cast<unsigned long long>(a.n_layers) * a.n_pages * a.hkv * a.ps;
  const int kind = B::kInt8 ? kMapInt8 : kMapBf16;
  CUtensorMap mk, mv;
  cudaError_t e = tensor_map(kind, a.pool_k, rows, DH, sg.br, &mk);
  if (e == cudaSuccess) e = tensor_map(kind, a.pool_v, rows, DH, sg.br, &mv);
  if (e != cudaSuccess) return e;
  auto kern = prefill_tc<DH, KV, NWG>;
  static unsigned done = 0;
  e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<a.grid(), B::kThreads, B::kSmem, a.stream>>>(
      mk, mv, static_cast<const float*>(a.scale_k), static_cast<const float*>(a.scale_v),
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.pos_rows), a.out,
      static_cast<float*>(a.part), a.out_f32, a.hq, a.hkv, a.t_q, a.ps, a.maxp, a.n_pages,
      a.n_layers, a.n_splits, a.pps, a.sqrt_dh);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const Args& a) {
  auto kern = prefill_f32<DH>;
  static unsigned done = 0;
  cudaError_t e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<a.grid(), kRows, f32_smem<DH>(), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.pool_k),
      static_cast<const float*>(a.pool_v), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.pos_rows), a.out,
      static_cast<float*>(a.part), a.out_f32, a.hq, a.hkv, a.t_q, a.ps, a.maxp, a.n_pages,
      a.n_layers, a.n_splits, a.pps, a.sqrt_dh);
  return cudaGetLastError();
}

// consumer warpgroups a block for G·T = rows query rows a kv head: one up
// to 64, two above (a block takes at most kRows of them)
int warpgroups(int rows) { return (rows < kRows ? rows : kRows) > kWgRows ? 2 : 1; }

template <int DH, typename KV>
cudaError_t launch_wg(const Args& a) {
  return warpgroups(a.hq / a.hkv * a.t_q) == 2 ? launch_tc<DH, KV, 2>(a)
                                               : launch_tc<DH, KV, 1>(a);
}

template <int DH>
cudaError_t pass1(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 0:
      return launch_f32<DH>(a);
    case 1:
      return launch_wg<DH, __nv_bfloat16>(a);
    case 2:
      return launch_wg<DH, int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename OT>
cudaError_t combine(const Args& a) {
  const long rows = static_cast<long>(a.b) * a.hq * a.t_q;
  const unsigned blocks = static_cast<unsigned>((rows + kCombineWarps - 1) / kCombineWarps);
  prefill_combine<OT><<<blocks, 32 * kCombineWarps, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<const int*>(a.pos_rows),
      static_cast<OT*>(a.out), a.b, a.hq, a.hkv, a.t_q, a.ps, a.dh, a.maxp, a.n_splits, a.pps);
  return cudaGetLastError();
}

template <int DH, typename KV, int NWG>
void tc_layout(int* out) {
  using B = Body<DH, KV, NWG>;
  out[0] = NWG;
  out[1] = B::kThreads;
  out[2] = B::kSmem;
  out[3] = kStages;
  out[4] = B::kRebalance ? B::kConsumerRegs : 0;
}

template <int DH>
int layout(int kv_dtype, int rows, int* out) {
  const bool two = warpgroups(rows) == 2;
  switch (kv_dtype) {
    case 0:
      out[0] = 0;
      out[1] = kRows;
      out[2] = f32_smem<DH>();
      out[3] = 1;
      out[4] = 0;
      return 0;
    case 1:
      two ? tc_layout<DH, __nv_bfloat16, 2>(out) : tc_layout<DH, __nv_bfloat16, 1>(out);
      return 0;
    case 2:
      two ? tc_layout<DH, int8_t, 2>(out) : tc_layout<DH, int8_t, 1>(out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The pass-1 block a launch of `rows` = G·T query rows a kv head takes on a
// pool of kv_dtype (as below) at head dim dh: out[0] consumer warpgroups (0
// for the f32 body), out[1] threads, out[2] dynamic shared memory in bytes,
// out[3] stages of the copy ring, out[4] registers a consumer thread after
// setmaxnreg (0: the block keeps its launch count).  Launches nothing.
extern "C" int paged_prefill_layout(int kv_dtype, int dh, int rows, int* out) {
  switch (dh) {
    case 64:
      return layout<64>(kv_dtype, rows, out);
    case 128:
      return layout<128>(kv_dtype, rows, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q: (B, Hq, T, Dh), bf16 for a bf16 or int8 pool, f32 for an f32 pool;
// out_dtype: 0 float32, 1 bfloat16; kv_dtype: 0 float32, 1 bfloat16, 2
// int8 (scale_k/scale_v then point at the f32 scale planes).  part: f32
// scratch (B, Hq, T, n_splits, Dh + 2), unused with one split; the plan
// (n_splits splits of pps pages) comes from ops/attention.py prefill_plan.
// Dh is 64 or 128; the pool holds fewer than 2^31 rows of Dh.  Returns a
// cudaError_t: 0 when every launch was accepted.
extern "C" int paged_prefill_attention(const void* q, const void* pool_k, const void* pool_v,
                                       const void* scale_k, const void* scale_v,
                                       const void* layer, const void* page_table,
                                       const void* pos_rows, void* out, void* part,
                                       int out_dtype, int kv_dtype, int b, int hq, int hkv,
                                       int t_q, int ps, int dh, int maxp, int n_pages,
                                       int n_layers, int n_splits, int pps, float sqrt_dh,
                                       void* stream) {
  if (out_dtype != 0 && out_dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,       pool_k,   pool_v,          scale_k, scale_v, layer, page_table,
               pos_rows, out,     part,            out_dtype == 0,   b,     hq,
               hkv,     t_q,      ps,              dh,      maxp,    n_pages, n_layers,
               n_splits, pps,     sqrt_dh,         static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (dh) {
    case 64:
      e = pass1<64>(kv_dtype, a);
      break;
    case 128:
      e = pass1<128>(kv_dtype, a);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  e = out_dtype == 0 ? combine<float>(a) : combine<__nv_bfloat16>(a);
  return static_cast<int>(e);
}
