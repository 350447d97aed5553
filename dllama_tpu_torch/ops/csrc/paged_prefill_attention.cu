// Causal GQA over the paged KV pool for t > 1 query rows (the mixed
// prefill slot step), for Hopper (sm_90a).
//
// The port's own kernel: it has no Pallas counterpart.  It computes what
// the JAX package leaves to XLA at dllama_tpu/ops/attention.py:106
// _rows_ceiling_attention over the view that paged_gather_layer (:218)
// gathers, but reads the pages in place.  q (B, Hq, T, Dh) bf16 against a
// paged pool (L, P, Hkv, ps, Dh) through a page table (B, maxp) int32, at
// per-row positions (B,) int32 and a layer index, all three read from
// device memory (the launch needs no host value, so a captured CUDA graph
// can replay it).  The pool is bf16, or int8 with a per-position f32 scale
// plane (L, P, Hkv, ps, 1).  Query token i of row b sees keys at positions
// <= pos_rows[b] + i.
//
// Numerics follow the plain version: q and the keys are the bf16 operands
// (int8 values dequantize as bf16(f32(v) * scale), kernel 7's rule), the
// scores accumulate in f32 and are divided by sqrt(Dh) in f32, masked keys
// take the score -1e30, the softmax is f32, the probabilities round to
// bf16 before the PV product, whose sums are f32, and the output is
// acc / max(l, 1e-38) in the output's type.  The softmax is online: the
// probabilities round at exp(s - m) for a running max m, not the global
// one, so the kernel differs from the one-shot plain version by bf16
// rounding of the probabilities (the plain version rounds the normalized
// ones).
//
// Bound: bytes at the serving path's shapes.  A block reads each live K/V
// byte of its (row, kv head) once and does 4·G·T flops on each element
// (QK and PV for G·T query rows): at G·T = 16-64 that is 32-128 flops a
// bf16 byte, under the card's ~295.  The design:
//  * Pass 1, grid (Hkv, B, S): split s of row b walks its own `pps`
//    pages, clipped on the device to the row's live pages, those that hold
//    a position <= pos_rows[b] + T - 1; a split past them returns at once.
//    S and pps come from host shapes alone (ops/attention.py split_plan,
//    kernel 7's plan).
//  * Pages arrive in a ring of kStages stages in shared memory through
//    16-byte cp.async, `pp` pages a stage.  A bf16 page lands straight in
//    the tile layout the products read (rows padded to Dh + 8 elements, so
//    ldmatrix meets no bank conflict); an int8 stage lands raw and is
//    dequantized through registers into one bf16 tile pair.
//  * The block's G·T query rows (one to eight m16 tiles) form the A
//    operand of bf16 mma.sync m16n8k16 with f32 accumulators, for both
//    QK^T (K rows read by ldmatrix) and PV (V by ldmatrix.trans, P taken
//    from the score accumulators in registers).  Each warp owns one m16
//    tile (two above 64 rows); with fewer tiles than warps, warps that
//    share a tile take alternate 16-key chunks, each with its own online
//    softmax, and merge at the split's end.
//  * Each query row has its own online softmax (running max, denominator,
//    numerator), kept in the accumulators' registers.
//  * Pass 2, grid (Hq·T, B): a query row's live splits combine in split
//    order, m = max m_s, l = sum exp(m_s - m) l_s, acc = sum exp(m_s - m)
//    acc_s: no atomics, so results repeat bit for bit.  Split 0 holds
//    position 0, which every query row sees, so the combined max is a real
//    score.
// Rows, pads and the table: keys the stage did not load (past the table,
// or the padding of the last 16-key chunk) are zero in shared memory and
// masked, so a masked key adds exactly 0; keys a row's table maps to
// scratch page 0 are read as the plain version reads them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemv_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 128;     // python: ops/attention.py PREFILL_THREADS
constexpr int kStages = 3;        // python: ops/attention.py PREFILL_STAGES
constexpr float kNeg = -1e30f;

// The shared-memory carve-up, mirrored by ops/attention.py
// prefill_smem_bytes: the query tile (mt_n·16 rows of ld bf16), then the
// ring (kStages stages), then, for int8, the dequantized K and V tiles;
// after the walk the warps' (acc[Dh], m, l) records reuse everything past
// the query tile.
struct Carve {
  int ld, skp, q_bytes, tile_bytes, stage_bytes, ring_bytes, conv_bytes;
  __host__ __device__ Carve(int rows, int ps, int dh, int pp, bool int8) {
    ld = dh + 8;
    skp = (pp * ps + 15) / 16 * 16;
    q_bytes = (rows + 15) / 16 * 16 * ld * 2;
    tile_bytes = skp * ld * 2;
    stage_bytes = int8 ? (pp * ps * dh * 2 + pp * ps * 8 + 15) / 16 * 16 : 2 * tile_bytes;
    ring_bytes = kStages * stage_bytes;
    conv_bytes = int8 ? 2 * tile_bytes : 0;
  }
};

// Pass 1: split blockIdx.z of row blockIdx.y for kv head blockIdx.x.  DH:
// the head dim; MPW: m16 tiles a warp (2 above 64 query rows).
template <int DH, typename KV, int MPW>
__global__ void __launch_bounds__(kThreads)
prefill_split(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ pool_k,
              const KV* __restrict__ pool_v, const float* __restrict__ scale_k,
              const float* __restrict__ scale_v, const int* __restrict__ layer_p,
              const int* __restrict__ page_table, const int* __restrict__ pos_rows,
              float* __restrict__ part, int hq, int hkv, int t_q, int ps, int maxp, int n_pages,
              int n_layers, int n_splits, int pps, int pp, float sqrt_dh) {
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  constexpr int LD = DH + 8;
  constexpr int REC = DH + 2;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g_n = hq / hkv;
  const int rows = g_n * t_q;
  const int mt_n = (rows + 15) / 16;

  // the wrapper validates the layer on the host; clamping keeps a bad
  // device value from reading outside the pool
  const int layer = min(max(*layer_p, 0), n_layers - 1);
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int hi = min(pos + t_q - 1, maxp * ps - 1);  // the block's last visible key
  const int n_live = hi / ps + 1;
  const int p_begin = split * pps;
  const int p_end = min(n_live, p_begin + pps);
  if (p_begin >= p_end) return;  // a dead split: pass 2 stops before it

  // warp roles: `mtw` tile slots, `kg_n` key groups a tile
  const int mtw = MPW == 2 ? 4 : (mt_n <= 1 ? 1 : (mt_n <= 2 ? 2 : 4));
  const int kg_n = kThreads / 32 / mtw;
  const int kg = warp / mtw;
  const int mt0 = warp % mtw;

  const Carve cv(rows, ps, DH, pp, kInt8);
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + cv.q_bytes;
  __nv_bfloat16* k_conv = reinterpret_cast<__nv_bfloat16*>(ring + cv.ring_bytes);
  __nv_bfloat16* v_conv = k_conv + cv.skp * LD;

  // the query tile: the block's rows are contiguous in q, row m = g·T + i
  const long q_off = (static_cast<long>(b) * hq + static_cast<long>(h) * g_n) * t_q * DH;
  for (int e = tid; e < mt_n * 16 * (DH / 8); e += kThreads) {
    const int r = e / (DH / 8);
    const int c = e % (DH / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) {
      v = *reinterpret_cast<const uint4*>(q + q_off + static_cast<long>(r) * DH + c * 8);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c * 8) = v;
  }

  const int page_elems = ps * DH;
  const int* row_table = page_table + static_cast<long>(b) * maxp;
  const int n_tiles = (p_end - p_begin + pp - 1) / pp;

  auto fetch = [&](int t) {
    unsigned char* st = ring + (t % kStages) * cv.stage_bytes;
    const int p0 = p_begin + t * pp;
    const int npg = min(pp, p_end - p0);
    for (int j = 0; j < npg; ++j) {
      const int pid = min(max(row_table[p0 + j], 0), n_pages - 1);
      const long head = (static_cast<long>(layer) * n_pages + pid) * hkv + h;
      if (kInt8) {
        int8_t* ks = reinterpret_cast<int8_t*>(st);
        int8_t* vs = ks + pp * page_elems;
        float* sks = reinterpret_cast<float*>(vs + pp * page_elems);
        float* svs = sks + pp * ps;
        const char* gk = reinterpret_cast<const char*>(pool_k) + head * page_elems;
        const char* gv = reinterpret_cast<const char*>(pool_v) + head * page_elems;
        for (int i = tid; i < page_elems / 16; i += kThreads) {
          cp_async_zfill<16>(ks + j * page_elems + 16 * i, gk + 16 * i, true);
          cp_async_zfill<16>(vs + j * page_elems + 16 * i, gv + 16 * i, true);
        }
        for (int i = tid; i < ps; i += kThreads) {
          cp_async_zfill<4>(sks + j * ps + i, scale_k + head * ps + i, true);
          cp_async_zfill<4>(svs + j * ps + i, scale_v + head * ps + i, true);
        }
      } else {
        __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(st);
        __nv_bfloat16* vt = kt + cv.skp * LD;
        const __nv_bfloat16* gk =
            reinterpret_cast<const __nv_bfloat16*>(pool_k) + head * page_elems;
        const __nv_bfloat16* gv =
            reinterpret_cast<const __nv_bfloat16*>(pool_v) + head * page_elems;
        for (int i = tid; i < page_elems / 8; i += kThreads) {
          const int r = j * ps + i / (DH / 8);
          const int c = i % (DH / 8);
          cp_async_zfill<16>(kt + r * LD + c * 8, gk + 8 * i, true);
          cp_async_zfill<16>(vt + r * LD + c * 8, gv + 8 * i, true);
        }
      }
    }
    if (!kInt8) {
      // tile rows past this stage's pages: zero, so a masked key adds 0
      __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(st);
      __nv_bfloat16* vt = kt + cv.skp * LD;
      for (int e = npg * ps * (DH / 8) + tid; e < cv.skp * (DH / 8); e += kThreads) {
        const int r = e / (DH / 8);
        const int c = e % (DH / 8);
        *reinterpret_cast<uint4*>(kt + r * LD + c * 8) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vt + r * LD + c * 8) = make_uint4(0, 0, 0, 0);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) fetch(t);
    cp_async_commit();
  }
  __syncthreads();  // the query tile is in shared memory

  uint32_t qf[MPW][DH / 16][4];
  float acc[MPW][DH / 8][4];
  float m[MPW][2], l[MPW][2];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int mt = mt0 + 4 * j;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      if (mt < mt_n) {
        ldmatrix_x4(qf[j][ks], q_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   ks * 16 + (lane >> 4) * 8);
      } else {
        qf[j][ks][0] = qf[j][ks][1] = qf[j][ks][2] = qf[j][ks][3] = 0u;
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;
    }
    m[j][0] = m[j][1] = kNeg;
    l[j][0] = l[j][1] = 0.f;
  }
  // each thread's two rows of a tile, and their causal ceilings
  int ceil_r[MPW][2];
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
    const int r0 = (mt0 + 4 * j) * 16 + (lane >> 2);
    ceil_r[j][0] = pos + r0 % t_q;
    ceil_r[j][1] = pos + (r0 + 8) % t_q;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed for all; stage t-1 and the tiles are free again
    if (t + kStages - 1 < n_tiles) fetch(t + kStages - 1);
    cp_async_commit();

    const int p0 = p_begin + t * pp;
    const int npg = min(pp, p_end - p0);
    const int key0 = p0 * ps;                          // logical position of tile row 0
    const int nvalid = min(npg * ps, hi - key0 + 1);   // rows that may be visible
    unsigned char* st = ring + (t % kStages) * cv.stage_bytes;
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if (kInt8) {
      const int8_t* ks = reinterpret_cast<const int8_t*>(st);
      const int8_t* vs = ks + pp * page_elems;
      const float* sks = reinterpret_cast<const float*>(vs + pp * page_elems);
      const float* svs = sks + pp * ps;
      // dequantize the stage into the bf16 tiles: bf16(f32(v) * scale);
      // rows past the stage's pages are zero
      for (int e = tid; e < cv.skp * (DH / 8); e += kThreads) {
        const int r = e / (DH / 8);
        const int c = e % (DH / 8);
        uint4 ko = make_uint4(0, 0, 0, 0), vo = make_uint4(0, 0, 0, 0);
        if (r < npg * ps) {
          const uint2 ku = *reinterpret_cast<const uint2*>(ks + r * DH + c * 8);
          const uint2 vu = *reinterpret_cast<const uint2*>(vs + r * DH + c * 8);
          const float sk = sks[r], sv = svs[r];
          uint32_t kw[4], vw[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t kb = i < 2 ? ku.x : ku.y;
            const uint32_t vb = i < 2 ? vu.x : vu.y;
            const int sh = (i & 1) * 16;
            const float k0 = static_cast<float>(static_cast<int8_t>((kb >> sh) & 0xFF));
            const float k1 = static_cast<float>(static_cast<int8_t>((kb >> (sh + 8)) & 0xFF));
            const float v0 = static_cast<float>(static_cast<int8_t>((vb >> sh) & 0xFF));
            const float v1 = static_cast<float>(static_cast<int8_t>((vb >> (sh + 8)) & 0xFF));
            kw[i] = bf16_bits(k0 * sk) | (bf16_bits(k1 * sk) << 16);
            vw[i] = bf16_bits(v0 * sv) | (bf16_bits(v1 * sv) << 16);
          }
          ko = make_uint4(kw[0], kw[1], kw[2], kw[3]);
          vo = make_uint4(vw[0], vw[1], vw[2], vw[3]);
        }
        *reinterpret_cast<uint4*>(k_conv + r * LD + c * 8) = ko;
        *reinterpret_cast<uint4*>(v_conv + r * LD + c * 8) = vo;
      }
      __syncthreads();
      kt = k_conv;
      vt = v_conv;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(st);
      vt = kt + cv.skp * LD;
    }

    const int n_chunks = (nvalid + 15) / 16;
    for (int ch = kg; ch < n_chunks; ch += kg_n) {
      if (mt0 >= mt_n) break;  // a warp with no query tile (3 tiles on 4 warps)
      // S = Q K^T for the chunk's 16 keys: two n8 tiles a warp tile
      float s[MPW][2][4];
#pragma unroll
      for (int j = 0; j < MPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][0][e] = s[j][1][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (ch * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ks * 16 +
                            ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          mma_bf16(s[j][0], qf[j][ks], kb[0], kb[1]);
          mma_bf16(s[j][1], qf[j][ks], kb[2], kb[3]);
        }
      }
      // the online softmax of each row; P into the A operand of PV
      uint32_t pa[MPW][4];
#pragma unroll
      for (int j = 0; j < MPW; ++j) {
        float mx[2] = {kNeg, kNeg};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = ch * 16 + nt * 8 + 2 * (lane & 3) + (e & 1);
            const bool ok = kr < nvalid && key0 + kr <= ceil_r[j][e >> 1];
            s[j][nt][e] = ok ? s[j][nt][e] / sqrt_dh : kNeg;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][nt][e]);
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xFFFFFFFFu, mx[r], 2));
          const float m_new = fmaxf(m[j][r], mx[r]);
          alpha[r] = expf(m[j][r] - m_new);
          m[j][r] = m_new;
          l[j][r] *= alpha[r];
        }
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[nt][e] = expf(s[j][nt][e] - m[j][e >> 1]);
            l[j][e >> 1] += p[nt][e];
          }
        }
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
          acc[j][n][0] *= alpha[0];
          acc[j][n][1] *= alpha[0];
          acc[j][n][2] *= alpha[1];
          acc[j][n][3] *= alpha[1];
        }
        pa[j][0] = bf16x2_bits(p[0][0], p[0][1]);
        pa[j][1] = bf16x2_bits(p[0][2], p[0][3]);
        pa[j][2] = bf16x2_bits(p[1][0], p[1][1]);
        pa[j][3] = bf16x2_bits(p[1][2], p[1][3]);
      }
      // O += P V: V by ldmatrix.trans, two n8 tiles of the head dim a load
#pragma unroll
      for (int n = 0; n < DH / 8; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (ch * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  (n + (lane >> 4)) * 8);
#pragma unroll
        for (int j = 0; j < MPW; ++j) {
          mma_bf16(acc[j][n], pa[j], vb[0], vb[1]);
          mma_bf16(acc[j][n + 1], pa[j], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the warps' records

  // each warp's (acc[Dh], m, l) of its rows; l summed over the quad first
  float* cs = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < MPW; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[j][r] += __shfl_xor_sync(0xFFFFFFFFu, l[j][r], 1);
      l[j][r] += __shfl_xor_sync(0xFFFFFFFFu, l[j][r], 2);
    }
    float* rec = cs + (warp * MPW + j) * 16 * REC;
    const int r0 = lane >> 2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int col = n * 8 + 2 * (lane & 3);
      rec[r0 * REC + col] = acc[j][n][0];
      rec[r0 * REC + col + 1] = acc[j][n][1];
      rec[(r0 + 8) * REC + col] = acc[j][n][2];
      rec[(r0 + 8) * REC + col + 1] = acc[j][n][3];
    }
    if ((lane & 3) == 0) {
      rec[r0 * REC + DH] = m[j][0];
      rec[r0 * REC + DH + 1] = l[j][0];
      rec[(r0 + 8) * REC + DH] = m[j][1];
      rec[(r0 + 8) * REC + DH + 1] = l[j][1];
    }
  }
  __syncthreads();
  // the key groups of each row merge in group order into the split's record
  for (int i = tid; i < rows * DH; i += kThreads) {
    const int row = i / DH;
    const int d = i % DH;
    const int mt = row / 16;
    const int r = row % 16;
    float mx = kNeg;
    for (int k = 0; k < kg_n; ++k) {
      const int w = MPW == 2 ? mt % 4 : k * mtw + mt;
      const int j = MPW == 2 ? mt / 4 : 0;
      mx = fmaxf(mx, cs[((w * MPW + j) * 16 + r) * REC + DH]);
    }
    float lsum = 0.f, a = 0.f;
    for (int k = 0; k < kg_n; ++k) {
      const int w = MPW == 2 ? mt % 4 : k * mtw + mt;
      const int j = MPW == 2 ? mt / 4 : 0;
      const float* e = cs + ((w * MPW + j) * 16 + r) * REC;
      const float wgt = expf(e[DH] - mx);
      lsum += wgt * e[DH + 1];
      a += wgt * e[d];
    }
    float* dst = part + ((static_cast<long>(b) * hq + static_cast<long>(h) * g_n) * t_q + row) *
                            n_splits * REC + static_cast<long>(split) * REC;
    dst[d] = a;
    if (d == 0) {
      dst[DH] = mx;
      dst[DH + 1] = lsum;
    }
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Pass 2: query row blockIdx.x (head·T + token) of row blockIdx.y combines
// its row's live splits in split order.
template <typename OT>
__global__ void __launch_bounds__(kThreads)
prefill_combine(const float* __restrict__ part, const int* __restrict__ pos_rows,
                OT* __restrict__ out, int hq, int t_q, int ps, int dh, int maxp, int n_splits,
                int pps) {
  const int row = blockIdx.x;
  const int b = blockIdx.y;
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int hi = min(pos + t_q - 1, maxp * ps - 1);
  const int live = min((hi / ps + 1 + pps - 1) / pps, n_splits);
  const int rec = dh + 2;
  const long r = static_cast<long>(b) * hq * t_q + row;
  const float* src = part + r * n_splits * rec;
  float mx = kNeg;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, src[s * rec + dh]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += expf(src[s * rec + dh] - mx) * src[s * rec + dh + 1];
  const float inv = 1.f / fmaxf(l, 1e-38f);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < live; ++s) a += expf(src[s * rec + dh] - mx) * src[s * rec + d];
    store(out + r * dh + d, a * inv);
  }
}

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

struct Args {
  const void *q, *pool_k, *pool_v, *scale_k, *scale_v, *layer, *page_table, *pos_rows;
  void *out, *part;
  int b, hq, hkv, t_q, ps, dh, maxp, n_pages, n_layers, n_splits, pps, pp;
  float sqrt_dh;
  cudaStream_t stream;
};

template <typename OT>
cudaError_t combine(const Args& a) {
  prefill_combine<OT><<<dim3(a.hq * a.t_q, a.b), kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<const int*>(a.pos_rows),
      static_cast<OT*>(a.out), a.hq, a.t_q, a.ps, a.dh, a.maxp, a.n_splits, a.pps);
  return cudaGetLastError();
}

template <int DH, typename KV, int MPW>
cudaError_t split_pass(const Args& a) {
  const bool int8 = std::is_same<KV, int8_t>::value;
  const int rows = a.hq / a.hkv * a.t_q;
  const Carve cv(rows, a.ps, DH, a.pp, int8);
  const int records = kThreads / 32 * MPW * 16 * (DH + 2) * 4;
  const int walk = cv.ring_bytes + cv.conv_bytes;
  const int rest = walk > records ? walk : records;
  const size_t smem = static_cast<size_t>(cv.q_bytes) + rest;
  auto kern = prefill_split<DH, KV, MPW>;
  static unsigned done = 0;
  cudaError_t e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.hkv, a.b, a.n_splits), kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.pool_k),
      static_cast<const KV*>(a.pool_v), static_cast<const float*>(a.scale_k),
      static_cast<const float*>(a.scale_v), static_cast<const int*>(a.layer),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.pos_rows),
      static_cast<float*>(a.part), a.hq, a.hkv, a.t_q, a.ps, a.maxp, a.n_pages, a.n_layers,
      a.n_splits, a.pps, a.pp, a.sqrt_dh);
  return cudaGetLastError();
}

template <int DH, typename KV>
cudaError_t split_mpw(const Args& a) {
  const int rows = a.hq / a.hkv * a.t_q;
  if (rows <= 64) return split_pass<DH, KV, 1>(a);
  if (rows <= 128) return split_pass<DH, KV, 2>(a);
  return cudaErrorInvalidValue;
}

template <int DH>
cudaError_t split_kv(int kv_dtype, const Args& a) {
  switch (kv_dtype) {
    case 1:
      return split_mpw<DH, __nv_bfloat16>(a);
    case 2:
      return split_mpw<DH, int8_t>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: bf16 (B, Hq, T, Dh); out_dtype: 0 float32, 1 bfloat16; kv_dtype: 1
// bfloat16, 2 int8 (scale_k/scale_v then point at the f32 scale planes).
// part: f32 scratch (B, Hq, T, n_splits, Dh + 2); the split plan (n_splits
// splits of pps pages, pp pages a stage) comes from ops/attention.py
// split_plan and prefill_stage_pages.  Dh is 64 or 128, Hq/Hkv·T at most
// 128.  Returns a cudaError_t: 0 when both launches were accepted.
extern "C" int paged_prefill_attention(const void* q, const void* pool_k, const void* pool_v,
                                       const void* scale_k, const void* scale_v,
                                       const void* layer, const void* page_table,
                                       const void* pos_rows, void* out, void* part,
                                       int out_dtype, int kv_dtype, int b, int hq, int hkv,
                                       int t_q, int ps, int dh, int maxp, int n_pages,
                                       int n_layers, int n_splits, int pps, int pp,
                                       float sqrt_dh, void* stream) {
  const Args a{q,   pool_k, pool_v,  scale_k, scale_v, layer,    page_table, pos_rows,
               out, part,   b,       hq,      hkv,     t_q,      ps,         dh,
               maxp, n_pages, n_layers, n_splits, pps, pp,      sqrt_dh,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  switch (dh) {
    case 64:
      e = split_kv<64>(kv_dtype, a);
      break;
    case 128:
      e = split_kv<128>(kv_dtype, a);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (out_dtype) {
    case 0:
      e = combine<float>(a);
      break;
    case 1:
      e = combine<__nv_bfloat16>(a);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
