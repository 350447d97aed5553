// Fused paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/attention.py:394
// fused_paged_attention (Pallas body _make_fused_kernel, :320): one
// decode-step GQA read (T = 1) of q (B, Hq, Dh) against a paged KV pool
// (L, P, Hkv, ps, Dh) through a page table (B, maxp) int32, with per-row
// positions (B,) int32 and a layer index, all three read from device
// memory (the launch needs no host value, so a captured CUDA graph can
// replay it).  The pool is f32, bf16 or f16, or int8 with a per-position
// f32 scale plane (L, P, Hkv, ps, 1); q and the output are f32, bf16 or
// f16; Dh is any multiple of 16 up to 256, G = Hq / Hkv any count.
//
// Numerics follow the TPU kernel: q is rounded to the dot operand type
// (the pool's; bf16 for an int8 pool), int8 values dequantize to
// bf16(f32(v) * scale), dots accumulate in f32 and are scaled by
// f32(1/sqrt(Dh)), key positions past pos_rows[b] take no part (the TPU
// kernel's -1e30 score, whose weight is exactly 0), the softmax is online
// (running max, denominator, numerator per query head), the probabilities
// are rounded to the operand type before the PV dot, and the output is
// acc / max(l, 1e-38) in q's type.  The probabilities round at
// exp(s - m) for the running max m of the position group that folds s
// (below), not of one serial page walk, so the kernel differs from the
// plain version by the operand's rounding of the probabilities.
//
// Bound: bytes.  A decode step reads each row's live K/V prefix once
// (2 bytes an element in bf16, 1 + 4/Dh in int8) and does 4 flops per
// element read, far below the card's ~295 flops a byte.  The design is a
// split page walk (flash-decoding):
//  * Pass 1, grid (Hkv * NG, B, S): split s of row b walks its own `pps`
//    pages, clipped on the device to the row's live pages pos/ps + 1; a
//    split past them returns at once.  One block serves up to kHeads (8)
//    query heads of its kv head: all G of them up to G = 8, so every K/V
//    byte is read once; above it the G heads are cut into NG = ceil(G/8)
//    even head groups, blocks side by side in the grid, each reading the
//    kv head's pages (the later reads mostly from L2), since 16 heads'
//    q slices and numerators would not fit a thread's registers.  S and
//    pps come from host shapes alone (ops/attention.py split_plan),
//    enough blocks to fill the 132 SMs several times over even at G = 4.
//  * Pages arrive in a ring of kStages stages in shared memory through
//    16-byte cp.async (the int8 scales through 4-byte ones), as the pool
//    stores them, `pp` pages a stage: page p+1.. is in flight while page p
//    is scored, and one __syncthreads serves a whole stage.
//  * Each thread holds an 8-element slice of the head dim of q (in
//    registers, for every query head of its block) and reads the same
//    slice of K and V with one vector load from shared memory,
//    dequantizing in registers (no per-element divide); the Dh/8 threads
//    of a position add their dots with shuffles.  A position takes C
//    lanes, the power of two at or above Dh/8 (2..32), so that the
//    shuffles stay inside aligned lane groups: at a Dh that is not a power
//    of two (80, 96, ...) the last C - Dh/8 lanes of a group hold a zero
//    query slice and read their group's first slice again (a load under a
//    branch slowed the full widths on the card: it splits the loop's
//    scheduling), adding 0 to the dots; they store nothing.  The 128 threads
//    form 128/C position groups,
//    each with its own online softmax over the positions it folds, so no
//    position waits on a block-wide max; the groups combine once, at the
//    split's end, into the split's (m, l, acc[Dh]) in f32 scratch
//    (B, Hq, S, Dh + 2).
//  * Pass 2, grid (Hq, B): the row's live splits combine in split order,
//    m = max m_s, l = sum exp(m_s - m) l_s, acc = sum exp(m_s - m) acc_s:
//    no atomics, so results repeat bit for bit.  Split 0 holds position 0
//    of every row, so the combined max is a real score.
// Tensor cores are left out: at 4 flops a byte they would not move the
// bound.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;    // python: ops/attention.py THREADS
constexpr int kStages = 3;       // python: ops/attention.py STAGES
constexpr int kVec = 8;          // head-dim elements a thread holds
constexpr int kHeads = 8;        // python: ops/attention.py HEADS_A_BLOCK
constexpr int kMaxSmem = 232448; // python: ops/attention.py MAX_SMEM
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_f16(float x) { return __half2float(__float2half_rn(x)); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half_rn(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight pool elements at `s` (shared memory, 8-element aligned) → the f32
// values of their dot operand; round(x): x rounded to the operand type (q
// and the probabilities are).
template <typename KV> struct Codec;
template <> struct Codec<float> {
  __device__ static float round(float x) { return x; }
  __device__ static void load8(const float* s, float, float* v) {
    const float4 a = reinterpret_cast<const float4*>(s)[0];
    const float4 b = reinterpret_cast<const float4*>(s)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};
template <> struct Codec<__nv_bfloat16> {
  __device__ static float round(float x) { return round_bf16(x); }
  __device__ static void load8(const __nv_bfloat16* s, float, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};
template <> struct Codec<__half> {
  __device__ static float round(float x) { return round_f16(x); }
  __device__ static void load8(const __half* s, float, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};
template <> struct Codec<int8_t> {
  __device__ static float round(float x) { return round_bf16(x); }
  // each byte XORed with 0x80 is v + 128; a byte permute builds the float
  // 2^23 + v + 128, and subtracting 2^23 + 128 gives v exactly
  __device__ static void load8(const int8_t* s, float scale, float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(s);
    const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = __uint_as_float(__byte_perm(w[h], 0x4B000000u, 0x7650 + i)) - 8388736.0f;
        v[4 * h + i] = round_bf16(x * scale);
      }
    }
  }
};

// Lanes a position: the power of two at or above dh / kVec.
__host__ __device__ __forceinline__ int lanes_of(int dh) {
  int c = 1;
  while (c < dh / kVec) c *= 2;
  return c;
}

// q's element i as an f32, q of kind q_kind (0 f32, 1 bf16, 2 f16): read
// once a block, so a runtime switch, not a template
__device__ __forceinline__ float q_at(const void* q, long i, int q_kind) {
  if (q_kind == 0) return static_cast<const float*>(q)[i];
  if (q_kind == 1) return to_f32(static_cast<const __nv_bfloat16*>(q)[i]);
  return to_f32(static_cast<const __half*>(q)[i]);
}

// Pass 1: split blockIdx.z of row blockIdx.y for head group blockIdx.x %
// n_hg of kv head blockIdx.x / n_hg.  A head group is gb query heads (the
// last may hold fewer); G is gb rounded up to 1, 2, 4 or 8 (the registers
// of q and the numerators); g_n <= G are live.
template <typename KV, int G>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const void* __restrict__ q, int q_kind, const KV* __restrict__ pool_k,
                      const KV* __restrict__ pool_v, const float* __restrict__ scale_k,
                      const float* __restrict__ scale_v, const int* __restrict__ layer_p,
                      const int* __restrict__ page_table, const int* __restrict__ pos_rows,
                      float* __restrict__ part, int hq, int hkv, int ps, int dh, int maxp,
                      int n_pages, int n_layers, int n_splits, int pps, int pp, int n_hg,
                      int gb, float inv_sqrt) {
  using C = Codec<KV>;
  constexpr bool kScaled = std::is_same<KV, int8_t>::value;
  const int h = blockIdx.x / n_hg;
  const int g_lo = blockIdx.x % n_hg * gb;    // the group's first query head of kv head h
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int g_n = min(gb, hq / hkv - g_lo);
  const int tid = threadIdx.x;
  const int cpr = lanes_of(dh);               // threads a position: 2..32, a power of two
  const int shift = __ffs(cpr) - 1;
  const int ng = kThreads >> shift;           // position groups
  const int c = tid & (cpr - 1);              // this thread's slice of the head dim
  const bool on = c < dh / kVec;              // a lane past Dh holds zeros
  const int col = on ? c * kVec : 0;          // the slice it reads
  const int grp = tid >> shift;
  const int lane = tid & 31;
  const unsigned gmask =
      cpr == 32 ? 0xFFFFFFFFu : (((1u << cpr) - 1u) << (lane & ~(cpr - 1)));

  // the wrapper validates the layer on the host; clamping keeps a bad
  // device value from reading outside the pool
  const int layer = min(max(*layer_p, 0), n_layers - 1);
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int n_live = pos / ps + 1;
  const int p_begin = split * pps;
  const int p_end = min(n_live, p_begin + pps);
  if (p_begin >= p_end) return;  // a dead split: pass 2 stops before it

  // the block's first query head and its partial records
  const long head0 = static_cast<long>(b) * hq + static_cast<long>(h) * (hq / hkv) + g_lo;
  const long q_off = head0 * dh;
  float qr[G][kVec];
  float m[G], l[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const float x = g < g_n && on ? q_at(q, q_off + g * dh + c * kVec + k, q_kind) : 0.f;
      qr[g][k] = C::round(x);
      acc[g][k] = 0.f;
    }
  }

  // carve-up mirrored by ops/attention.py smem_bytes: kStages stages of
  // pp K pages, pp V pages (ps*dh elements each) and, for int8, pp K and
  // pp V scale rows (ps floats each); after the walk the same memory holds
  // the position groups' (acc[dh], m, l) of every query head
  extern __shared__ __align__(16) unsigned char smem[];
  const int page_elems = ps * dh;
  // a stage starts 16-byte aligned (an odd ps leaves int8 scale rows ragged)
  const int stage_bytes =
      (pp * (2 * page_elems * static_cast<int>(sizeof(KV)) + (kScaled ? 2 * ps * 4 : 0)) +
       15) & ~15;
  const int chunks = page_elems * static_cast<int>(sizeof(KV)) / 16;
  const int* row_table = page_table + static_cast<long>(b) * maxp;
  const int n_tiles = (p_end - p_begin + pp - 1) / pp;

  auto fetch = [&](int t) {
    unsigned char* st = smem + (t % kStages) * stage_bytes;
    KV* ks = reinterpret_cast<KV*>(st);
    KV* vs = ks + pp * page_elems;
    float* sks = reinterpret_cast<float*>(vs + pp * page_elems);
    float* svs = sks + pp * ps;
    const int p0 = p_begin + t * pp;
    const int npg = min(pp, p_end - p0);
    for (int j = 0; j < npg; ++j) {
      const int pid = min(max(row_table[p0 + j], 0), n_pages - 1);
      const long head = (static_cast<long>(layer) * n_pages + pid) * hkv + h;
      const char* gk = reinterpret_cast<const char*>(pool_k + head * page_elems);
      const char* gv = reinterpret_cast<const char*>(pool_v + head * page_elems);
      char* dk = reinterpret_cast<char*>(ks + j * page_elems);
      char* dv = reinterpret_cast<char*>(vs + j * page_elems);
      for (int i = tid; i < chunks; i += kThreads) {
        cp_async16(dk + 16 * i, gk + 16 * i);
        cp_async16(dv + 16 * i, gv + 16 * i);
      }
      if (kScaled) {
        for (int i = tid; i < ps; i += kThreads) {
          cp_async4(sks + j * ps + i, scale_k + head * ps + i);
          cp_async4(svs + j * ps + i, scale_v + head * ps + i);
        }
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) fetch(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed for all; stage t-1 is free again
    if (t + kStages - 1 < n_tiles) fetch(t + kStages - 1);
    cp_async_commit();

    const unsigned char* st = smem + (t % kStages) * stage_bytes;
    const KV* ks = reinterpret_cast<const KV*>(st);
    const KV* vs = ks + pp * page_elems;
    const float* sks = reinterpret_cast<const float*>(vs + pp * page_elems);
    const float* svs = sks + pp * ps;
    const int p0 = p_begin + t * pp;
    // the stage's pages are consecutive logical pages: its position s is
    // logical position p0*ps + s; fold only the live ones
    const int npos = min(min(pp, p_end - p0) * ps, pos - p0 * ps + 1);
    for (int s = grp; s < npos; s += ng) {
      float kv[kVec];
      C::load8(ks + s * dh + col, kScaled ? sks[s] : 0.f, kv);
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = 0.f;
#pragma unroll
        for (int k = 0; k < kVec; ++k) x = fmaf(qr[g][k], kv[k], x);
        dot[g] = x;
      }
      for (int o = cpr >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) dot[g] += __shfl_xor_sync(gmask, dot[g], o);
      }
      C::load8(vs + s * dh + col, kScaled ? svs[s] : 0.f, kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sc = dot[g] * inv_sqrt;
        if (sc > m[g]) {
          const float a = expf(m[g] - sc);
          l[g] *= a;
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[g][k] *= a;
          m[g] = sc;
        }
        const float e = expf(sc - m[g]);
        l[g] += e;
        const float p = C::round(e);
#pragma unroll
        for (int k = 0; k < kVec; ++k) acc[g][k] = fmaf(p, kv[k], acc[g][k]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the groups' states

  const int rec = dh + 2;
  float* cs = reinterpret_cast<float*>(smem);
  float* mine = cs + grp * g_n * rec;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < g_n && on) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) mine[g * rec + c * kVec + k] = acc[g][k];
      if (c == 0) {
        mine[g * rec + dh] = m[g];
        mine[g * rec + dh + 1] = l[g];
      }
    }
  }
  __syncthreads();
  // a group that folded no live position keeps m = -1e30, l = 0, acc = 0
  // and weighs exp(-1e30 - mx) = 0; group 0 folded position p_begin*ps
  for (int i = tid; i < g_n * dh; i += kThreads) {
    const int g = i / dh;
    const int d = i - g * dh;
    float mx = kNeg;
    for (int r = 0; r < ng; ++r) mx = fmaxf(mx, cs[(r * g_n + g) * rec + dh]);
    float lsum = 0.f, a = 0.f;
    for (int r = 0; r < ng; ++r) {
      const float* e = cs + (r * g_n + g) * rec;
      const float w = expf(e[dh] - mx);
      lsum += w * e[dh + 1];
      a += w * e[d];
    }
    float* dst = part + ((head0 + g) * n_splits + split) * rec;
    dst[d] = a;
    if (d == 0) {
      dst[dh] = mx;
      dst[dh + 1] = lsum;
    }
  }
}

// Pass 2: query head blockIdx.x of row blockIdx.y combines its row's live
// splits in split order.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ part, const int* __restrict__ pos_rows,
                        QT* __restrict__ out, int hq, int ps, int dh, int maxp, int n_splits,
                        int pps) {
  const int hd = blockIdx.x;
  const int b = blockIdx.y;
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int live = min((pos / ps + 1 + pps - 1) / pps, n_splits);
  const int rec = dh + 2;
  const float* src = part + (static_cast<long>(b) * hq + hd) * n_splits * rec;
  float mx = kNeg;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, src[s * rec + dh]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += expf(src[s * rec + dh] - mx) * src[s * rec + dh + 1];
  const float inv = 1.f / fmaxf(l, 1e-38f);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < live; ++s) a += expf(src[s * rec + dh] - mx) * src[s * rec + d];
    store(out + (static_cast<long>(b) * hq + hd) * dh + d, a * inv);
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

template <typename QT, typename KV, int G>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
                   const void* scale_v, const void* layer, const void* page_table,
                   const void* pos_rows, void* out, void* part, int b, int hq, int hkv,
                   int ps, int dh, int maxp, int n_pages, int n_layers, int n_splits, int pps,
                   int pp, int n_hg, int gb, float inv_sqrt, cudaStream_t stream) {
  const bool scaled = std::is_same<KV, int8_t>::value;
  const int q_kind = std::is_same<QT, float>::value ? 0
                     : std::is_same<QT, __nv_bfloat16>::value ? 1 : 2;
  const size_t stage = (static_cast<size_t>(pp) *
                            (2 * static_cast<size_t>(ps) * dh * sizeof(KV) +
                             (scaled ? 8 * ps : 0)) + 15) & ~static_cast<size_t>(15);
  const size_t groups = static_cast<size_t>(kThreads / lanes_of(dh)) * gb * (dh + 2) * 4;
  const size_t smem = stage * kStages > groups ? stage * kStages : groups;
  auto kern = paged_attention_split<KV, G>;
  static unsigned done = 0;
  cudaError_t e = opt_in(kern, &done);
  if (e != cudaSuccess) return e;
  kern<<<dim3(hkv * n_hg, b, n_splits), kThreads, smem, stream>>>(
      q, q_kind, static_cast<const KV*>(pool_k), static_cast<const KV*>(pool_v),
      static_cast<const float*>(scale_k), static_cast<const float*>(scale_v),
      static_cast<const int*>(layer), static_cast<const int*>(page_table),
      static_cast<const int*>(pos_rows), static_cast<float*>(part), hq, hkv, ps, dh, maxp,
      n_pages, n_layers, n_splits, pps, pp, n_hg, gb, inv_sqrt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attention_combine<QT><<<dim3(hq, b), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(pos_rows),
      static_cast<QT*>(out), hq, ps, dh, maxp, n_splits, pps);
  return cudaGetLastError();
}

template <typename QT, typename KV>
cudaError_t launch_g(const void* q, const void* pool_k, const void* pool_v,
                     const void* scale_k, const void* scale_v, const void* layer,
                     const void* page_table, const void* pos_rows, void* out, void* part,
                     int b, int hq, int hkv, int ps, int dh, int maxp, int n_pages,
                     int n_layers, int n_splits, int pps, int pp, float inv_sqrt,
                     cudaStream_t stream) {
  // G heads a kv head in n_hg even groups of at most kHeads
  const int g_all = hq / hkv;
  const int n_hg = (g_all + kHeads - 1) / kHeads;
  const int gb = (g_all + n_hg - 1) / n_hg;
#define DLLAMA_PA_LAUNCH(G)                                                                 \
  return launch<QT, KV, G>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table, pos_rows, \
                           out, part, b, hq, hkv, ps, dh, maxp, n_pages, n_layers,           \
                           n_splits, pps, pp, n_hg, gb, inv_sqrt, stream)
  if (gb <= 1) DLLAMA_PA_LAUNCH(1);
  if (gb <= 2) DLLAMA_PA_LAUNCH(2);
  if (gb <= 4) DLLAMA_PA_LAUNCH(4);
  if (gb <= 8) DLLAMA_PA_LAUNCH(8);
#undef DLLAMA_PA_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* pool_k, const void* pool_v,
                      const void* scale_k, const void* scale_v, const void* layer,
                      const void* page_table, const void* pos_rows, void* out, void* part,
                      int b, int hq, int hkv, int ps, int dh, int maxp, int n_pages,
                      int n_layers, int n_splits, int pps, int pp, float inv_sqrt,
                      cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch_g<QT, float>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                                 pos_rows, out, part, b, hq, hkv, ps, dh, maxp, n_pages,
                                 n_layers, n_splits, pps, pp, inv_sqrt, stream);
    case 1:
      return launch_g<QT, __nv_bfloat16>(q, pool_k, pool_v, scale_k, scale_v, layer,
                                         page_table, pos_rows, out, part, b, hq, hkv, ps, dh,
                                         maxp, n_pages, n_layers, n_splits, pps, pp,
                                         inv_sqrt, stream);
    case 2:
      return launch_g<QT, int8_t>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                                  pos_rows, out, part, b, hq, hkv, ps, dh, maxp, n_pages,
                                  n_layers, n_splits, pps, pp, inv_sqrt, stream);
    case 3:
      return launch_g<QT, __half>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                                  pos_rows, out, part, b, hq, hkv, ps, dh, maxp, n_pages,
                                  n_layers, n_splits, pps, pp, inv_sqrt, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16, 2 float16 (the output's too); kv_dtype:
// 0 float32, 1 bfloat16, 2 int8 (scale_k/scale_v then point at the f32
// scale planes), 3 float16.  dh: a multiple of 16 up to 256.  part: f32
// scratch (b, hq, n_splits, dh + 2); the split plan
// (n_splits splits of pps pages, pp pages a stage) comes from
// ops/attention.py split_plan and stage_pages.  Returns a cudaError_t: 0
// when both launches were accepted.
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const void* scale_k, const void* scale_v, const void* layer,
                               const void* page_table, const void* pos_rows, void* out,
                               void* part, int q_dtype, int kv_dtype, int b, int hq, int hkv,
                               int ps, int dh, int maxp, int n_pages, int n_layers,
                               int n_splits, int pps, int pp, float inv_sqrt, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case 0:
      e = launch_kv<float>(kv_dtype, q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                           pos_rows, out, part, b, hq, hkv, ps, dh, maxp, n_pages, n_layers,
                           n_splits, pps, pp, inv_sqrt, s);
      break;
    case 1:
      e = launch_kv<__nv_bfloat16>(kv_dtype, q, pool_k, pool_v, scale_k, scale_v, layer,
                                   page_table, pos_rows, out, part, b, hq, hkv, ps, dh, maxp,
                                   n_pages, n_layers, n_splits, pps, pp, inv_sqrt, s);
      break;
    case 2:
      e = launch_kv<__half>(kv_dtype, q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                            pos_rows, out, part, b, hq, hkv, ps, dh, maxp, n_pages, n_layers,
                            n_splits, pps, pp, inv_sqrt, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
