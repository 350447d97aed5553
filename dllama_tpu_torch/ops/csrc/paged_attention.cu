// Fused paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dllama_tpu/ops/attention.py:394
// fused_paged_attention (Pallas body _make_fused_kernel, :320): one
// decode-step GQA read (T = 1) of q (B, Hq, Dh) against a paged KV pool
// (L, P, Hkv, ps, Dh) through a page table (B, maxp) int32, with per-row
// positions (B,) int32 and a layer index, all three read from device
// memory (the launch needs no host value, so a captured CUDA graph can
// replay it).  The pool is bf16 or f32, or int8 with a per-position f32
// scale plane (L, P, Hkv, ps, 1).
//
// Numerics follow the TPU kernel: q is rounded to the dot operand type
// (bf16 for bf16 and int8 pools), int8 values dequantize to
// bf16(f32(v) * scale), dots accumulate in f32 and are scaled by
// f32(1/sqrt(Dh)), key positions past pos_rows[b] score -1e30, the online
// softmax folds page by page (running max, denominator, numerator per
// query head), the probabilities are rounded to the operand type before
// the PV dot, and the output is acc / max(l, 1e-38) in q's type.
//
// Bound: bytes.  A decode step reads each row's live K/V prefix once
// (2 bytes an element in bf16, 1 + 4/Dh in int8) and does 4 flops per
// element read, far below the card's ~295 flops a byte.  This first
// design is simple: one block of 128 threads per (row b, kv head h)
// serves the head's G query heads; it walks only pages 0..pos_rows[b]/ps,
// staging each page's K and V in shared memory (dequantized to f32), a
// warp per (query head, position) score, a warp per query head softmax,
// and a thread per output element for PV.  Pages past the live prefix
// are never read.  Making it fast (split-K over pages, cp.async or TMA
// staging, tensor cores for G > 1) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // python: ops/attention.py THREADS
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One pool element → the f32 value of its dot operand.  kBf16: the
// operand type is bf16 (q and the probabilities round to it).
template <typename KV> struct Codec;
template <> struct Codec<float> {
  static constexpr bool kBf16 = false;
  __device__ static float get(const float* v, const float*, long i, long) { return v[i]; }
};
template <> struct Codec<__nv_bfloat16> {
  static constexpr bool kBf16 = true;
  __device__ static float get(const __nv_bfloat16* v, const float*, long i, long) {
    return __bfloat162float(v[i]);
  }
};
template <> struct Codec<int8_t> {
  static constexpr bool kBf16 = true;
  __device__ static float get(const int8_t* v, const float* sc, long i, long si) {
    return round_bf16(static_cast<float>(v[i]) * sc[si]);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename QT, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const QT* __restrict__ q, const KV* __restrict__ pool_k,
                       const KV* __restrict__ pool_v, const float* __restrict__ scale_k,
                       const float* __restrict__ scale_v, const int* __restrict__ layer_p,
                       const int* __restrict__ page_table, const int* __restrict__ pos_rows,
                       QT* __restrict__ out, int hq, int hkv, int ps, int dh, int maxp,
                       int n_pages, int n_layers, float inv_sqrt) {
  using C = Codec<KV>;
  const int h = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int g_n = hq / hkv;  // query heads served by this kv head
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int n_warps = kThreads / 32;

  // carve-up mirrored by ops/attention.py smem_bytes
  extern __shared__ float smem[];
  float* k_s = smem;                // ps * dh: this page's keys
  float* v_s = k_s + ps * dh;       // ps * dh: this page's values
  float* q_s = v_s + ps * dh;       // g_n * dh
  float* acc_s = q_s + g_n * dh;    // g_n * dh: running numerators
  float* p_s = acc_s + g_n * dh;    // g_n * ps: scores, then probabilities
  float* m_s = p_s + g_n * ps;      // g_n: running max
  float* l_s = m_s + g_n;           // g_n: running denominator
  float* a_s = l_s + g_n;           // g_n: this page's rescale factor

  // the wrapper validates the layer on the host; clamping keeps a bad
  // device value from reading outside the pool
  const int layer = min(max(*layer_p, 0), n_layers - 1);
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int n_live = pos / ps + 1;
  const long q_off = (static_cast<long>(b) * hq + static_cast<long>(h) * g_n) * dh;

  for (int i = tid; i < g_n * dh; i += kThreads) {
    const float x = to_f32(q[q_off + i]);
    q_s[i] = C::kBf16 ? round_bf16(x) : x;
    acc_s[i] = 0.f;
  }
  if (tid < g_n) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }

  const int* row_table = page_table + static_cast<long>(b) * maxp;
  for (int p = 0; p < n_live; ++p) {
    const int pid = min(max(row_table[p], 0), n_pages - 1);
    const long head = (static_cast<long>(layer) * n_pages + pid) * hkv + h;
    const long base = head * ps * dh;
    const long sbase = head * ps;
    for (int i = tid; i < ps * dh; i += kThreads) {
      k_s[i] = C::get(pool_k, scale_k, base + i, sbase + i / dh);
      v_s[i] = C::get(pool_v, scale_v, base + i, sbase + i / dh);
    }
    __syncthreads();

    // scores: one warp per (query head, page position)
    for (int j = warp; j < g_n * ps; j += n_warps) {
      const int g = j / ps;
      const int s = j - g * ps;
      float dot = 0.f;
      for (int d = lane; d < dh; d += 32) dot += q_s[g * dh + d] * k_s[s * dh + d];
      dot = warp_sum(dot);
      if (lane == 0) p_s[j] = (p * ps + s <= pos) ? dot * inv_sqrt : kNeg;
    }
    __syncthreads();

    // online softmax over the page: one warp per query head
    for (int g = warp; g < g_n; g += n_warps) {
      float mx = kNeg;
      for (int s = lane; s < ps; s += 32) mx = fmaxf(mx, p_s[g * ps + s]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < ps; s += 32) {
        const float e = expf(p_s[g * ps + s] - m_new);
        sum += e;
        p_s[g * ps + s] = C::kBf16 ? round_bf16(e) : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: one thread per output element
    for (int i = tid; i < g_n * dh; i += kThreads) {
      const int g = i / dh;
      const int d = i - g * dh;
      float pv = 0.f;
      for (int s = 0; s < ps; ++s) pv += p_s[g * ps + s] * v_s[s * dh + d];
      acc_s[i] = a_s[g] * acc_s[i] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < g_n * dh; i += kThreads) {
    store(out + q_off + i, acc_s[i] / fmaxf(l_s[i / dh], 1e-38f));
  }
}

template <typename QT, typename KV>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* scale_k,
                   const void* scale_v, const void* layer, const void* page_table,
                   const void* pos_rows, void* out, int b, int hq, int hkv, int ps, int dh,
                   int maxp, int n_pages, int n_layers, float inv_sqrt, cudaStream_t stream) {
  const int g_n = hq / hkv;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(ps) * dh + 2 * g_n * dh +
                                       g_n * ps + 3 * g_n);
  auto kern = paged_attention_kernel<QT, KV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(hkv, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(pool_k), static_cast<const KV*>(pool_v),
      static_cast<const float*>(scale_k), static_cast<const float*>(scale_v),
      static_cast<const int*>(layer), static_cast<const int*>(page_table),
      static_cast<const int*>(pos_rows), static_cast<QT*>(out), hq, hkv, ps, dh, maxp, n_pages,
      n_layers, inv_sqrt);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_dtype, const void* q, const void* pool_k, const void* pool_v,
                      const void* scale_k, const void* scale_v, const void* layer,
                      const void* page_table, const void* pos_rows, void* out, int b, int hq,
                      int hkv, int ps, int dh, int maxp, int n_pages, int n_layers,
                      float inv_sqrt, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table, pos_rows,
                               out, b, hq, hkv, ps, dh, maxp, n_pages, n_layers, inv_sqrt,
                               stream);
    case 1:
      return launch<QT, __nv_bfloat16>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                                       pos_rows, out, b, hq, hkv, ps, dh, maxp, n_pages,
                                       n_layers, inv_sqrt, stream);
    case 2:
      return launch<QT, int8_t>(q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                                pos_rows, out, b, hq, hkv, ps, dh, maxp, n_pages, n_layers,
                                inv_sqrt, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 float32, 1 bfloat16 (the output's too); kv_dtype: 0 float32,
// 1 bfloat16, 2 int8 (scale_k/scale_v then point at the f32 scale
// planes).  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int paged_attention(const void* q, const void* pool_k, const void* pool_v,
                               const void* scale_k, const void* scale_v, const void* layer,
                               const void* page_table, const void* pos_rows, void* out,
                               int q_dtype, int kv_dtype, int b, int hq, int hkv, int ps,
                               int dh, int maxp, int n_pages, int n_layers, float inv_sqrt,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (q_dtype) {
    case 0:
      e = launch_kv<float>(kv_dtype, q, pool_k, pool_v, scale_k, scale_v, layer, page_table,
                           pos_rows, out, b, hq, hkv, ps, dh, maxp, n_pages, n_layers, inv_sqrt,
                           s);
      break;
    case 1:
      e = launch_kv<__nv_bfloat16>(kv_dtype, q, pool_k, pool_v, scale_k, scale_v, layer,
                                   page_table, pos_rows, out, b, hq, hkv, ps, dh, maxp,
                                   n_pages, n_layers, inv_sqrt, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
