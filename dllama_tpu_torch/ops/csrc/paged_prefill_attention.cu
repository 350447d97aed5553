// Causal GQA over the paged KV pool for t > 1 query rows (kernel 8): the
// entry points, and the bf16 bodies' instantiations.  The design,
// the device code and the launch helpers are paged_prefill_attention.cuh.

#include "paged_prefill_attention.cuh"

namespace {

// Pass 2: a warp a query row (8 a block, rows in (row, head, token)
// order); a row whose group has several live splits (as walk_of counts
// them) combines them: lane s takes split s's max m_s and denominator l_s,
// m = max m_s and l = sum 2^(m_s - m) l_s by a fixed shuffle tree, then each
// lane adds acc = sum_s 2^(m_s - m) acc_s over its elements in split order,
// every split's loads in flight at once.  Fixed orders, no atomics: the
// results repeat bit for bit.
constexpr int kCombineWarps = 8;

__global__ void __launch_bounds__(32 * kCombineWarps)
prefill_combine(const float* __restrict__ part, const int* __restrict__ pos_rows,
                void* __restrict__ out, int out_kind, int b_n, int hq, int hkv, int t_q, int ps,
                int dh, int maxp, int n_splits, int pps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * kCombineWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long>(b_n) * hq * t_q) return;
  const int tok = static_cast<int>(row % t_q);
  const int head = static_cast<int>(row / t_q % hq);
  const int b = static_cast<int>(row / t_q / hq);
  const int g_n = hq / hkv;
  const int rows = rows_a_group(dh);
  const int r0 = ((head % g_n) * t_q + tok) / rows * rows;
  const int pos = min(max(pos_rows[b], 0), maxp * ps - 1);
  const int n_live = live_pages(pos, r0, min(g_n * t_q, r0 + rows), t_q, ps, maxp);
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
      if (d < dh) store_one(out, row * dh + d, out_kind, acc[k] * inv);
    }
  }
}

// pass 1 at padded head dim dhp on a pool of kv_dtype
cudaError_t pass1(int kv_dtype, int dhp, const Args& a) {
  switch (kv_dtype) {
    case 0:
      return dllama_prefill::pass1_f32(dhp, a);
    case 1:
      return pass1_tc<__nv_bfloat16>(dhp, a);
    case 2:
      return dllama_prefill::pass1_int8(dhp, a);
    case 3:
      return dllama_prefill::pass1_f16(dhp, a);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t combine(const Args& a) {
  const long rows = static_cast<long>(a.b) * a.hq * a.t_q;
  const unsigned blocks = static_cast<unsigned>((rows + kCombineWarps - 1) / kCombineWarps);
  prefill_combine<<<blocks, 32 * kCombineWarps, 0, a.stream>>>(
      static_cast<const float*>(a.part), static_cast<const int*>(a.pos_rows), a.out, a.out_kind,
      a.b, a.hq, a.hkv, a.t_q, a.ps, a.dh, a.maxp, a.n_splits, a.pps);
  return cudaGetLastError();
}

template <int DHP, typename KV, int NWG>
void tc_layout(int* out) {
  using B = Body<DHP, KV, NWG>;
  out[0] = NWG;
  out[1] = B::kThreads;
  out[2] = B::kSmem;
  out[3] = B::kStg;
  out[4] = B::kRebalance ? B::kConsumerRegs : 0;
  out[5] = rows_a_group(DHP);
}

template <int DHP, typename KV>
void tc_layout_wg(int rows, int* out) {
  if constexpr (DHP > 128) {
    tc_layout<DHP, KV, 1>(out);
  } else {
    warpgroups(rows, DHP) == 2 ? tc_layout<DHP, KV, 2>(out) : tc_layout<DHP, KV, 1>(out);
  }
}

template <int DHP>
int layout(int kv_dtype, int dh, int rows, int* out) {
  switch (kv_dtype) {
    case 0:
      out[0] = 0;
      out[1] = kRows;
      out[2] = f32_smem(dh);
      out[3] = 1;
      out[4] = 0;
      out[5] = rows_a_group(dh);
      return 0;
    case 1:
      tc_layout_wg<DHP, __nv_bfloat16>(rows, out);
      return 0;
    case 2:
      tc_layout_wg<DHP, int8_t>(rows, out);
      return 0;
    case 3:
      tc_layout_wg<DHP, __half>(rows, out);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A head dim a pool of kv_dtype takes: a multiple of 16 up to 256 (TMA rows
// are multiples of 16 bytes, wgmma's k is 16), for the f32 body a multiple
// of 4 up to 256 (its float4 loads).
bool head_dim_ok(int kv_dtype, int dh) {
  return dh > 0 && dh <= kMaxDh && dh % (kv_dtype == 0 ? 4 : 16) == 0;
}

}  // namespace

// The pass-1 block a launch of `rows` = G·T query rows a kv head takes on a
// pool of kv_dtype (as below) at head dim dh: out[0] consumer warpgroups (0
// for the f32 body), out[1] threads, out[2] dynamic shared memory in bytes,
// out[3] stages of the copy ring, out[4] registers a consumer thread after
// setmaxnreg (0: the block keeps its launch count), out[5] query rows a
// block (a row group).  Launches nothing.
extern "C" int paged_prefill_layout(int kv_dtype, int dh, int rows, int* out) {
  if (!head_dim_ok(kv_dtype, dh)) return static_cast<int>(cudaErrorInvalidValue);
  switch (padded_dh(dh)) {
    case 64:
      return layout<64>(kv_dtype, dh, rows, out);
    case 128:
      return layout<128>(kv_dtype, dh, rows, out);
    case 192:
      return layout<192>(kv_dtype, dh, rows, out);
    default:
      return layout<256>(kv_dtype, dh, rows, out);
  }
}

// q: (B, Hq, T, Dh) of the pool's operand type: bf16 for a bf16 or int8
// pool, f16 for an f16 pool, f32 for an f32 pool; out_dtype: 0 float32, 1
// bfloat16, 2 float16; kv_dtype: 0 float32, 1 bfloat16, 2 int8
// (scale_k/scale_v then point at the f32 scale planes), 3 float16.  part:
// f32 scratch (B, Hq, T, n_splits, Dh + 2), unused with one split; the plan
// (n_splits splits of pps pages) comes from ops/attention.py prefill_plan.
// Dh is a multiple of 16 up to 256 (f32: of 4); the pool holds fewer than
// 2^31 rows of Dh.  Returns a cudaError_t: 0 when every launch was accepted.
extern "C" int paged_prefill_attention(const void* q, const void* pool_k, const void* pool_v,
                                       const void* scale_k, const void* scale_v,
                                       const void* layer, const void* page_table,
                                       const void* pos_rows, void* out, void* part,
                                       int out_dtype, int kv_dtype, int b, int hq, int hkv,
                                       int t_q, int ps, int dh, int maxp, int n_pages,
                                       int n_layers, int n_splits, int pps, float sqrt_dh,
                                       void* stream) {
  if (out_dtype < 0 || out_dtype > 2 || !head_dim_ok(kv_dtype, dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,       pool_k,   pool_v,  scale_k, scale_v, layer, page_table,
               pos_rows, out,     part,    out_dtype, b,     hq,    hkv,
               t_q,     ps,       dh,      maxp,    n_pages, n_layers, n_splits,
               pps,     sqrt_dh,  static_cast<cudaStream_t>(stream)};
  const cudaError_t e = pass1(kv_dtype, padded_dh(dh), a);
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  return static_cast<int>(combine(a));
}
