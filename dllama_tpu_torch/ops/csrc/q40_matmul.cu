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
// the tensor-core body of csrc/wgmma_matmul.cuh for t >= T_MMA (prefill
// chunks, mixed steps, lockstep batches; ops/q40.py route), one template
// with the Q80 kernel's.  In both, folded and exact cost
// fewer instructions a weight than classic (a byte permute, a LOP3 and one
// bf16x2 FMA for two weights, against a LOP3 and an FMA a weight and a
// bf16x2 convert) plus a per-block fold of the block sums into the
// accumulators; the block sums are taken once a call (decode body) or once
// a step (tensor-core body) from the staged x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "wgmma_matmul.cuh"

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
      return run_wgmma<Q4>(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes, bm,
                           splits, steps_per, tma, w_al, s_al, lay, d, 1, stream);
    case kFolded:
      return run_wgmma<Q4V<kFolded>>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                     n_planes, bm, splits, steps_per, tma, w_al, s_al, lay, d,
                                     1, stream);
    case kExact:
      return run_wgmma<Q4V<kExact>>(x, qpacked, scales, out, scratch, idx, t, n, np, d,
                                    n_planes, bm, splits, steps_per, tma, w_al, s_al, lay, d, 1,
                                    stream);
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
  return run_wgmma<Q4>(x, qpacked, scales, out, scratch, idx, t, n, np, d, n_planes, bm, splits,
                       steps_per, tma, w_al, s_al, Blocked{bn, td, nJ}, td, nJ, stream);
}

// The tensor-core body's block at tile height bm (ops/q40.py MMA_SMEM,
// MMA_STAGES hold the same numbers): out[0] threads, out[1] dynamic shared
// memory in bytes, out[2] ring stages.  Launches nothing.
extern "C" int q40_mma_layout(int bm, int* out) { return wg_layout<Q4>(bm, out); }

extern "C" const char* q40_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
