// Q80 dequant-matmul for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces: the Pallas kernels of dllama_tpu/ops/q8.py — _q8_kernel
// (entered through _pallas_matmul, the 2-D wcls head) and
// _stacked_q8_kernel (entered through _pallas_matmul_stacked, the
// layer-stacked wqkv/wo/w13/w2 and the layer x expert up/gate/down):
//
//   y (t, d) f32 = bf16(x) (t, n) @ W,   W[k, j] = bf16(f32(v[k, j]) * f32(s[k/32, j]))
//
// one bf16 round of the file codec's f32 dequant, products of bf16 values
// (exact in f32) summed in f32: the TPU kernel's numerics.
//
// Storage (byte-identical to the JAX package): int8 values (np, d), one row
// per input position; f16 scales (np/32, d).  Rows past n (pack padding)
// have zero values and scales and are never read: the reduction stops at
// n, so x needs no zero padding to np (the padded rows would add 0 * 0).
// Stacked planes (layers, or layer x expert of an MoE stack) are one
// buffer; the plane to read is an int32 in device memory, read by every
// block (the counterpart of the TPU kernel's scalar-prefetched index), so
// an expert chosen by a top-k on the device needs no host read.
//
// What bounds it on this card: at decode (t = 1) each weight is read once
// and used once, so the kernel is bound by the bytes of the planes, 1.0625
// B/weight (1 value + 0.0625 scale), against 3.35 TB/s of HBM on an H100
// SXM: 7.2 GB per Llama-2-7B token, a floor of about 2.1 ms.
//
// Two bodies, each one template with the Q40 kernel's (the Q8 codec here):
// for calls of t < T_MMA rows (decode) the decode body of
// csrc/gemv_common.cuh, one launch a call; for t >= T_MMA (prefill chunks,
// mixed steps, lockstep batches; ops/q8.py route) the Hopper tensor-core
// body of csrc/wgmma_matmul.cuh.  There a step's 64 int8 rows x 128
// columns (8 KB, two 32-row TMA boxes, 128-byte swizzled) arrive with
// their two scale rows and the x tile through the producer warp's TMA ring
// on mbarriers, and each consumer thread dequantizes its two columns
// straight into wgmma's A registers (RS): a weight is one byte permute and
// one FFMA, exactly v * s, rounded to bf16 in pairs.  It dequantizes each
// weight once per BM rows of x (32 or 128; ops/q8.py mma_plan), where the
// decode body does so once per 8 rows; at 128 rows the planes' bytes and
// the products bound it about equally (1.0625 B and 256 operations a
// weight against 3.35 TB/s and 989 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_common.cuh"
#include "wgmma_matmul.cuh"

// The decode body (t < T_MMA; a call of more rows launches once a group of
// 8): x (t, n) bf16, t <= 8; qvals (n_planes, np, d) int8 (any leading
// dims, flattened); scales (n_planes, np/32, d) f16; idx one int32 in
// device memory, the plane to read (clamped to 0..n_planes-1); out (t, d)
// f32; the reduction over n cut into `splits` ranges of `kb_per`
// quantization blocks (ops/q40.py gemv_plan); with splits > 1, part
// (splits, ceil(d / 64), t, 64) f32 and count (ceil(d / 64)) int32, zero
// and left zero, the workspace where the splits of a column tile meet; vw
// the bytes of a value piece (8, 4 or 1, dividing d and the pointers).
// One launch.  Returns cudaGetLastError() after it (0 = success).
extern "C" int q8_matmul(const void* x, const void* qvals, const void* scales, void* out,
                         const void* idx, void* part, void* count, int t, int n, int np, int d,
                         int n_planes, int splits, int kb_per, int vw, void* stream) {
  return launch_gemv<Q8>(x, qvals, scales, out, idx, part, count, t, n, np, d, n_planes,
                         splits, kb_per, vw, RowMajor{d}, stream);
}

// The tensor-core body (t >= T_MMA): x (t, n) bf16 (16-byte aligned);
// qvals, scales, idx and out as q8_matmul; bm 32 or 128; the reduction
// over n cut into `splits` ranges of `steps_per` 64-row steps (ops/q8.py
// mma_plan), scratch (splits, t, d) f32 when splits > 1; tma 1 when the
// planes' rows and pointers are 16-byte aligned (the weights by TMA), else
// 0 and w_al / s_al the widest copy (16, 8, 4, or 0 for plain loads) that
// the value / scale rows allow.
extern "C" int q8_matmul_mma(const void* x, const void* qvals, const void* scales, void* out,
                             void* scratch, const void* idx, int t, int n, int np, int d,
                             int n_planes, int bm, int splits, int steps_per, int tma, int w_al,
                             int s_al, void* stream) {
  return run_wgmma<Q8>(x, qvals, scales, out, scratch, idx, t, n, np, d, n_planes, bm, splits,
                       steps_per, tma, w_al, s_al, RowMajor{d}, d, 1, stream);
}

// The tensor-core body's block at tile height bm (ops/q8.py MMA_SMEM,
// MMA_STAGES hold the same numbers): out[0] threads, out[1] dynamic shared
// memory in bytes, out[2] ring stages.  Launches nothing.
extern "C" int q8_mma_layout(int bm, int* out) { return wg_layout<Q8>(bm, out); }
