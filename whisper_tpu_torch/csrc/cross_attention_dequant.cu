// B6: one-token decoder cross-attention against the int8 cross cache of
// layer `layer`, dequantized inside the kernel (rung x4).
//
// Replaces whisper_tpu/ops/cross_attention.py:cross_attend_step_packed with
// int8_mxu=False (_kernel).  Contract, as there (q bf16, pre-scaled by
// 64^-0.5, widened to fp32):
//   scores = (q . fp32(K8)) * k_scale[layer]   (fp32 dot);
//   columns >= s_valid masked;  e = exp(s - max);
//   p = bf16(e / sum e)          (normalized BEFORE the cast);
//   ctx = sum_s fp32(bf16(p * bf16(V8)))   (each product rounded to bf16,
//         as the JAX kernel's bf16 VPU multiply, the sum in fp32);
//   out = bf16(ctx * v_scale[layer]).
//
// Layout: the prefill layout [L, B, H, S, 64] int8 for K and V, as B4 reads
// it (no head-pair packing, no transposed K); the scales stay [L, B, H]
// fp32 and the kernel indexes the layer itself, so the wrapper runs no
// torch op besides allocating the output.
//
// What bounds it on the H100: per call it streams one layer's K and V, at
// whisper-base bucket 16 16*8*1500*64*2 = 24.6 MB (7.3 us at 3.35 TB/s),
// for 2*16*8*1500*64*2 = 49 MFLOP of fp32 work, so bytes bound it.
// Design: B4's skeleton, one block of 256 threads per (b, h): q is held in
// registers; each thread owns whole K rows (four 16-byte loads, 64 FMAs);
// block reductions give the max and the sum; the bf16 probabilities sit in
// shared memory; for P.V each thread owns one of the 64 columns for a
// quarter of the rows, so a warp reads 32 consecutive bytes of a V row.
// As with B4, 128 blocks leave each SM one block; more blocks per (b, h)
// with a second reduction pass is the next step.  The per-(b, h) arithmetic
// lives in cross_attention.cuh, shared with the multi-query kernel (B7).
#include "cross_attention.cuh"

namespace {

__global__ void __launch_bounds__(CROSS_NT)
cross_dequant_kernel(const bf16* __restrict__ q,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int8_t* __restrict__ k8,
                     const int8_t* __restrict__ v8, bf16* __restrict__ out,
                     int B, int H, int S, int layer, int s_valid) {
  extern __shared__ float sS[];                   // [S] scores, then e
  bf16* sP = reinterpret_cast<bf16*>(sS + S);     // [S] bf16 probabilities
  __shared__ CrossScratch sc;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t row = (size_t)b * H + h;
  const size_t lrow = ((size_t)layer * B + b) * H + h;
  const size_t cbase = lrow * (size_t)S * CROSS_DH;
  const int tid = threadIdx.x;

  if (tid < CROSS_DH)
    sc.qf[tid] = __bfloat162float(q[row * CROSS_DH + tid]);
  __syncthreads();
  cross_head_dequant(sc, k_scale[lrow], v_scale[lrow], k8 + cbase, v8 + cbase,
                     out + row * CROSS_DH, S, s_valid, sS, sP);
}

}  // namespace

WT_EXPORT int wt_cross_attend_step_dequant(const void* q, const void* k_scale,
                                           const void* v_scale, const void* k8,
                                           const void* v8, void* out, int B,
                                           int H, int S, int layer,
                                           int s_valid, void* stream) {
  const size_t smem = (size_t)S * (sizeof(float) + sizeof(bf16));
  cross_dequant_kernel<<<B * H, CROSS_NT, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const float*)k_scale, (const float*)v_scale,
      (const int8_t*)k8, (const int8_t*)v8, (bf16*)out, B, H, S, layer,
      s_valid);
  return (int)cudaGetLastError();
}
