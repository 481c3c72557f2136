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
// fp32 and the kernel indexes the layer itself (one scale a block, so a
// layer's slice need not lie on a 16-byte boundary), so the wrapper runs no
// torch op besides allocating the output.
//
// What bounds it on the H100: per call it streams one layer's K and V, at
// whisper-base bucket 16 16*8*1500*64*2 = 24.6 MB (7.3 us at 3.35 TB/s),
// for 2*16*8*1500*64*2 = 49 MFLOP of fp32 work, so bytes bound it; but
// widening 24.6 M int8 values with the conversion unit (16 a clock an SM)
// alone takes about 6 us, so no value is widened that way.
// Design, B4's: a thread-block cluster per (b, h), a block of 192 threads
// per segment of 192 rows (8 blocks at S = 1500; a block owns several
// segments where S has more than 8), so that every SM holds several blocks
// pulling bytes: 1,024 blocks at bucket 16.  Each block fetches its K and V
// segments by bulk copies at entry.  From shared memory: the scores by bf16
// mma.sync (K widened by a byte permute and one subtraction), p . V in
// 16-byte vectors with each product rounded to bf16 by __hmul2; the
// cluster's max, the segments' sums of e and their contexts are written
// into the blocks that read them, three cluster barriers in all.  The
// arithmetic is cross_attention.cuh's cross_dequant_cluster, which the
// verify pass (B7-dq, cross_attention_multi.cu) runs for each of its
// queries: every query of B7-dq is bit for bit this kernel's.
#include "cross_attention.cuh"

namespace {

__global__ void __launch_bounds__(DQ_NT)
cross_dequant_kernel(const bf16* __restrict__ q,
                     const float* __restrict__ k_scale,
                     const float* __restrict__ v_scale,
                     const int8_t* __restrict__ k8,
                     const int8_t* __restrict__ v8, bf16* __restrict__ out,
                     int B, int T, int H, int S, int layer, int s_valid,
                     int n_own, int qmax) {
  extern __shared__ __align__(128) unsigned char smem[];
  cross_dequant_cluster<1>(smem, q, k_scale, v_scale, k8, v8, out, B, T, H, S,
                           layer, s_valid, n_own, qmax);
}

}  // namespace

WT_EXPORT int wt_cross_attend_step_dequant(const void* q, const void* k_scale,
                                           const void* v_scale, const void* k8,
                                           const void* v8, void* out, int B,
                                           int H, int S, int layer,
                                           int s_valid, void* stream) {
  // q, out [B, H, 64] are [B, T = 1, H, 64]
  return cross_dequant_launch<1>(cross_dequant_kernel, q, k_scale, v_scale,
                                 k8, v8, out, B, 1, H, S, layer, s_valid,
                                 (cudaStream_t)stream);
}
