// B7: T-query decoder cross-attention against the int8 cross cache of layer
// `layer`: the verify pass of speculative decoding (T = draft_k + 1 tokens
// per row and round).  Two kernels, as in the JAX package:
//   wt_cross_attend_multi          int8 x int8 dots   (per query what B4 does)
//   wt_cross_attend_multi_dequant  dequantizing       (per query what B6 does)
//
// Replaces whisper_tpu/ops/cross_attention.py:cross_attend_multi_packed
// (_kernel_multi_int8_mxu and _kernel_multi).  Contract: for each of the T
// queries of a row, bit for bit the output of the single-token kernel on
// that query; both kernels run the device functions of cross_attention.cuh
// in the order of summation fixed there.  q: [B, T, H, 64] bf16; the int8
// kernel quantizes each query per head itself and multiplies q_scale by
// k_scale[layer], with the device functions the single-token kernel uses.
//
// What bounds it on the H100: one layer's K and V, 24.6 MB at whisper-base
// bucket 16 (7.3 us at 3.35 TB/s), read once for all T queries: that single
// stream is the kernel's point.  T x 49 M int8 or fp32 operations stay
// below it for any T a draft uses.
//
// Both kernels run B4's layout: a thread-block cluster of 192-thread blocks
// a (b, h), a block a 192-row segment (8 blocks at S = 1500; a block owns
// several segments where S has more), so that every SM holds several blocks
// pulling bytes: 1,024 blocks at bucket 16.  Each block fetches its own K
// and V segments once, by bulk copies at entry, keeps them for all T
// queries, and runs the single-token kernel's device functions against them.
// T is a runtime value with no upper limit; S goes as far as n_own segments
// a block fit its shared memory (13,824 rows).
//
// The int8 kernel (cross_int8_cluster in cross_attention.cuh): the queries
// in chunks of eight, the columns of one int8 mma.sync for the scores; each
// chunk meets under two cluster barriers, its maxima, its segments' sums of
// e and its int32 contexts written into the blocks that read them.
//
// The dequantizing kernel (cross_dequant_cluster): the queries in chunks of
// DQ_MAX_QC, the columns of one bf16 mma for the scores, each chunk
// exchanging its maxima, its sums of e and its partial contexts under one
// cluster barrier each.
#include "cross_attention.cuh"

namespace {

__global__ void __launch_bounds__(I8_NT)
cross_multi_int8_kernel(const bf16* __restrict__ q,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8, bf16* __restrict__ out,
                        int B, int T, int H, int S, int layer, int s_valid,
                        int n_own) {
  extern __shared__ __align__(128) unsigned char i8_smem[];
  cross_int8_cluster(i8_smem, q, k_scale, v_scale, k8, v8, out, B, T, H, S,
                     layer, s_valid, n_own);
}

// The dequantizing kernel: B6's cluster (cross_dequant_cluster), each block
// holding its own K and V segments for all T queries, the queries in chunks
// of DQ_MAX_QC: three cluster barriers a chunk, not three a query.
__global__ void __launch_bounds__(DQ_NT)
cross_multi_dequant_kernel(const bf16* __restrict__ q,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int8_t* __restrict__ k8,
                           const int8_t* __restrict__ v8,
                           bf16* __restrict__ out, int B, int T, int H, int S,
                           int layer, int s_valid, int n_own, int qmax) {
  extern __shared__ __align__(128) unsigned char dq_smem[];
  cross_dequant_cluster<DQ_MAX_QC>(dq_smem, q, k_scale, v_scale, k8, v8, out,
                                   B, T, H, S, layer, s_valid, n_own, qmax);
}

}  // namespace

WT_EXPORT int wt_cross_attend_multi(const void* q, const void* k_scale,
                                    const void* v_scale, const void* k8,
                                    const void* v8, void* out, int B, int T,
                                    int H, int S, int layer, int s_valid,
                                    void* stream) {
  if (B < 1 || T < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int n_rank = n_seg < I8_MAX_CLUSTER ? n_seg : I8_MAX_CLUSTER;
  const int n_own = (n_seg + n_rank - 1) / n_rank;
  const size_t smem = cross_int8_smem(n_own, n_rank);
  if (smem > 48 * 1024) {
    cudaError_t rc = allow_smem((const void*)cross_multi_int8_kernel, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * n_rank));
  cfg.blockDim = dim3(I8_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)n_rank;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t rc = cudaLaunchKernelEx(
      &cfg, cross_multi_int8_kernel, (const bf16*)q, (const float*)k_scale,
      (const float*)v_scale, (const int8_t*)k8, (const int8_t*)v8, (bf16*)out,
      B, T, H, S, layer, s_valid, n_own);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

WT_EXPORT int wt_cross_attend_multi_dequant(const void* q, const void* k_scale,
                                            const void* v_scale,
                                            const void* k8, const void* v8,
                                            void* out, int B, int T, int H,
                                            int S, int layer, int s_valid,
                                            void* stream) {
  return cross_dequant_launch<DQ_MAX_QC>(cross_multi_dequant_kernel, q,
                                         k_scale, v_scale, k8, v8, out, B, T,
                                         H, S, layer, s_valid,
                                         (cudaStream_t)stream);
}
