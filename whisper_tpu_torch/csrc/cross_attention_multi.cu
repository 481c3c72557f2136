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
// The int8 kernel: one block of 256 threads per (b, h).  The block copies
// its K and V tile ([S, 64] int8 each, 192 KB at S = 1500) into shared
// memory once, then loops over the T queries against the tile; a tile that
// does not fit 227 KB of shared memory (S > ~1730) stays in device memory,
// where the block's T passes find it in L2; the results are the same.  It
// reads a K row with four threads and V in 16-byte vectors (cross_scores,
// cross_pv).
//
// The dequantizing kernel: B6's cluster of 192-thread blocks a (b, h), a
// block a 192-row segment (cross_dequant_cluster).  Each block fetches its
// own K and V segments once, by bulk copies, and every query runs B6's
// functions against them; the queries go in chunks of DQ_MAX_QC, the columns
// of one mma for the scores, each chunk exchanging its maxima, its sums of
// e and its partial contexts under one cluster barrier each.  T is a
// runtime value with no upper limit.
#include "cross_attention.cuh"

namespace {

constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block may use on sm_90

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

// Copy n16 16-byte words from device to shared memory with the whole block.
__device__ __forceinline__ void stage_tile(int8_t* dst, const int8_t* src,
                                           int n16) {
  const int4* g = reinterpret_cast<const int4*>(src);
  int4* s = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < n16; i += CROSS_NT) s[i] = g[i];
}

// Bytes of the int8 kernel's scores [S], group sums [ceil(S / 32)] and p8
// [S rounded up to 8], in front of the tile.
__host__ __device__ inline size_t int8_head_bytes(int S) {
  return (((size_t)S * 4 + (size_t)((S + 31) / 32) * 4 + 7) & ~(size_t)7) +
         (((size_t)S + 7) & ~(size_t)7);
}

template <bool STAGE>
__global__ void __launch_bounds__(CROSS_NT)
cross_multi_int8_kernel(const bf16* __restrict__ q,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int8_t* __restrict__ k8,
                        const int8_t* __restrict__ v8, bf16* __restrict__ out,
                        int B, int T, int H, int S, int layer, int s_valid) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_groups = (S + 31) / 32;
  float* sS = reinterpret_cast<float*>(smem);                    // [S]
  float* gsum = sS + S;                                          // [n_groups]
  int8_t* sP8 = reinterpret_cast<int8_t*>(
      smem + (((size_t)(S + n_groups) * 4 + 7) & ~(size_t)7));
  int8_t* sK = reinterpret_cast<int8_t*>(smem + round16(int8_head_bytes(S)));
  int8_t* sV = sK + (size_t)S * CROSS_DH;
  __shared__ CrossScratch sc;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const size_t lrow = ((size_t)layer * B + b) * H + h;
  const size_t cbase = lrow * (size_t)S * CROSS_DH;
  const int8_t* kc = k8 + cbase;
  const int8_t* vc = v8 + cbase;
  if (STAGE) {
    stage_tile(sK, kc, S * CROSS_DH / 16);
    stage_tile(sV, vc, S * CROSS_DH / 16);
    kc = sK;
    vc = sV;
  }
  const float ks = k_scale[lrow], vs = v_scale[lrow];
  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)b * T + t) * H + h;
    __syncthreads();  // the tile is staged; the last query's scratch is free
    cross_head_int8(sc, q + row * CROSS_DH, ks, vs, kc, vc,
                    out + row * CROSS_DH, S, s_valid, sS, gsum, sP8);
  }
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

// Launch KERNEL<true> with the tile in shared memory when it fits, else
// KERNEL<false> against device memory.
template <typename K, typename... A>
int launch(K staged, K direct, size_t head_bytes, int B, int H, int S,
           cudaStream_t stream, A... args) {
  const size_t small = round16(head_bytes);
  const size_t big = small + 2 * (size_t)S * CROSS_DH;
  // sizeof(CrossScratch) of static shared memory counts against the limit
  if (big + sizeof(CrossScratch) + 64 <= SMEM_LIMIT) {
    cudaError_t rc = cudaFuncSetAttribute(
        (const void*)staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)big);
    if (rc != cudaSuccess) return (int)rc;
    staged<<<B * H, CROSS_NT, big, stream>>>(args...);
  } else {
    direct<<<B * H, CROSS_NT, small, stream>>>(args...);
  }
  return (int)cudaGetLastError();
}

}  // namespace

WT_EXPORT int wt_cross_attend_multi(const void* q, const void* k_scale,
                                    const void* v_scale, const void* k8,
                                    const void* v8, void* out, int B, int T,
                                    int H, int S, int layer, int s_valid,
                                    void* stream) {
  if (B < 1 || T < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  return launch(cross_multi_int8_kernel<true>, cross_multi_int8_kernel<false>,
                int8_head_bytes(S), B, H, S, (cudaStream_t)stream,
                (const bf16*)q, (const float*)k_scale, (const float*)v_scale,
                (const int8_t*)k8, (const int8_t*)v8, (bf16*)out, B, T, H, S,
                layer, s_valid);
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
