// B4: one-token decoder cross-attention against the int8 cross cache of
// layer `layer`, with both attention dots as int8 x int8 -> int32.
//
// Replaces whisper_tpu/ops/cross_attention.py:cross_attend_step_packed with
// int8_mxu=True (_kernel_int8_mxu).  Contract: q (bf16, pre-scaled) is
// quantized per head (absmax/127, round half to even, clip +-127), as the
// JAX wrapper does it;
//   scores = (q8 . K8 as int32) * (q_scale * k_scale[layer]);
//   columns >= s_valid masked;  e = exp(s - max);
//   p8 = round_half_even(127 * e)  (rint, NOT floor(x + 0.5));
//   ctx = (p8 . V8 as int32) * (v_scale / (127 * sum e)), written in bf16.
//
// Layout: the port keeps the prefill layout [L, B, H, S, 64] int8 for both
// K and V (no head-pair packing onto 128 lanes, no transposed K: those
// existed for Mosaic), so a head's rows are contiguous.
//
// What bounds it on the H100: per call it streams one layer's K and V: at
// whisper-base bucket 16, 16*8*1500*64*2 = 24.6 MB (7.35 us at 3.35 TB/s)
// for 49 M int8 operations, so bytes bound it; and at 762 calls a file the
// launches in front of it bound it first.  Design:
//   * One launch and nothing else: the kernel quantizes q itself and forms
//     q_scale * k_scale; it takes the whole [L, B, H] scales and `layer`.
//   * A thread-block cluster per (b, h), a block of 192 threads per segment
//     of CROSS_SEG = 192 rows (8 blocks at S = 1500; a block walks several
//     segments where S has more than 8), so that every SM holds several
//     blocks pulling bytes: 1,024 blocks at bucket 16.
//   * Each block asks for its K and its V segment (12 KB each, contiguous)
//     as bulk asynchronous copies at entry, so V lands while the scores are
//     computed and all 24.6 MB are in flight at once.
//   * Phase 1: scores (four threads a row, __dp4a) into shared memory, the
//     block's max; the cluster's max through distributed shared memory.
//     Phase 2: e, p8, the segment's sum of e, and the segment's int32 p8 . V8
//     with V read in 16-byte vectors (cross_pv).  Rank 0 adds the int32
//     partials (exact in any order) and the segments' sums in segment order
//     and writes the 64 outputs.  No second launch, no atomics.
//   * The order of the fp32 sum is cross_attention.cuh's, a function of S
//     alone, which the multi-query kernel (B7) repeats in its one block: the
//     two agree bit for bit.
#include <cooperative_groups.h>

#include "cross_attention.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = CROSS_SEG;      // a thread a row of the segment
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int SEG_BYTES = CROSS_SEG * CROSS_DH;

// What the other blocks of the cluster read of this one.
struct Shared {
  float max;
  int ctx[CROSS_DH];
};

__global__ void __launch_bounds__(NT)
cross_step_kernel(const bf16* __restrict__ q, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int8_t* __restrict__ k8, const int8_t* __restrict__ v8,
                  bf16* __restrict__ out, int B, int H, int S, int layer,
                  int s_valid, int n_own) {
  // [K segment][V segment][scores n_own * SEG][segment sums n_own][p8 SEG]
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem);
  int8_t* sV = sK + SEG_BYTES;
  float* sS = reinterpret_cast<float*>(sV + SEG_BYTES);
  float* seg_sum = sS + (size_t)n_own * CROSS_SEG;
  int8_t* sP8 = reinterpret_cast<int8_t*>(seg_sum + ((n_own + 1) & ~1));
  __shared__ Shared sh;
  __shared__ __align__(16) int8_t sq8[CROSS_DH];
  __shared__ float sq_scale, gsum[CROSS_SEG_GROUPS], red[NT / 32];
  __shared__ int part[NT / 32][CROSS_DH];
  __shared__ __align__(8) uint64_t bars[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_rank = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / n_rank;              // b * H + h
  const size_t lrow = (size_t)layer * B * H + head;
  const int8_t* kc = k8 + lrow * (size_t)S * CROSS_DH;
  const int8_t* vc = v8 + lrow * (size_t)S * CROSS_DH;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t bar_k = smem_u32(&bars[0]), bar_v = smem_u32(&bars[1]);

  // Segment i of this block is segment rank + i * n_rank of the head.
  auto seg_row0 = [&](int i) { return (rank + i * n_rank) * CROSS_SEG; };
  auto seg_rows = [&](int i) {
    return max(0, min(CROSS_SEG, S - seg_row0(i)));
  };
  auto fetch = [&](int8_t* dst, const int8_t* src, int i, uint32_t bar) {
    const uint32_t bytes = (uint32_t)seg_rows(i) * CROSS_DH;
    mbar_arrive_expect_tx(bar, bytes);
    if (bytes)
      bulk_load_1d(smem_u32(dst), src + (size_t)seg_row0(i) * CROSS_DH, bytes,
                   bar);
  };

  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_fence_init();
    fetch(sK, kc, 0, bar_k);
    fetch(sV, vc, 0, bar_v);
  }
  if (warp == 1) {
    const float qs = cross_quantize_q(q + (size_t)head * CROSS_DH, sq8);
    if (lane == 0) sq_scale = qs;
  }
  __syncthreads();  // the barriers and q8 are visible
  const float qk_scale = __fmul_rn(sq_scale, k_scale[lrow]);

  // ---- phase 1: scores of the block's segments, the cluster's max ----
  float lmax = -FLT_MAX;
  for (int i = 0; i < n_own; ++i) {
    if (i > 0) {
      __syncthreads();  // segment i - 1 of K has been read
      if (tid == 0) {
        async_proxy_fence();
        fetch(sK, kc, i, bar_k);
      }
    }
    mbar_wait(bar_k, i & 1);
    lmax = fmaxf(lmax, cross_scores<NT>(reinterpret_cast<const int*>(sq8),
                                        qk_scale, sK, seg_rows(i), seg_row0(i),
                                        s_valid, sS + i * CROSS_SEG));
  }
  lmax = warp_max(lmax);
  if (lane == 0) red[warp] = lmax;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) m = fmaxf(m, red[w]);
    sh.max = m;
  }
  cluster.sync();
  float m = -FLT_MAX;
  for (int r = 0; r < n_rank; ++r)
    m = fmaxf(m, cluster.map_shared_rank(&sh, r)->max);

  // ---- phase 2: e, p8, the segments' sums, the block's p8 . V8 ----
  int ctx = 0;
  for (int i = 0; i < n_own; ++i) {
    if (i > 0) {
      __syncthreads();  // segment i - 1 of V and its p8 have been read
      if (tid == 0) {
        async_proxy_fence();
        fetch(sV, vc, i, bar_v);
      }
    }
    const int rows = seg_rows(i);
    const float gs = cross_group_softmax(sS + i * CROSS_SEG + 32 * warp,
                                         rows - 32 * warp, m, sP8 + 32 * warp);
    if (lane == 0) gsum[warp] = gs;
    __syncthreads();
    if (tid == 0) seg_sum[i] = cross_segment_sum(gsum, CROSS_SEG_GROUPS);
    mbar_wait(bar_v, i & 1);
    ctx += cross_pv<NT>(sP8, sV, rows, part);
  }
  if (tid < CROSS_DH) sh.ctx[tid] = ctx;
  cluster.sync();

  // ---- rank 0: the partial contexts, the sums in segment order ----
  if (rank == 0 && tid < CROSS_DH) {
    int total = 0;
    for (int r = 0; r < n_rank; ++r)
      total += cluster.map_shared_rank(&sh, r)->ctx[tid];
    float denom = 0.0f;
    for (int s = 0; s < n_seg; ++s)
      denom = __fadd_rn(
          denom, cluster.map_shared_rank(seg_sum, s % n_rank)[s / n_rank]);
    out[(size_t)head * CROSS_DH + tid] =
        cross_finish(total, v_scale[lrow], denom);
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

}  // namespace

WT_EXPORT int wt_cross_attend_step(const void* q, const void* k_scale,
                                   const void* v_scale, const void* k8,
                                   const void* v8, void* out, int B, int H,
                                   int S, int layer, int s_valid,
                                   void* stream) {
  if (B < 1 || H < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int n_seg = (S + CROSS_SEG - 1) / CROSS_SEG;
  const int n_rank = n_seg < MAX_CLUSTER ? n_seg : MAX_CLUSTER;
  const int n_own = (n_seg + n_rank - 1) / n_rank;
  const size_t smem = 2 * SEG_BYTES +
                      sizeof(float) * ((size_t)n_own * CROSS_SEG +
                                       ((n_own + 1) & ~1)) + CROSS_SEG;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        (const void*)cross_step_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * n_rank));
  cfg.blockDim = dim3(NT);
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
      &cfg, cross_step_kernel, (const bf16*)q, (const float*)k_scale,
      (const float*)v_scale, (const int8_t*)k8, (const int8_t*)v8, (bf16*)out,
      B, H, S, layer, s_valid, n_own);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
