// A tiled bf16 product for Hopper with its epilogue as a template argument:
// C[M, N] = epilogue(A[M, K] . B[K, N]), A and B row-major bf16 in device
// memory, the sum in fp32.  Used by the encoder MLP (encoder_mlp.cu: FC1
// with bias + GELU, FC2 with bias + residual) and the fused encoder block
// (encoder_block.cu: the QKV product; the O product into an fp32 residual,
// FC1, FC2); any dense product of the port whose operands are laid out so
// can take it.
//
// Design: one block of two warpgroups and a warp per 128 x 128 tile of C,
// the column tiles of one row band in neighbouring blocks, so that a band of
// A is read from device memory once and from L2 after that.
//   * The last warp is the producer: one thread walks the depth in slices
//     of 64 and starts TMA loads (2-D tensor maps, 128-byte swizzle) of the
//     128 x 64 slice of A and of the 64 x 128 slice of B, as two boxes of
//     64 x 64, into a ring of slots, each with a full and an empty
//     mbarrier.  What lies past M or N arrives as zeros: that is the
//     ragged-edge load.
//   * Warpgroups 0 and 1 own 64 rows each.  A slice is four depth steps of
//     16; a step is one wgmma m64n128k16, A K-major (rows contiguous along
//     the depth) and B MN-major (the weight's rows are depth rows: the
//     transpose bit, two 64-value tiles 8 KB apart, 16 rows of 128 bytes a
//     step), both from shared memory.  One group of wgmma stays in flight:
//     the slot of slice s - 1 is released after slice s has been queued.
//   * The accumulators (64 fp32 registers a thread) go to the epilogue as
//     pairs of neighbouring columns: `epi(row, col, v0, v1)` for row < M,
//     col < N, col even.  N must be a multiple of 2 (here: of 64) and K of
//     64.
//   * BLOCKS = 2 puts two blocks on an SM, each with a ring of 3 slots, so
//     that one block's epilogue runs under the other's products; BLOCKS = 1
//     gives the one block a ring of 6, which is faster when the grid is at
//     most one block an SM anyway.  Measured on the H100, 128 x 256 tiles
//     (one block an SM, 128 accumulator registers) were faster at no shape
//     of the encoder MLP, and the TMA loads, not the products, are what the
//     kernel waits for (PERF.md, section 6).  `run` makes that choice from
//     the grid's size.
#pragma once

#include "hopper.cuh"

namespace gemm {

constexpr int BM = 128;            // rows a block: 64 a consumer warpgroup
constexpr int BN = 128;            // columns a block
constexpr int BK = 64;             // depth a ring slot
constexpr int NT = 288;            // two consumer warpgroups, a producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BOX_BYTES = BK * 64 * 2;  // one 64 x 64 box of B

constexpr int STAGE_BYTES = A_BYTES + (BN / 64) * B_BOX_BYTES;

template <int BLOCKS>
struct Ring {
  static_assert(BLOCKS == 1 || BLOCKS == 2, "one or two blocks an SM");
  static constexpr int STAGES = BLOCKS == 2 ? 3 : 6;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

template <int BLOCKS, class Epilogue>
__global__ void __launch_bounds__(NT, BLOCKS)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
            int n_tiles, Epilogue epi) {
  constexpr int STAGES = Ring<BLOCKS>::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle is a function of the address: tiles on 1 KB
  const uint32_t s_ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_bar = s_ring + STAGES * STAGE_BYTES;
  auto full = [&](int slot) { return s_bar + 8 * slot; };
  auto empty = [&](int slot) { return s_bar + 8 * (STAGES + slot); };

  const int m0 = (blockIdx.x / n_tiles) * BM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int k_slices = K / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    if (threadIdx.x == 256) {
      for (int s = 0; s < k_slices; ++s) {
        const int slot = s % STAGES;
        mbar_wait(empty(slot), ((s / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(slot), STAGE_BYTES);
        const uint32_t dst = s_ring + slot * STAGE_BYTES;
        tma_load_2d(dst, &map_a, full(slot), s * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(dst + A_BYTES + j * B_BOX_BYTES, &map_b, full(slot),
                      n0 + 64 * j, s * BK);
      }
    }
  } else {
    // ---- consumers: 64 rows a warpgroup ----
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int s = 0; s < k_slices; ++s) {
      const int slot = s % STAGES;
      mbar_wait(full(slot), (s / STAGES) & 1);
      const uint32_t a = s_ring + slot * STAGE_BYTES;
      const uint64_t da = wgmma_desc(a + wg * (64 * BK * 2));
      const uint64_t db = wgmma_desc(a + A_BYTES, B_BOX_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // 16 values = 32 bytes along A's row; 16 depth rows of 128 bytes
        // down B's tiles
        wgmma_m64n128k16_ss<1>(acc, da + 2 * kk, db + kk * (16 * 128 / 16), 1);
      wgmma_commit();
      wgmma_wait<1>();  // slice s - 1 has been read
      if (s > 0 && lane == 0) mbar_arrive(empty((s - 1) % STAGES));
    }
    wgmma_wait<0>();
    reg_fence(acc);

    // ---- epilogue: element i of a thread is row half (i >> 1) & 1,
    // column 8 * (i / 4) + 2 * (lane % 4) + (i & 1) ----
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = n0 + 8 * i + 2 * (lane % 4);
      if (col < N) {
        if (row < M) epi(row, col, acc[4 * i], acc[4 * i + 1]);
        if (row + 8 < M) epi(row + 8, col, acc[4 * i + 2], acc[4 * i + 3]);
      }
    }
  }
}

inline int tiles(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// bf16 [outer, inner] row-major in boxes of `box_outer` rows of 64 values.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, int outer,
                        int inner, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return make_tensor_map(map, ptr, 2, dims, strides, box);
}

// Launches C = epi(A . B) on `stream`; returns the CUDA error, 0 if none.
// A [M, K] and B [K, N] bf16 row-major on 16-byte boundaries, K % 64 == 0,
// N % 64 == 0.  `tiles(M, N)` blocks.
template <int BLOCKS, class Epilogue>
int launch(const void* a, const void* b, int M, int N, int K, Epilogue epi,
           cudaStream_t stream) {
  if (M < 1 || N < 64 || N % 64 || K < BK || K % BK)
    return (int)cudaErrorInvalidValue;
  if (!tensor_map_encoder()) return (int)cudaErrorNotSupported;
  CUtensorMap ma, mb;
  if (!make_map_2d(&ma, a, M, K, BM) || !make_map_2d(&mb, b, K, N, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      (const void*)gemm_kernel<BLOCKS, Epilogue>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BLOCKS>::SMEM_BYTES);
  if (rc != cudaSuccess) return (int)rc;
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  gemm_kernel<BLOCKS, Epilogue>
      <<<m_tiles * n_tiles, NT, Ring<BLOCKS>::SMEM_BYTES, stream>>>(
          ma, mb, M, N, K, n_tiles, epi);
  return (int)cudaGetLastError();
}

constexpr int SMS = 132;  // streaming multiprocessors of an H100

// `launch` with two blocks an SM where the grid has more blocks than the
// card has SMs, else with one block and the deeper ring.
template <class Epilogue>
int run(const void* a, const void* b, int M, int N, int K, Epilogue epi,
        cudaStream_t stream) {
  if (tiles(M, N) > SMS) return launch<2>(a, b, M, N, K, epi, stream);
  return launch<1>(a, b, M, N, K, epi, stream);
}

}  // namespace gemm
