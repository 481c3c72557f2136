// The two products around the attention of a fused decoder-step block, shared
// by B10a (decoder_self_block.cu) and B10b (decoder_cross_block.cu):
//
//   ln_gemm_kernel:  LN(x) -> r . W + bias for the <= 16 rows of a decode
//                    step; q columns kept in fp32 (times head_dim^-0.5), k
//                    and v columns rounded to bf16 into a row of the
//                    time-major self cache.
//   out_proj_kernel: bf16(ctx . W_o + b_o + x), launched as the attention
//                    kernel's programmatic dependent.
//
// Numerics of ln_gemm_kernel.  What B10a writes into the cache is held
// bitwise against the plain PyTorch version, so every value on the way to a
// cached k or v must not depend on the order of a sum.  The LayerNorm
// statistics and the product are therefore accumulated in fp64 and rounded
// to fp32 once: the products of bf16 values are exact in fp64 and a sum of
// a few hundred of them carries an error near 1e-15, so any order rounds to
// the same fp32 value (except where the exact sum lies within 1e-15 of a
// rounding boundary, once in ~1e7 values).  The steps between are single
// IEEE operations: mean32 = fp32(sum / d), rstd32 = fp32(1 / sqrt(var +
// 1e-5)), y = (x - mean32) * rstd32, r = bf16(y * scale + bias), each
// rounded once.  At <= 16 rows the product is 25 MFLOP, which the fp64 units
// do in microseconds; the weights (1.5 MB at d = 512) are the bytes.
//
// Design of ln_gemm_kernel on the H100.  The weights come in only as fast as
// there are loads in flight, so the stream is spread over every SM and all
// of it is issued at once (as B10c's FC1, decoder_mlp.cu), and no block
// repeats another's arithmetic:
//   * a cluster of 8 blocks per tile of 64 output columns (24 clusters, 192
//     blocks, for B10a's [512, 1536] QKV), each block an eighth of the
//     depth, so a block reads 64 rows of 128 contiguous bytes of W; where
//     that leaves SMs idle the tile narrows to 32, 16 or 8 columns (B10b's
//     [512, 512] Q: 16 columns, 256 blocks);
//   * at entry each block issues its W slice and the LayerNorm's parameters
//     at its depths as cp.async copies into shared memory, and once the
//     kernel before has ended, its two rows of x whole and the 16 rows at
//     its depths;
//   * the LayerNorm's statistics, 16 rows over 8 blocks: two rows a block,
//     64 threads a row, in fp64; mean32 and rstd32 written into every block
//     of the cluster (distributed shared memory), then r at the block's
//     depths, widened to fp64 once for every warp;
//   * the product on the fp64 tensor cores (mma.sync m8n8k4 f64, DMMA): the
//     16 rows as two m-tiles, a warp's n-tiles over the block's depths in
//     two chains of alternate steps;
//   * the 8 partial tiles meet column by column in the block that owns the
//     column (an eighth of the tile each) and are added there in rank
//     order, in fp64, then rounded once to fp32.
//   * It is the programmatic dependent of whatever kernel precedes it on
//     the stream (the O product of B10a, B10c's FC2, or the embedding's
//     addition), so its weights are fetched
//     while that one ends, and it lets its own dependent (the attention
//     kernel) start, so that kernel's copies are in flight while the
//     product runs: for B10a once its own copies have landed (they then
//     do not queue behind the attention's), for B10b at its entry (the
//     attention's 49 MB stream is the longer path).
// `pos` (B10a's cache row) is an int or read from device memory; outside
// [0, S) no cache row is written.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {  // one copy per source file that includes this header

constexpr int BLK_RT = 16;      // rows per tile (the batch, padded)
constexpr int BLK_RANKS = 8;    // blocks of an ln_gemm cluster (depth split)
constexpr int BLK_GW = 4;       // warps of an ln_gemm block
constexpr int BLK_GT = BLK_GW * 32;
constexpr int OUT_NC = 16;      // output columns of an out_proj cluster
constexpr int OUT_WLD = OUT_NC + 8;   // a W slice's row in shared memory: 48 B
constexpr int OUT_TILE = BLK_RT * OUT_NC;

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bf16x8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(p[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ double bf2d(bf16 v) {
  return (double)__bfloat162float(v);
}

// grid (N / NC * 8, row tiles), clusters of 8 blocks along x that share a
// tile of NC output columns (NC = 64, 32, 16 or 8), block `rank` taking
// depths [rank KR, (rank + 1) KR), KR = D / 8.  Column c < D is a q column:
// qbuf[row, c] = (acc + bias) * qscale in fp32.  Columns [D, 2D) and [2D,
// 3D) (N = 3D only) are k and v: rounded to bf16 into row `pos` of the [S,
// B, D] caches k_cache, v_cache.
//
//   1. copies: its [KR x NC] slice of W and the LN parameters at its
//      depths, then (once the kernel before, which writes x, has ended)
//      rows 2 rank and 2 rank + 1 of x whole (this block's share of the
//      statistics) and the tile's 16 rows of x at its depths;
//   2. the LN statistics of the block's two rows in fp64 (64 threads a
//      row), mean32 and rstd32 written into every block of the cluster;
//   3. after a cluster barrier, r = bf16(LN(x)) at the block's depths;
//   4. the product on DMMA: warp w takes n-tiles of 8 columns over the
//      block's depths (or, with fewer than 4 n-tiles, a part of them);
//   5. the block's partial [16 x NC] tile, its warps' parts added in order,
//      sent column by column to the block that owns the column (block r:
//      columns [r NC / 8, (r + 1) NC / 8)); after a cluster barrier each
//      adds the 8 partials of its columns in rank order, rounds once to
//      fp32 and writes them.
// Dynamic shared memory (ln_gemm_smem): [2][D] stats rows; [16][KR + 8] x;
// [2][KR] LN parameters; [KR][NC + 8] W; fp64 [16][KR + 4] r; fp64
// [wsplit][16][NC] warp partials; fp64 [8][16][NC / 8] the cluster's
// partials of this block's columns.
__global__ void __launch_bounds__(BLK_GT)
ln_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
               const bf16* __restrict__ w, const bf16* __restrict__ bias,
               float* __restrict__ qbuf, bf16* __restrict__ k_cache,
               bf16* __restrict__ v_cache, const int* __restrict__ pos_ptr,
               int pos_arg, int S, int B, int D, int N, int NC,
               float qscale, int dependents_at_entry) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 stats[BLK_RT];            // (mean32, rstd32) of a row
  __shared__ double ssum[BLK_GW];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int KR = D / BLK_RANKS, XLD = KR + 8, WLD = NC + 8, ALD = KR + 4;
  const int CR = NC / BLK_RANKS;               // columns this block owns
  const int nt = NC / 8;                       // n-tiles of the tile
  const int wsplit = nt >= BLK_GW ? 1 : BLK_GW / nt;
  bf16* sS = reinterpret_cast<bf16*>(smem);    // [2][D]
  bf16* sX = sS + 2 * D;                       // [16][XLD]
  bf16* sLN = sX + BLK_RT * XLD;               // [2][KR]
  bf16* sW = sLN + 2 * KR;                     // [KR][WLD]
  double* sA = reinterpret_cast<double*>(sW + KR * WLD);   // [16][ALD] r
  double* part = sA + BLK_RT * ALD;
  double* red = part + wsplit * BLK_RT * NC;   // [8][16][CR]
  const int row0 = blockIdx.y * BLK_RT, c0 = (blockIdx.x / BLK_RANKS) * NC;
  const int k0 = rank * KR;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (dependents_at_entry) grid_launch_dependents();
  cluster_arrive_relaxed();  // waited for before writes into other blocks
  // The weights first: they do not depend on the kernel before this one,
  // which may still run (this is its programmatic dependent).
  for (int i = tid; i < KR * NC / 8; i += BLK_GT) {
    const int r = i / (NC / 8), k = 8 * (i % (NC / 8));
    cp_async16(smem_u32(sW + r * WLD + k), w + (size_t)(k0 + r) * N + c0 + k);
  }
  for (int i = tid; i < KR / 4; i += BLK_GT) {  // scale, then bias
    const int r = i / (KR / 8), k = 8 * (i % (KR / 8));
    cp_async16(smem_u32(sLN + r * KR + k), ln + (size_t)r * D + k0 + k);
  }
  cp_async_commit();
  // this block's outputs: element e = tid of [16][CR] (rows e / CR)
  const int ocol = c0 + rank * CR + tid % CR;
  const float bv = tid < BLK_RT * CR ? __bfloat162float(bias[ocol]) : 0.0f;
  grid_dependency_wait();  // the kernel before has written x
  for (int i = tid; i < D / 4; i += BLK_GT) {  // 2 rows of D / 8 words
    const int r = i / (D / 8), k = 8 * (i % (D / 8));
    const int g = row0 + 2 * rank + r;
    if (g < B) cp_async16(smem_u32(sS + r * D + k), x + (size_t)g * D + k);
  }
  for (int i = tid; i < BLK_RT * KR / 8; i += BLK_GT) {
    const int r = i / (KR / 8), k = 8 * (i % (KR / 8));
    if (row0 + r < B)
      cp_async16(smem_u32(sX + r * XLD + k),
                 x + (size_t)(row0 + r) * D + k0 + k);
  }
  cp_async_commit();
  const int pos = pos_ptr ? *pos_ptr : pos_arg;
  cp_async_wait<0>();
  __syncthreads();  // x's rows, the LN parameters and W have landed
  // else the attention kernel may start its copies now: they no longer
  // queue in front of this kernel's
  if (!dependents_at_entry) grid_launch_dependents();

  // 2. statistics of rows 2 rank + r: warps 2 r and 2 r + 1, 16-byte words
  {
    const int r = warp / 2, half = warp % 2;
    const int g = row0 + 2 * rank + r;
    const uint4* xr = reinterpret_cast<const uint4*>(sS + r * D);
    const int nw = D / 8;
    double s = 0.0;
    for (int wd = half * 32 + lane; wd < nw; wd += 64) {
      float f[8];
      bf16x8(xr[wd], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += (double)f[k];
    }
    s = warp_sum_f64(s);
    if (lane == 0) ssum[warp] = s;
    __syncthreads();
    const double mean = (ssum[2 * r] + ssum[2 * r + 1]) / (double)D;
    double s2 = 0.0;
    for (int wd = half * 32 + lane; wd < nw; wd += 64) {
      float f[8];
      bf16x8(xr[wd], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const double dv = (double)f[k] - mean;
        s2 += dv * dv;
      }
    }
    s2 = warp_sum_f64(s2);
    __syncthreads();  // every warp has read ssum's sums
    if (lane == 0) ssum[warp] = s2;
    __syncthreads();
    cluster_wait();   // every block of the cluster runs
    if (half == 0 && lane < BLK_RANKS) {
      const double var = (ssum[2 * r] + ssum[2 * r + 1]) / (double)D;
      const float2 st = g < B ? make_float2((float)mean,
                                            (float)(1.0 / sqrt(var + 1e-5)))
                              : make_float2(0.0f, 0.0f);
      *cluster.map_shared_rank(&stats[2 * rank + r], lane) = st;
    }
    cluster_arrive();
    cluster_wait();   // every row's statistics are here
  }

  // 3. r at this block's depths, in place
  for (int i = tid; i < BLK_RT * KR / 8; i += BLK_GT) {
    const int r = i / (KR / 8), wd = i % (KR / 8);
    const uint4* xr = reinterpret_cast<const uint4*>(sX + r * XLD) + wd;
    const float2 st = stats[r];
    float f[8], sc[8], bi[8];
    bf16x8(*xr, f);
    bf16x8(reinterpret_cast<const uint4*>(sLN)[wd], sc);
    bf16x8(reinterpret_cast<const uint4*>(sLN + KR)[wd], bi);
    const bool live = row0 + r < B;
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float n = __fmul_rn(__fsub_rn(f[2 * k + e], st.x), st.y);
        y[e] = live ? __fadd_rn(__fmul_rn(n, sc[2 * k + e]), bi[2 * k + e])
                    : 0.0f;
      }
      o[k] = pack_bf16(y[0], y[1]);
    }
    // r as fp64 once, for every warp's mma
    const uint4 rv = make_uint4(o[0], o[1], o[2], o[3]);
    float rf[8];
    bf16x8(rv, rf);
    double* ar = sA + r * ALD + 8 * wd;
#pragma unroll
    for (int k = 0; k < 8; ++k) ar[k] = (double)rf[k];
  }
  __syncthreads();  // r is visible

  // 4. fp64 mma: lane 4 g + t holds r's rows g and g + 8 at depth t and W's
  // column g at depth t; warp w: n-tiles [ng tpw, (ng + 1) tpw), depths of
  // part dp of wsplit
  {
    const int tpw = nt >= BLK_GW ? nt / BLK_GW : 1;  // 1 or 2
    const int ng = warp / wsplit, dp = warp % wsplit;
    const int kw = KR / wsplit, g = lane / 4, t = lane % 4;
    // two accumulators a tile, for alternate steps of 4 depths: two chains
    // of mma in flight, added at the end
    double d[2][2][2][2] = {};   // [step parity][m-tile][n-tile][2]
    const double* ra = sA + g * ALD + dp * kw + t;
    const bf16* wb = sW + (dp * kw + t) * WLD + ng * tpw * 8 + g;
#pragma unroll 2
    for (int k = 0; k < kw; k += 8) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int kk = k + 4 * p;
        if (kk < kw) {
          const double a0 = ra[kk], a1 = ra[8 * ALD + kk];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (j < tpw) {
              const double b = bf2d(wb[kk * WLD + 8 * j]);
              mma_m8n8k4_f64(d[p][0][j], a0, b);
              mma_m8n8k4_f64(d[p][1][j], a1, b);
            }
          }
        }
      }
    }
    // [dp][row][column] of the tile
    double* mine = part + dp * BLK_RT * NC + g * NC + ng * tpw * 8 + 2 * t;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < tpw) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mine[m * 8 * NC + 8 * j] = d[0][m][j][0] + d[1][m][j][0];
          mine[m * 8 * NC + 8 * j + 1] = d[0][m][j][1] + d[1][m][j][1];
        }
      }
    }
  }
  __syncthreads();

  // 5. the tile's columns to their owners, the depth parts added in order
  for (int e = tid; e < BLK_RT * NC; e += BLK_GT) {
    double z = part[e];
    for (int i = 1; i < wsplit; ++i) z += part[i * BLK_RT * NC + e];
    const int r = e / NC, c = e % NC;
    *cluster.map_shared_rank(red + (rank * BLK_RT + r) * CR + c % CR,
                             c / CR) = z;
  }
  cluster_arrive();
  cluster_wait();   // every partial of this block's columns is here
  if (tid >= BLK_RT * CR) return;
  double z = red[tid];
#pragma unroll
  for (int i = 1; i < BLK_RANKS; ++i) z += red[i * BLK_RT * CR + tid];
  const int row = row0 + tid / CR;
  if (row >= B) return;
  const float v = __fadd_rn((float)z, bv);
  if (ocol < D) {
    qbuf[(size_t)row * D + ocol] = __fmul_rn(v, qscale);
  } else if (pos >= 0 && pos < S) {
    bf16* dst = ocol < 2 * D ? k_cache + (ocol - D) : v_cache + (ocol - 2 * D);
    dst[((size_t)pos * B + row) * D] = __float2bfloat16_rn(v);
  }
}

// out[:, c0:c0+16] = bf16((ctx . W[:, c0:c0+16] + b) + x), as B10c's FC2
// (decoder_mlp.cu): a cluster of `split` blocks per 16 output columns (4,
// or 2 where D is no multiple of 256), block `rank` taking depths [rank KQ,
// (rank + 1) KQ), KQ = D / split, its 4 warps a quarter of them each (bf16
// mma.sync, fp32 accumulation).  Launched as the attention kernel's
// programmatic dependent: its W slice and rank 0's bias and x are fetched
// before it waits for ctx.  The warps' partial tiles are added in warp
// order, the blocks' in rank order in rank 0.  ctx has ceil(B / 16) * 16
// rows (those past B are never stored).  Dynamic shared memory
// (out_proj_smem): [KQ][24] W slice, [16][KQ + 8] ctx rows, fp32 [4][256]
// warp tiles, fp32 [split][256] the cluster's tiles (in rank 0).
__global__ void __launch_bounds__(BLK_GT)
out_proj_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ w,
                const bf16* __restrict__ bias, const bf16* __restrict__ x,
                bf16* __restrict__ out, int B, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int KQ = D / split, HLD = KQ + 8;
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sH = sW + KQ * OUT_WLD;
  float* part = reinterpret_cast<float*>(sH + BLK_RT * HLD);
  float* tiles = part + BLK_GW * OUT_TILE;
  const int row0 = blockIdx.y * BLK_RT, c0 = (blockIdx.x / split) * OUT_NC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cluster_arrive_relaxed();  // waited for before writes into rank 0
  for (int i = tid; i < 2 * KQ; i += BLK_GT) {
    const int r = i / 2, half = i % 2;
    cp_async16(smem_u32(sW + r * OUT_WLD + 8 * half),
               w + (size_t)(rank * KQ + r) * D + c0 + 8 * half);
  }
  cp_async_commit();
  // rank 0's epilogue operands, elements e = tid + 128 j, before the wait
  float bv = 0.0f, xv[OUT_TILE / BLK_GT] = {};
  if (rank == 0) {
    bv = __bfloat162float(bias[c0 + tid % OUT_NC]);
#pragma unroll
    for (int j = 0; j < OUT_TILE / BLK_GT; ++j) {
      const int e = tid + BLK_GT * j, g = row0 + e / OUT_NC;
      xv[j] = g < B ? __bfloat162float(x[(size_t)g * D + c0 + e % OUT_NC])
                    : 0.0f;
    }
  }
  grid_dependency_wait();  // the attention kernel has written ctx
  for (int i = tid; i < BLK_RT * KQ / 8; i += BLK_GT) {
    const int r = i / (KQ / 8), k = 8 * (i % (KQ / 8));
    cp_async16(smem_u32(sH + r * HLD + k),
               ctx + (size_t)(row0 + r) * D + rank * KQ + k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int kn = KQ / BLK_GW;
  float d[2][4];
  mma_tile_16x16(sH, HLD, sW, OUT_WLD, warp * kn, kn, d);
  {
    const int g = lane / 4, c = lane % 4;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[warp * OUT_TILE + (g + 8 * (e / 2)) * OUT_NC + 8 * nt + 2 * c +
             e % 2] = d[nt][e];
  }
  __syncthreads();
  cluster_wait();
  for (int e = tid; e < OUT_TILE; e += BLK_GT) {
    float z = part[e];
#pragma unroll
    for (int i = 1; i < BLK_GW; ++i) z = __fadd_rn(z, part[i * OUT_TILE + e]);
    cluster.map_shared_rank(tiles, 0)[rank * OUT_TILE + e] = z;
  }
  cluster_arrive();
  if (rank != 0) return;  // rank 0 reads only its own shared memory
  cluster_wait();
#pragma unroll
  for (int j = 0; j < OUT_TILE / BLK_GT; ++j) {
    const int e = tid + BLK_GT * j, g = row0 + e / OUT_NC;
    if (g >= B) continue;
    float z = tiles[e];
    for (int r = 1; r < split; ++r) z = __fadd_rn(z, tiles[r * OUT_TILE + e]);
    z = __fadd_rn(z, bv);
    out[(size_t)g * D + c0 + e % OUT_NC] =
        __float2bfloat16_rn(__fadd_rn(z, xv[j]));
  }
}

size_t ln_gemm_smem(int D, int NC) {
  const int KR = D / BLK_RANKS, nt = NC / 8;
  const int wsplit = nt >= BLK_GW ? 1 : BLK_GW / nt;
  return (size_t)2 * D * 2 + (size_t)BLK_RT * (KR + 8) * 2 +
         (size_t)2 * KR * 2 + (size_t)KR * (NC + 8) * 2 +
         (size_t)BLK_RT * (KR + 4) * 8 + (size_t)(wsplit + 1) * BLK_RT * NC * 8;
}

size_t ln_gemm_allowed = 0;   // set at the first call: past static memory
size_t out_proj_allowed = 0;

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// A launch of `kernel` in clusters of `cluster` blocks along x; with
// `dependent`, as a programmatic dependent of the kernel before it on the
// stream (it starts once that one's blocks have all called
// grid_launch_dependents, and must grid_dependency_wait before it reads
// what that one writes).
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
              cudaStream_t s, unsigned cluster, bool dependent,
              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (cluster > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (dependent) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// Launch ln_gemm_kernel; N is D (q only) or 3D (q | k | v, and then k_cache,
// v_cache and `pos` or `pos_ptr`).  The column tile is the widest of 64,
// 32, 16 and 8 columns that still gives a block to every SM.  Its dependent
// may start at its entry or once its copies have landed
// (`dependents_at_entry`).
inline int launch_ln_gemm(const void* x, const void* ln, const void* w,
                          const void* bias, void* qbuf, void* k_cache,
                          void* v_cache, const void* pos_ptr, int pos, int S,
                          int B, int D, int N, float qscale,
                          bool dependents_at_entry, cudaStream_t s) {
  const int row_tiles = (B + BLK_RT - 1) / BLK_RT;
  int nc = 64;
  while (nc > 8 && N / nc * BLK_RANKS * row_tiles < sm_count()) nc /= 2;
  const size_t smem = ln_gemm_smem(D, nc);
  const cudaError_t rc =
      allow_smem((const void*)ln_gemm_kernel, smem, ln_gemm_allowed);
  if (rc != cudaSuccess) return (int)rc;
  return launch_ex(ln_gemm_kernel, dim3(N / nc * BLK_RANKS, row_tiles),
                   BLK_GT, smem, s, (unsigned)BLK_RANKS, true,
                   (const bf16*)x, (const bf16*)ln, (const bf16*)w,
                   (const bf16*)bias, (float*)qbuf, (bf16*)k_cache,
                   (bf16*)v_cache, (const int*)pos_ptr, pos, S, B, D, N, nc,
                   qscale, (int)dependents_at_entry);
}

// Launch out_proj_kernel as the programmatic dependent of the attention
// kernel before it on the stream.
inline int launch_out_proj(const void* ctx, const void* w, const void* bias,
                           const void* x, void* out, int B, int D,
                           cudaStream_t s) {
  const int row_tiles = (B + BLK_RT - 1) / BLK_RT;
  const int split = D % 256 == 0 ? 4 : 2;
  const int KQ = D / split;
  const size_t smem = (size_t)KQ * OUT_WLD * 2 +
                      (size_t)BLK_RT * (KQ + 8) * 2 +
                      (size_t)(BLK_GW + split) * OUT_TILE * 4;
  const cudaError_t rc =
      allow_smem((const void*)out_proj_kernel, smem, out_proj_allowed);
  if (rc != cudaSuccess) return (int)rc;
  return launch_ex(out_proj_kernel, dim3(D / OUT_NC * split, row_tiles),
                   BLK_GT, smem, s, (unsigned)split, true, (const bf16*)ctx,
                   (const bf16*)w, (const bf16*)bias, (const bf16*)x,
                   (bf16*)out, B, D);
}

}  // namespace
