// B10c: the decoder's MLP block for one decode step,
// x [B, d] bf16 -> x + FC2(GELU_tanh(FC1(LN(x)))).
//
// Replaces whisper_tpu/ops/decoder_kernels.py:mlp_block (_mlp_kernel).
// Contract: LayerNorm with fp32 statistics (eps 1e-5) cast to bf16; FC1
// accumulated in fp32, + b1; tanh GELU as jax.nn.gelu(approximate=True)
// writes it, x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))),
// cast to bf16; FC2 accumulated in fp32; (z + b2) + x in fp32, one rounding
// to bf16 at the end.  No atomics: every sum of a call has one order, so two
// calls are bitwise equal.
//
// What bounds it on the H100: B <= 16 rows against two [d, 4d] bf16
// matrices (4.2 MB at whisper-base, 26 MB at whisper-large) for 67 MFLOP,
// so it streams weights: 1.26 us at 3.35 TB/s at whisper-base.  Those bytes
// come in only as fast as there are loads in flight, so the design spreads
// them over every SM and puts all of them in flight at once:
//   * FC1: a block per 16 FFN columns (128 blocks at f = 2,048, 320 at
//     5,120).  Its <= 16 rows of x and its [d x 16] slice of W1 are issued
//     at entry as 16-byte cp.async copies into shared memory; the block
//     computes the LayerNorm of the rows in place (from shared memory: read
//     from device memory, its three passes were each a round trip) while
//     the weights land, then bf16 mma.sync m16n8k16 from
//     shared memory (ldmatrix), the depth split over 4 warps and their
//     partial tiles added in warp order; bias and GELU, and h written as
//     bf16 into a scratch buffer the wrapper provides (it stays in L2).
//   * FC2: a cluster of 4 blocks per 16 output columns (128 blocks at d =
//     512), each block a quarter of f: its [f/4 x 16] slice of W2 issued at
//     entry, then its partial tile as in FC1; ranks 1..3 write theirs into
//     rank 0's shared memory, which adds the four in rank order, then b2 and
//     x.
//   * FC2 is launched as a programmatic dependent of FC1 (cudaLaunchKernelEx
//     with programmatic stream serialization): FC1's blocks let it start at
//     once (griddepcontrol.launch_dependents), and FC2's blocks issue their
//     W2 copies before they wait for FC1's h (griddepcontrol.wait), so both
//     matrices are in flight together.  A launch that fails returns its
//     error; there is no other path.
// A batch of more than 16 rows takes further row tiles (gridDim.y).
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int RT = 16;        // rows a tile (the batch, padded)
constexpr int NC = 16;        // output columns a block: two mma n-tiles
constexpr int NW = 4;         // warps a block, each a quarter of the depth
constexpr int NT = NW * 32;
constexpr int WLD = NC + 8;   // a weight slice's row in shared memory: 48 B
constexpr int SPLIT = 4;      // FC2's cluster: blocks splitting f

__device__ __forceinline__ float gelu_tanh_jax(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(0.7978845608028654f,
                            __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
}

// Rows [k0, k0 + n) of a row-major [*, ld] bf16 matrix, columns [c0, c0 +
// 16), into sW [n][WLD] by 16-byte cp.async copies of the whole block.
__device__ __forceinline__ void issue_slice(bf16* sW, const bf16* w, int k0,
                                            int n, int ld, int c0) {
  for (int i = threadIdx.x; i < 2 * n; i += NT) {
    const int r = i / 2, half = i % 2;
    cp_async16(smem_u32(sW + r * WLD + 8 * half),
               w + (size_t)(k0 + r) * ld + c0 + 8 * half);
  }
}

// The warps' partial tiles into part [NW][RT * NC], then element e of the
// block's tile (row e / 16, column e % 16): their sum in warp order.
__device__ __forceinline__ void store_partial(float* part,
                                              const float (&d)[2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[warp * RT * NC + (g + 8 * (e / 2)) * NC + 8 * nt + 2 * c + e % 2] =
          d[nt][e];
}

__device__ __forceinline__ float warps_sum(const float* part, int e) {
  float z = part[e];
#pragma unroll
  for (int w = 1; w < NW; ++w) z = __fadd_rn(z, part[w * RT * NC + e]);
  return z;
}

// FC1: h[:, c0:c0+16] = bf16(GELU(bf16(LN(x)) . W1[:, c0:c0+16] + b1)).
// Shared memory: [RT][D + 8] LN rows, [D][WLD] W1 slice, [NW][256] fp32,
// [2][D] the LayerNorm's scale and bias.
__global__ void __launch_bounds__(NT)
fc1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
           const bf16* __restrict__ w1, const bf16* __restrict__ b1,
           bf16* __restrict__ h, int B, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RLD = D + 8;
  bf16* sR = reinterpret_cast<bf16*>(smem);
  bf16* sW = sR + RT * RLD;
  float* part = reinterpret_cast<float*>(sW + D * WLD);
  bf16* sLN = reinterpret_cast<bf16*>(part + NW * RT * NC);
  const int row0 = blockIdx.y * RT, c0 = blockIdx.x * NC;
  const int warp = threadIdx.x / 32;
  grid_launch_dependents();  // FC2 may start and fetch W2 now
  // The tile's rows of x and the LayerNorm's parameters, then the W1 slice:
  // two groups of copies; every other read of device memory issued before
  // any wait (a load in a loop that waits for it is a round trip each time)
  for (int i = threadIdx.x; i < RT * D / 8; i += NT) {
    const int r = i / (D / 8), k = 8 * (i % (D / 8));
    if (row0 + r < B)
      cp_async16(smem_u32(sR + r * RLD + k), x + (size_t)(row0 + r) * D + k);
  }
  for (int i = threadIdx.x; i < D / 4; i += NT)
    cp_async16(smem_u32(sLN + 8 * i), ln + 8 * i);
  cp_async_commit();
  const float bias1 = __bfloat162float(b1[c0 + threadIdx.x % NC]);
  issue_slice(sW, w1, 0, D, F, c0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // x's rows have landed

  // LayerNorm in place while W1 lands: eight threads a row, each taking
  // 16-byte words j, j + 8, ... of it, their sums met by three shuffles.
  {
    const int r = threadIdx.x / 8, j = threadIdx.x % 8, nw = D / 8;
    uint4* xr = reinterpret_cast<uint4*>(sR + r * RLD);
    auto sum8 = [](float v) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      return v;
    };
    auto vals = [](const uint4& u, float (&f)[8]) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 t = __bfloat1622float2(p[k]);
        f[2 * k] = t.x;
        f[2 * k + 1] = t.y;
      }
    };
    float s = 0.0f;
    for (int w = j; w < nw; w += 8) {
      float f[8];
      vals(xr[w], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += f[k];
    }
    const float mean = sum8(s) / (float)D;
    float s2 = 0.0f;
    for (int w = j; w < nw; w += 8) {
      float f[8];
      vals(xr[w], f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float dv = f[k] - mean;
        s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
      }
    }
    const float rstd = 1.0f / sqrtf(sum8(s2) / (float)D + 1e-5f);
    const bool live = row0 + r < B;
    for (int w = j; w < nw; w += 8) {
      float f[8];
      vals(xr[w], f);
      const uint4 sv = reinterpret_cast<const uint4*>(sLN)[w];
      const uint4 bv = reinterpret_cast<const uint4*>(sLN + D)[w];
      float sc[8], bi[8];
      vals(sv, sc);
      vals(bv, bi);
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float n = __fmul_rn(f[2 * k + e] - mean, rstd);
          y[e] = live ? __fadd_rn(__fmul_rn(n, sc[2 * k + e]), bi[2 * k + e])
                      : 0.0f;
        }
        o[k] = pack_bf16(y[0], y[1]);
      }
      xr[w] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the LN rows and every thread's W1 copies are visible

  const int kn = D / NW;
  float d[2][4];
  mma_tile_16x16(sR, RLD, sW, WLD, warp * kn, kn, d);
  store_partial(part, d);
  __syncthreads();
  for (int e = threadIdx.x; e < RT * NC; e += NT) {  // column e % NC
    const float hv = __fadd_rn(warps_sum(part, e), bias1);
    h[(size_t)(row0 + e / NC) * F + c0 + e % NC] =
        __float2bfloat16_rn(gelu_tanh_jax(hv));
  }
}

// FC2: out[:, c0:c0+16] = bf16((h . W2[:, c0:c0+16] + b2) + x), a cluster of
// SPLIT blocks, block `rank` taking depths [rank F / 4, (rank + 1) F / 4).
// Shared memory: [F / 4][WLD] W2 slice, [RT][F / 4 + 8] h rows, [NW][256]
// fp32, [SPLIT][256] fp32 (the cluster's partial tiles, in rank 0).
__global__ void __launch_bounds__(NT)
fc2_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ x,
           bf16* __restrict__ out, int B, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int FQ = F / SPLIT, HLD = FQ + 8;
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* sH = sW + FQ * WLD;
  float* part = reinterpret_cast<float*>(sH + RT * HLD);
  float* tiles = part + NW * RT * NC;
  const int row0 = blockIdx.y * RT, c0 = (blockIdx.x / SPLIT) * NC;
  const int warp = threadIdx.x / 32;
  cluster_arrive_relaxed();  // this block runs: waited for before writes
  issue_slice(sW, w2, rank * FQ, FQ, D, c0);
  cp_async_commit();
  // rank 0's epilogue operands, elements e = tid + NT j, before the wait
  float bias2 = 0.0f, xv[RT * NC / NT] = {};
  if (rank == 0) {
    bias2 = __bfloat162float(b2[c0 + threadIdx.x % NC]);
#pragma unroll
    for (int j = 0; j < RT * NC / NT; ++j) {
      const int e = threadIdx.x + NT * j, g = row0 + e / NC;
      xv[j] = g < B ? __bfloat162float(x[(size_t)g * D + c0 + e % NC]) : 0.0f;
    }
  }
  grid_dependency_wait();    // FC1 has finished: h is written
  for (int i = threadIdx.x; i < RT * FQ / 8; i += NT) {
    const int r = i / (FQ / 8), k = 8 * (i % (FQ / 8));
    cp_async16(smem_u32(sH + r * HLD + k),
               h + (size_t)(row0 + r) * F + rank * FQ + k);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int kn = FQ / NW;
  float d[2][4];
  mma_tile_16x16(sH, HLD, sW, WLD, warp * kn, kn, d);
  store_partial(part, d);
  __syncthreads();
  cluster_wait();
  for (int e = threadIdx.x; e < RT * NC; e += NT)
    cluster.map_shared_rank(tiles, 0)[rank * RT * NC + e] = warps_sum(part, e);
  cluster_arrive();
  if (rank != 0) return;  // rank 0 reads only its own shared memory
  cluster_wait();
#pragma unroll
  for (int j = 0; j < RT * NC / NT; ++j) {
    const int e = threadIdx.x + NT * j, g = row0 + e / NC;
    if (g >= B) continue;
    float z = tiles[e];
#pragma unroll
    for (int r = 1; r < SPLIT; ++r) z = __fadd_rn(z, tiles[r * RT * NC + e]);
    z = __fadd_rn(z, bias2);
    out[(size_t)g * D + c0 + e % NC] =
        __float2bfloat16_rn(__fadd_rn(z, xv[j]));
  }
}

size_t fc1_smem(int D) {
  return (size_t)RT * (D + 8) * 2 + (size_t)D * WLD * 2 + NW * RT * NC * 4 +
         (size_t)2 * D * 2;
}

size_t fc2_smem(int F) {
  const int FQ = F / SPLIT;
  return (size_t)FQ * WLD * 2 + (size_t)RT * (FQ + 8) * 2 +
         (NW + SPLIT) * RT * NC * 4;
}

size_t fc1_allowed = 48 * 1024, fc2_allowed = 48 * 1024;

}  // namespace

// h: scratch of ceil(B / 16) * 16 rows of F bf16 values.  D a multiple of
// 64 up to 1,280 and F a multiple of 256 up to 5,120.
WT_EXPORT int wt_decoder_mlp(const void* x, const void* ln, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* h, void* out, int B, int D, int F,
                             void* stream) {
  if (B < 1 || D % 64 || D > 1280 || F % 256 || F > 5120)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_tiles = (B + RT - 1) / RT;
  const size_t smem1 = fc1_smem(D), smem2 = fc2_smem(F);
  cudaError_t rc = allow_smem((const void*)fc1_kernel, smem1, fc1_allowed);
  if (rc != cudaSuccess) return (int)rc;
  rc = allow_smem((const void*)fc2_kernel, smem2, fc2_allowed);
  if (rc != cudaSuccess) return (int)rc;
  fc1_kernel<<<dim3(F / NC, row_tiles), NT, smem1, s>>>(
      (const bf16*)x, (const bf16*)ln, (const bf16*)w1, (const bf16*)b1,
      (bf16*)h, B, D, F);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(D / NC * SPLIT), (unsigned)row_tiles);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem2;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = SPLIT;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  rc = cudaLaunchKernelEx(&cfg, fc2_kernel, (const bf16*)h, (const bf16*)w2,
                          (const bf16*)b2, (const bf16*)x, (bf16*)out, B, D,
                          F);
  return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}
