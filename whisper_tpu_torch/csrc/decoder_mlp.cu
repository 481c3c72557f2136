// B10c: the decoder's MLP block for one decode step,
// x [B, d] bf16 -> x + FC2(GELU_tanh(FC1(LN(x)))).
//
// Replaces whisper_tpu/ops/decoder_kernels.py:mlp_block (_mlp_kernel).
// Contract: LayerNorm with fp32 statistics (eps 1e-5) cast to bf16; FC1
// accumulated in fp32, + b1; tanh GELU as jax.nn.gelu(approximate=True)
// writes it, x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))),
// cast to bf16; FC2 accumulated in fp32; (z + b2) + x in fp32, one rounding
// to bf16 at the end.
//
// What bounds it on the H100: B <= 16 rows against two [512, 2048] bf16
// matrices: 4.2 MB of weights for 67 MFLOP, so it streams weights: 1.3 us
// from device memory, less from L2, where the six layers' 25 MB stay
// between steps.  At that size the launch is the cost, and the design is
// the plain one.  Two phases on one stream inside one call: phase 1, a
// block per 64 FFN columns (32 blocks at f = 2048), recomputes the
// LayerNorm of the <= 16 rows (8 K elements) and writes its slice of h as
// bf16 into a scratch buffer the wrapper provides (64 KB: it stays in L2);
// phase 2, a block per 16 output columns (32 blocks at d = 512), splits
// the f-long sum over its 8 warps, adds the 8 partial tiles in a fixed
// order, then b2 and x.  Both use the bf16 tensor cores (wmma, the batch
// padded to a 16-row tile); no atomics, so a call's sums have one order.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int RT = 16;         // rows per tile (the batch, padded)
constexpr int P1_COLS = 64;    // FFN columns per phase-1 block (4 warps)
constexpr int P2_WARPS = 8;    // K splits of a phase-2 block

__device__ __forceinline__ float gelu_tanh_jax(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float u = __fmul_rn(0.7978845608028654f,
                            __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
}

// Phase 1: h[:, c0:c0+64] = bf16(GELU(bf16(LN(x)) . W1[:, c0:c0+64] + b1)).
__global__ void __launch_bounds__(128)
fc1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln,
           const bf16* __restrict__ w1, const bf16* __restrict__ b1,
           bf16* __restrict__ h, int B, int D, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RLD = D + 8;
  bf16* sR = reinterpret_cast<bf16*>(smem);                       // [RT][RLD]
  float* sStage = reinterpret_cast<float*>(smem + RT * RLD * 2);  // 4 x 256
  const int row0 = blockIdx.y * RT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* lns = ln;
  const bf16* lnb = ln + D;

  // LayerNorm: warp w takes rows w, w+4, w+8, w+12 of the tile.
  for (int r = warp; r < RT; r += 4) {
    const int g = row0 + r;
    bf16* dst = sR + r * RLD;
    if (g < B) {
      const bf16* xr = x + (size_t)g * D;
      float s = 0.0f;
      for (int c = lane; c < D; c += 32) s += __bfloat162float(xr[c]);
      const float mean = warp_sum(s) / (float)D;
      float s2 = 0.0f;
      for (int c = lane; c < D; c += 32) {
        const float dv = __bfloat162float(xr[c]) - mean;
        s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
      }
      const float var = warp_sum(s2) / (float)D;
      const float rstd = 1.0f / sqrtf(var + 1e-5f);
      for (int c = lane; c < D; c += 32) {
        const float y = __fmul_rn(__bfloat162float(xr[c]) - mean, rstd);
        dst[c] = __float2bfloat16_rn(__fadd_rn(
            __fmul_rn(y, __bfloat162float(lns[c])), __bfloat162float(lnb[c])));
      }
    } else {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  const int col0 = blockIdx.x * P1_COLS + warp * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, sR + kk * 16, RLD);
    wmma::load_matrix_sync(b, w1 + (size_t)kk * 16 * F + col0, F);
    wmma::mma_sync(acc, a, b, acc);
  }
  float* stage = sStage + warp * 256;
  wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, col = col0 + e % 16;
    const float hv = __fadd_rn(stage[e], __bfloat162float(b1[col]));
    h[(size_t)(row0 + r) * F + col] = __float2bfloat16_rn(gelu_tanh_jax(hv));
  }
}

// Phase 2: out[:, c0:c0+16] = bf16((h . W2[:, c0:c0+16] + b2) + x).
__global__ void __launch_bounds__(P2_WARPS * 32)
fc2_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
           const bf16* __restrict__ b2, const bf16* __restrict__ x,
           bf16* __restrict__ out, int B, int D, int F) {
  __shared__ __align__(128) float sPart[P2_WARPS][256];
  const int row0 = blockIdx.y * RT;
  const int col0 = blockIdx.x * 16;
  const int warp = threadIdx.x / 32;
  const int kper = F / P2_WARPS;           // a multiple of 16 (F % 128 == 0)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int k = warp * kper; k < (warp + 1) * kper; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::load_matrix_sync(a, h + (size_t)row0 * F + k, F);
    wmma::load_matrix_sync(b, w2 + (size_t)k * D + col0, D);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(sPart[warp], acc, 16, wmma::mem_row_major);
  __syncthreads();
  const int e = threadIdx.x;               // 256 threads, 256 elements
  const int g = row0 + e / 16, col = col0 + e % 16;
  if (g < B) {
    float z = sPart[0][e];
#pragma unroll
    for (int w = 1; w < P2_WARPS; ++w) z = __fadd_rn(z, sPart[w][e]);
    z = __fadd_rn(z, __bfloat162float(b2[col]));
    out[(size_t)g * D + col] = __float2bfloat16_rn(
        __fadd_rn(z, __bfloat162float(x[(size_t)g * D + col])));
  }
}

}  // namespace

// h: scratch of ceil(B / 16) * 16 rows of F bf16 values.
WT_EXPORT int wt_decoder_mlp(const void* x, const void* ln, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* h, void* out, int B, int D, int F,
                             void* stream) {
  if (B < 1 || D % 16 != 0 || F % 128 != 0 || (D + 8) * RT * 2 + 4096 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int row_tiles = (B + RT - 1) / RT;
  const size_t smem1 = (size_t)RT * (D + 8) * 2 + 4 * 256 * 4;
  fc1_kernel<<<dim3(F / P1_COLS, row_tiles), 128, smem1, s>>>(
      (const bf16*)x, (const bf16*)ln, (const bf16*)w1, (const bf16*)b1,
      (bf16*)h, B, D, F);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  fc2_kernel<<<dim3(D / 16, row_tiles), P2_WARPS * 32, 0, s>>>(
      (const bf16*)h, (const bf16*)w2, (const bf16*)b2, (const bf16*)x,
      (bf16*)out, B, D, F);
  return (int)cudaGetLastError();
}
