// The LayerNorm of a row and the tanh GELU shared by the encoder MLP (B2,
// encoder_mlp.cu) and the O-projection + MLP kernel (B9b, encoder_block.cu),
// and the 64-column FFN walk of the latter.
//
// A block of NT = 256 threads (8 warps) owns R = 32 rows.  `ln_row` turns
// one row, held as D/32 fp32 values per lane, into bf16 LayerNorm output
// (fp32 statistics, eps 1e-5).  `ffn_walk` walks the FFN in chunks of 64
// columns: h = r.W1[:, c] on the bf16 tensor cores (wmma, fp32
// accumulate), bias + tanh GELU in fp32 into a bf16 tile, then
// y += h.W2[c, :] into fp32 accumulators that stay in registers for the
// whole walk, so the [N, f] intermediate never touches device memory.
// Weight fragments are read straight from global memory (they stay in the
// 50 MB L2).  The fp32 adds and multiplies outside the matmuls use
// __fadd_rn/__fmul_rn so that the compiler does not contract them into
// FMAs the JAX kernels do not use.
#pragma once

#include "common.cuh"

namespace ffn {

using namespace nvcuda;

constexpr int R = 32;          // rows per block
constexpr int FC = 64;         // FFN columns per chunk
constexpr int NT = 256;        // 8 warps: 2 row tiles x 4 column quarters
constexpr int HLD = FC + 4;    // fp32 h tile row stride
constexpr int HBLD = FC + 8;   // bf16 h tile row stride

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_frag;

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x * x * x))), in the
  // JAX expression's evaluation order.
  float u = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  u = __fmul_rn(0.7978845608028654f, __fadd_rn(x, u));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(u)));
}

// LayerNorm of one row of D values, lane `lane` holding columns lane + 32*i
// in xv[i]; the whole warp calls it.  dst: the row's bf16 output.
template <int D>
__device__ __forceinline__ void ln_row(const float (&xv)[D / 32],
                                       const bf16* __restrict__ lns,
                                       const bf16* __restrict__ lnb, bf16* dst,
                                       int lane) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) s += xv[i];
  const float mean = warp_sum(s) / (float)D;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const float dv = xv[i] - mean;
    s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
  }
  const float var = warp_sum(s2) / (float)D;
  const float rstd = 1.0f / sqrtf(var + 1e-5f);
#pragma unroll
  for (int i = 0; i < D / 32; ++i) {
    const int c = lane + 32 * i;
    const float y = __fmul_rn(xv[i] - mean, rstd);
    dst[c] = __float2bfloat16_rn(__fadd_rn(
        __fmul_rn(y, __bfloat162float(lns[c])), __bfloat162float(lnb[c])));
  }
}

// y[16 x D/4] (this warp's row tile and column quarter) =
// GELU_tanh(sR . W1 + b1) . W2, walked over the F FFN columns.  sR: the
// block's [R][D + 8] bf16 LN tile; sH [R][HLD] fp32 and sHb [R][HBLD] bf16:
// scratch tiles.  Every thread of the block calls it (it synchronises).
template <int D>
__device__ __forceinline__ void ffn_walk(const bf16* sR, float* sH, bf16* sHb,
                                         const bf16* __restrict__ w1,
                                         const bf16* __restrict__ b1,
                                         const bf16* __restrict__ w2, int F,
                                         acc_frag (&y)[D / 64]) {
  constexpr int RLD = D + 8;
  constexpr int NY = D / 64;
  const int warp = threadIdx.x / 32;
  const int rt = warp / 4;            // this warp's 16-row tile
  const int cq = warp % 4;            // this warp's quarter of the d columns
  const int ycol0 = cq * (D / 4);
#pragma unroll
  for (int j = 0; j < NY; ++j) wmma::fill_fragment(y[j], 0.0f);

  for (int c0 = 0; c0 < F; c0 += FC) {
    // FC1: this warp's 16x16 tile (rt, cq) of h = r . W1[:, c0:c0+64].
    acc_frag h;
    wmma::fill_fragment(h, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sR + rt * 16 * RLD + kk * 16, RLD);
      wmma::load_matrix_sync(b, w1 + (size_t)kk * 16 * F + c0 + cq * 16, F);
      wmma::mma_sync(h, a, b, h);
    }
    wmma::store_matrix_sync(sH + rt * 16 * HLD + cq * 16, h, HLD,
                            wmma::mem_row_major);
    __syncthreads();
    for (int e = threadIdx.x; e < R * FC; e += NT) {
      const int r = e / FC, c = e % FC;
      const float hv = __fadd_rn(sH[r * HLD + c], __bfloat162float(b1[c0 + c]));
      sHb[r * HBLD + c] = __float2bfloat16_rn(gelu_tanh(hv));
    }
    __syncthreads();
    // FC2: y[16 x D/4] += h[16 x 64] . W2[c0:c0+64, ycol0 : ycol0 + D/4].
#pragma unroll
    for (int kk = 0; kk < FC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sHb + rt * 16 * HBLD + kk * 16, HBLD);
#pragma unroll
      for (int j = 0; j < NY; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, w2 + (size_t)(c0 + kk * 16) * D + ycol0 + j * 16, D);
        wmma::mma_sync(y[j], a, b, y[j]);
      }
    }
  }
}

}  // namespace ffn
